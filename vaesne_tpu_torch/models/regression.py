"""Regression heads mapping light curves or spectra to physical parameters.

Counterparts of ``vaesne_tpu/models/regression.py``:

  * ``VAERegressionHead``          an MLP over a VAE's flattened posterior
                                   mean (the VAE is held whole, decoder
                                   included, as the JAX head's parameters
                                   hold the whole backbone)
  * ``ContraPhotoRegressionHead``  an MLP over the contrastive photometric
                                   tower's embedding
  * ``ContraSpecRegressionHead``   an MLP over the contrastive spectra
                                   tower's embedding
  * ``PhotoEnd2EndRegression``     a photometric encoder and the MLP,
                                   trained together from scratch
  * ``SpecEnd2EndRegression``      a spectra encoder and the MLP

The backbone's embedding is always computed with dropout off.
``freeze_backbone`` (the default) detaches it, the JAX package's
``stop_gradient``, so no backbone parameter takes a gradient; the regression
driver also leaves the backbone out of the optimizer (``train_loop``'s
``opt_mask``). The end-to-end heads train their encoder with dropout,
drawn from ``seed`` in train mode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.layers import MLP
from ..nn.photometric_layers import PhotometricTransformerEncoder
from ..nn.spectra_layers import SpectraTransformerEncoder
from .base_vae import BaseVAE
from .contrastive import ContraPhotSpec


class _FrozenEmbeddingHead(nn.Module):
    """An MLP ``outfc`` over the flattened embedding ``_embed(x)`` of a
    backbone, detached when ``freeze_backbone``."""

    def __init__(self, embed_dim: int, outdim: int, freeze_backbone: bool,
                 mlp_hidden: Sequence[int]):
        super().__init__()
        self.freeze_backbone = freeze_backbone
        self.outfc = MLP(embed_dim, outdim, tuple(mlp_hidden))

    def forward(self, x, seed: Optional[int] = None) -> torch.Tensor:
        del seed  # the backbone's embedding is always deterministic
        h = self._embed(x)
        if self.freeze_backbone:
            h = h.detach()
        return self.outfc(h.flatten(1))


class VAERegressionHead(_FrozenEmbeddingHead):
    """MLP over a (frozen) VAE's flattened posterior mean."""

    def __init__(self, vae: BaseVAE, outdim: int, freeze_backbone: bool = True,
                 mlp_hidden: Sequence[int] = (64, 64)):
        super().__init__(vae.latent_len * vae.latent_dim, outdim, freeze_backbone, mlp_hidden)
        self.vae = vae

    def _embed(self, x) -> torch.Tensor:
        return self.vae.encode(x, mean=True)


class ContraPhotoRegressionHead(_FrozenEmbeddingHead):
    """MLP over the (frozen) contrastive photometric tower's embedding."""

    def __init__(self, contrastnet: ContraPhotSpec, outdim: int, freeze_backbone: bool = True,
                 mlp_hidden: Sequence[int] = (64, 64)):
        super().__init__(contrastnet.latent_len * contrastnet.latent_dim, outdim,
                         freeze_backbone, mlp_hidden)
        self.contrastnet = contrastnet

    def _embed(self, x) -> torch.Tensor:
        return self.contrastnet.photo_enc(x)


class ContraSpecRegressionHead(ContraPhotoRegressionHead):
    """MLP over the (frozen) contrastive spectra tower's embedding."""

    def _embed(self, x) -> torch.Tensor:
        return self.contrastnet.spectra_enc(x)


class PhotoEnd2EndRegression(nn.Module):
    """Photometric encoder + MLP head trained end to end from scratch."""

    def __init__(self, outdim: int, num_bands: int = 6, latent_len: int = 4,
                 latent_dim: int = 4, model_dim: int = 32, num_heads: int = 4,
                 ff_dim: int = 32, num_layers: int = 4, dropout: float = 0.1,
                 selfattn: bool = False, mlp_hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.enc = PhotometricTransformerEncoder(
            num_bands=num_bands, bottleneck_length=latent_len, bottleneck_dim=latent_dim,
            model_dim=model_dim, num_heads=num_heads, ff_dim=ff_dim, num_layers=num_layers,
            dropout=dropout, selfattn=selfattn)
        self.outfc = MLP(latent_len * latent_dim, outdim, tuple(mlp_hidden))

    def forward(self, x, seed: Optional[int] = None) -> torch.Tensor:
        flux, time, band, mask = x
        h = self.enc(flux, time, band, mask, seed=seed)
        return self.outfc(h.flatten(1))


class SpecEnd2EndRegression(nn.Module):
    """Spectra encoder + MLP head trained end to end from scratch."""

    def __init__(self, outdim: int, latent_len: int = 4, latent_dim: int = 4,
                 model_dim: int = 32, num_heads: int = 4, num_layers: int = 4,
                 ff_dim: int = 32, dropout: float = 0.1, selfattn: bool = False,
                 mlp_hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.enc = SpectraTransformerEncoder(
            bottleneck_length=latent_len, bottleneck_dim=latent_dim, model_dim=model_dim,
            num_heads=num_heads, num_layers=num_layers, ff_dim=ff_dim, dropout=dropout,
            selfattn=selfattn)
        self.outfc = MLP(latent_len * latent_dim, outdim, tuple(mlp_hidden))

    def forward(self, x, seed: Optional[int] = None) -> torch.Tensor:
        flux, wavelength, phase, mask = x
        # the deliberate flux/wavelength swap of ContraPhotSpec._spectra
        h = self.enc(wavelength, flux, phase, mask, seed=seed)
        return self.outfc(h.flatten(1))
