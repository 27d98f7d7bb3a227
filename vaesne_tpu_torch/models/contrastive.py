"""CLIP-style contrastive two-tower network for photometry ↔ spectra.

The counterpart of ``vaesne_tpu/models/contrastive.py``: a photometric
encoder and a spectra encoder (the perceiver towers the VAEs use, with
``bottleneck_length = latent_len``: no mu/scale split), each followed by a
single-hidden-layer projection head latent_len·latent_dim → proj_dim.
``forward`` returns both projections; the InfoNCE objective is
``objectives.neg_info_nce``. ``photo_enc`` and ``spectra_enc`` give the
towers' embeddings, always deterministic, for the regression heads.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import SingleLayerMLP
from ..nn.photometric_layers import PhotometricTransformerEncoder
from ..nn.spectra_layers import SpectraTransformerEncoder
from ..utils.rng import maybe_fold_in
from .base_vae import eval_mode


class ContraPhotSpec(nn.Module):
    """Two towers and their projection heads. In train mode the photometry
    tower's dropout draws from ``fold_in(seed, 0)``, the spectra tower's
    from ``fold_in(seed, 1)``."""

    def __init__(self, latent_len: int = 4, latent_dim: int = 4, proj_dim: int = 8,
                 num_bands: int = 6, photo_model_dim: int = 32, photo_num_heads: int = 4,
                 photo_ff_dim: int = 32, photo_num_layers: int = 4, photo_dropout: float = 0.1,
                 spec_model_dim: int = 32, spec_num_heads: int = 4, spec_num_layers: int = 4,
                 spec_ff_dim: int = 32, spec_dropout: float = 0.1, selfattn: bool = False):
        super().__init__()
        self.latent_len = latent_len
        self.latent_dim = latent_dim
        self.photometry_encoder = PhotometricTransformerEncoder(
            num_bands=num_bands, bottleneck_length=latent_len, bottleneck_dim=latent_dim,
            model_dim=photo_model_dim, num_heads=photo_num_heads, ff_dim=photo_ff_dim,
            num_layers=photo_num_layers, dropout=photo_dropout, selfattn=selfattn)
        self.photo_proj = SingleLayerMLP(latent_len * latent_dim, proj_dim)
        self.spectra_encoder = SpectraTransformerEncoder(
            bottleneck_length=latent_len, bottleneck_dim=latent_dim, model_dim=spec_model_dim,
            num_heads=spec_num_heads, num_layers=spec_num_layers, ff_dim=spec_ff_dim,
            dropout=spec_dropout, selfattn=selfattn)
        self.spectra_proj = SingleLayerMLP(latent_len * latent_dim, proj_dim)

    def _photo(self, x, seed: Optional[int] = None) -> torch.Tensor:
        flux, time, band, mask = x
        return self.photometry_encoder(flux, time, band, mask, seed=seed)

    def _spectra(self, x, seed: Optional[int] = None) -> torch.Tensor:
        flux, wavelength, phase, mask = x
        # Deliberate swap, as in the JAX package and the original reference
        # (models/spectra.py): wavelength goes through the encoder's linear
        # "flux" path and flux through its sinusoidal "wavelength" path.
        return self.spectra_encoder(wavelength, flux, phase, mask, seed=seed)

    def forward(self, x, seed: Optional[int] = None):
        """x = (photometry tuple, spectra tuple) → (z1 [B, proj], z2 [B, proj])."""
        z1 = self._photo(x[0], maybe_fold_in(seed, 0))
        z2 = self._spectra(x[1], maybe_fold_in(seed, 1))
        return self.photo_proj(z1.flatten(1)), self.spectra_proj(z2.flatten(1))

    def photo_enc(self, x) -> torch.Tensor:
        """The photometric tower's embedding [B, latent_len, latent_dim],
        dropout off."""
        with eval_mode(self.photometry_encoder):
            return self._photo(x)

    def spectra_enc(self, x) -> torch.Tensor:
        """The spectra tower's embedding [B, latent_len, latent_dim], dropout
        off."""
        with eval_mode(self.spectra_encoder):
            return self._spectra(x)
