"""Spectrum VAE of the port.

Batch contract: ``(flux [B, N] f32, wavelength [B, N] f32, phase [B] f32,
mask [B, N] bool)``, True = missing; N = 982 for Goldstein. Masked points
get likelihood scale 1 + 1e10·mask. Counterpart of
``vaesne_tpu/models/spectra.py`` (``SpectraVAE``; the Bright variant comes
later).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.spectra_layers import SpectraTransformerDecoder, SpectraTransformerEncoder
from .base_vae import BaseVAE, tile_leading

MASK_VARIANCE = 1e10


class SpectraVAE(BaseVAE):
    """Transformer VAE over masked spectra on a padded wavelength grid."""

    def __init__(self, latent_len: int = 4, latent_dim: int = 2, model_dim: int = 32,
                 num_heads: int = 4, ff_dim: int = 32, num_layers: int = 4,
                 dropout: float = 0.1, selfattn: bool = False, concat: bool = True,
                 beta: float = 1.0, llik_scaling: float = 1.0, scale_eps: float = 1e-6):
        super().__init__()
        self.latent_len = latent_len
        self.latent_dim = latent_dim
        self.beta = beta
        self.llik_scaling = llik_scaling
        self.scale_eps = scale_eps
        self.enc = SpectraTransformerEncoder(
            bottleneck_length=2 * latent_len, bottleneck_dim=latent_dim,
            model_dim=model_dim, num_heads=num_heads, num_layers=num_layers,
            ff_dim=ff_dim, dropout=dropout, selfattn=selfattn, concat=concat)
        self.dec = SpectraTransformerDecoder(
            bottleneck_dim=latent_dim, model_dim=model_dim, num_heads=num_heads,
            ff_dim=ff_dim, num_layers=num_layers, dropout=dropout)

    def _enc_params(self, x, seed: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        flux, wavelength, phase, mask = x
        # Deliberate swap, as in the JAX package and the original reference:
        # wavelength goes through the linear "flux" path and flux through
        # the sinusoidal "wavelength" path.
        bottleneck = self.enc(wavelength, flux, phase, mask, seed=seed)
        mu = bottleneck[:, : self.latent_len, :]
        scale = F.softplus(bottleneck[:, self.latent_len:, :]) + self.scale_eps
        return mu, scale

    def _dec_dist(self, z_flat, x, K: int, seed: Optional[int] = None):
        _, wavelength, phase, mask = x
        wl_t, phase_t, mask_t = (tile_leading(a, K) for a in (wavelength, phase, mask))
        loc = self.dec(wl_t, phase_t, z_flat, mask_t, seed=seed)
        return self._masked_likelihood(loc, mask_t, MASK_VARIANCE)
