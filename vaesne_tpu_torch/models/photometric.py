"""Light-curve (photometry) VAE of the port.

Batch contract: ``(flux [B, L] f32, time [B, L] f32, band [B, L] int,
mask [B, L] bool)``, True = missing. Masked points enter the likelihood with
scale 1 + 1e8·mask. Counterpart of ``vaesne_tpu/models/photometric.py``
(``PhotometricVAE`` and ``BrightPhotometricVAE``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.layers import MLP
from ..nn.photometric_layers import PhotometricTransformerDecoder, PhotometricTransformerEncoder
from .base_vae import BaseVAE, tile_leading

MASK_VARIANCE = 1e8


class PhotometricVAE(BaseVAE):
    """Transformer VAE over masked, irregularly sampled light curves."""

    modality_name = "light_curve"

    def __init__(self, num_bands: int = 6, latent_len: int = 8, latent_dim: int = 4,
                 model_dim: int = 64, num_heads: int = 4, ff_dim: int = 64,
                 num_layers: int = 4, dropout: float = 0.1, selfattn: bool = False,
                 concat: bool = True, beta: float = 1.0, llik_scaling: float = 1.0,
                 scale_eps: float = 1e-6):
        super().__init__()
        self.num_bands = num_bands
        self.latent_len = latent_len
        self.latent_dim = latent_dim
        self.model_dim = model_dim
        self.beta = beta
        self.llik_scaling = llik_scaling
        self.scale_eps = scale_eps
        # the encoder emits 2·latent_len tokens: mu, then softplus scale
        self.enc = PhotometricTransformerEncoder(
            num_bands=num_bands, bottleneck_length=2 * latent_len,
            bottleneck_dim=latent_dim, model_dim=model_dim, num_heads=num_heads,
            ff_dim=ff_dim, num_layers=num_layers, dropout=dropout,
            selfattn=selfattn, concat=concat)
        self.dec = PhotometricTransformerDecoder(
            bottleneck_dim=latent_dim, num_bands=num_bands, model_dim=model_dim,
            num_heads=num_heads, ff_dim=ff_dim, num_layers=num_layers,
            dropout=dropout)

    def _enc_params(self, x, seed: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        flux, time, band, mask = x
        bottleneck = self.enc(flux, time, band, mask, seed=seed)
        mu = bottleneck[:, : self.latent_len, :]
        # scale_eps floors the posterior scale, which softplus can underflow
        scale = F.softplus(bottleneck[:, self.latent_len:, :]) + self.scale_eps
        return mu, scale

    def _dec_dist(self, z_flat, x, K: int, seed: Optional[int] = None):
        _, time, band, mask = x
        time_t, band_t, mask_t = (tile_leading(a, K) for a in (time, band, mask))
        loc = self.dec(time_t, band_t, z_flat, mask_t, seed=seed)
        return self._masked_likelihood(loc, mask_t, MASK_VARIANCE)


class BrightPhotometricVAE(PhotometricVAE):
    """PhotometricVAE whose decoded mean is recentred to a brightness read
    from latent token 0: loc ← loc + brightnessfc(z₀) − mean over the grid
    of loc."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.latent_len <= 1:
            raise ValueError("first latent token is reserved for overall brightness")
        self.brightnessfc = MLP(self.latent_dim, 1, (self.model_dim,))

    def _dec_dist(self, z_flat, x, K: int, seed: Optional[int] = None):
        _, time, band, mask = x
        time_t, band_t, mask_t = (tile_leading(a, K) for a in (time, band, mask))
        brightness = self.brightnessfc(z_flat[:, 0, :])  # [K·B, 1]
        loc = self.dec(time_t, band_t, z_flat, mask_t, seed=seed)
        loc = loc + brightness - loc.mean(dim=-1, keepdim=True)
        return self._masked_likelihood(loc, mask_t, MASK_VARIANCE)
