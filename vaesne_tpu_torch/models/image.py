"""Host-galaxy image VAE of the port (ViT-style).

The counterpart of ``vaesne_tpu/models/image.py::HostImgVAE``, with the
per-pixel decoder or the hybrid patch-token + CNN-refinement decoder
(``hybrid=``). Batch contract: ``x = (image [B, C, H, W], event_loc)``,
event_loc a [B, 2] coordinate read only under ``focal_loc``; an empty
second element (``data.images.image_tuple`` gives [B, 0]) means no
conditioning. The likelihood is a plain ``Laplace(loc, 1)`` over every
pixel: images have no mask, so the masked-Laplace kernels are not on this
path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn.image_layers import (
    HostImgTransformerDecoder,
    HostImgTransformerDecoderHybrid,
    HostImgTransformerEncoder,
)
from .base_vae import BaseVAE


class HostImgVAE(BaseVAE):
    """Transformer VAE over host-galaxy images."""

    modality_name = "HostImage"

    def __init__(self, img_size: int = 60, latent_len: int = 4, latent_dim: int = 4,
                 patch_size: int = 4, in_channels: int = 3, focal_loc: bool = False,
                 model_dim: int = 32, num_heads: int = 4, ff_dim: int = 32,
                 num_layers: int = 4, dropout: float = 0.1, selfattn: bool = False,
                 hybrid: bool = True, beta: float = 1.0, llik_scaling: float = 1.0,
                 scale_eps: float = 1e-6):
        super().__init__()
        self.latent_len = latent_len
        self.latent_dim = latent_dim
        self.focal_loc = focal_loc
        self.beta = beta
        self.llik_scaling = llik_scaling
        self.scale_eps = scale_eps
        tower = dict(model_dim=model_dim, num_heads=num_heads, ff_dim=ff_dim,
                     num_layers=num_layers, dropout=dropout, selfattn=selfattn)
        # the encoder emits 2·latent_len tokens: mu, then softplus scale
        self.enc = HostImgTransformerEncoder(
            img_size=img_size, bottleneck_length=2 * latent_len, bottleneck_dim=latent_dim,
            patch_size=patch_size, in_channels=in_channels, focal_loc=focal_loc, **tower)
        if hybrid:
            self.dec = HostImgTransformerDecoderHybrid(
                img_size=img_size, bottleneck_dim=latent_dim, patch_size=patch_size,
                in_channels=in_channels, **tower)
        else:
            self.dec = HostImgTransformerDecoder(
                img_size=img_size, bottleneck_dim=latent_dim, in_channels=in_channels, **tower)

    def _split_x(self, x) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(image, event_loc), event_loc None unless ``focal_loc`` and a
        non-empty one is given. A non-empty event_loc that is not [B, 2] is
        a caller's error, not a request to drop the conditioning."""
        image = x[0]
        event_loc = x[1] if (self.focal_loc and len(x) > 1) else None
        if event_loc is not None and event_loc.numel() == 0:
            event_loc = None
        if event_loc is not None and (event_loc.dim() != 2 or event_loc.shape[-1] != 2):
            raise ValueError(
                f"focal_loc=True expects event_loc of shape [B, 2] (sky coordinates per "
                f"event), got {tuple(event_loc.shape)}; pass an empty tensor to disable "
                "conditioning")
        return image, event_loc

    def _enc_params(self, x, seed: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        image, event_loc = self._split_x(x)
        bottleneck = self.enc(image, event_loc, seed=seed)
        mu = bottleneck[:, : self.latent_len, :]
        # scale_eps floors the posterior scale, which softplus can underflow
        scale = F.softplus(bottleneck[:, self.latent_len:, :]) + self.scale_eps
        return mu, scale

    def _dec_dist(self, z_flat, x, K: int, seed: Optional[int] = None):
        loc = self.dec(z_flat, seed=seed)  # [K·B, C, H, W]; unconditional on x
        return self.likelihood(loc, torch.ones_like(loc))
