"""Perceiver-style transformer encoder and decoder for light curves.

A light curve is padded to a fixed length (60 for Goldstein/LSST): per point
``(flux, time, band, mask)`` with band an integer class and mask True at
padded or unobserved points. Counterparts of
``vaesne_tpu/nn/photometric_layers.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import MLP, SingleLayerMLP, SinusoidalEmbedding, SinusoidalMLPEmbedding, TransformerStack


class PhotometricTransformerEncoder(nn.Module):
    """Learned bottleneck tokens cross-attend to the per-point embeddings
    fluxfc(flux) ⊕ time sinusoid ⊕ band embedding (fused by concat + MLP
    when ``concat``, else summed). The mask goes on the context only.
    Returns [B, bottleneck_length, bottleneck_dim]."""

    def __init__(self, num_bands: int, bottleneck_length: int, bottleneck_dim: int,
                 model_dim: int = 32, num_heads: int = 4, ff_dim: int = 32,
                 num_layers: int = 4, dropout: float = 0.1, selfattn: bool = False,
                 concat: bool = True):
        super().__init__()
        self.concat = concat
        self.bandembd = nn.Embedding(num_bands, model_dim)
        self.fluxfc = nn.Linear(1, model_dim)
        if concat:
            self.time_embd = SinusoidalMLPEmbedding(model_dim)
            self.LCfc = MLP(3 * model_dim, model_dim, (model_dim,))
        else:
            self.time_embd = SinusoidalEmbedding(model_dim)
        self.initbottleneck = nn.Parameter(torch.randn(bottleneck_length, model_dim))
        self.blocks = TransformerStack(model_dim, num_heads, ff_dim, num_layers,
                                       dropout, selfattn)
        self.bottleneckfc = SingleLayerMLP(model_dim, bottleneck_dim)

    def forward(self, flux: torch.Tensor, time: torch.Tensor, band: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        band_embd = self.bandembd(band)
        flux_embd = self.fluxfc(flux[..., None])
        time_embd = self.time_embd(time)
        if self.concat:
            tokens = self.LCfc(torch.cat([flux_embd, time_embd, band_embd], dim=-1))
        else:
            tokens = flux_embd + time_embd + band_embd
        x = self.initbottleneck[None].expand(flux.shape[0], -1, -1)
        h = self.blocks(x, context=tokens, mask=None, context_mask=mask, seed=seed)
        return self.bottleneckfc(x + h)


class PhotometricTransformerDecoder(nn.Module):
    """Decode latent tokens into flux on a (time, band) query grid. Query
    tokens are time sinusoid + band embedding; they cross-attend to the
    projected latents. The observation mask goes on the query
    self-attention (``donotmask`` drops it). Returns [B, L]."""

    def __init__(self, bottleneck_dim: int, num_bands: int, model_dim: int = 32,
                 num_heads: int = 4, ff_dim: int = 32, num_layers: int = 4,
                 dropout: float = 0.1, donotmask: bool = False, selfattn: bool = False):
        super().__init__()
        self.donotmask = donotmask
        self.sinusoidal_time_embd = SinusoidalMLPEmbedding(model_dim)
        self.bandembd = nn.Embedding(num_bands, model_dim)
        self.contextfc = MLP(bottleneck_dim, model_dim, (model_dim,))
        self.blocks = TransformerStack(model_dim, num_heads, ff_dim, num_layers,
                                       dropout, selfattn)
        self.get_photo = SingleLayerMLP(model_dim, 1)

    def forward(self, time: torch.Tensor, band: torch.Tensor, bottleneck: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        if self.donotmask:
            mask = None
        x = self.sinusoidal_time_embd(time) + self.bandembd(band)
        context = self.contextfc(bottleneck)
        h = self.blocks(x, context=context, mask=mask, context_mask=None, seed=seed)
        return self.get_photo(x + h)[..., 0]
