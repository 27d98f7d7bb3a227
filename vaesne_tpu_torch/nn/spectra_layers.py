"""Perceiver-style transformer encoder and decoder for spectra.

A spectrum is flux on a padded wavelength grid (982 bins for Goldstein) plus
a scalar phase; the phase joins the attention context as one extra token
whose mask entry is forced to observed. Counterparts of
``vaesne_tpu/nn/spectra_layers.py``. The spectra VAE calls the encoder with
its first two arguments swapped on purpose (see ``models/spectra.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import MLP, SingleLayerMLP, SinusoidalEmbedding, SinusoidalMLPEmbedding, TransformerStack


class SpectraTransformerEncoder(nn.Module):
    """Bottleneck tokens cross-attend to [flux ⊕ λ-embedding tokens, phase
    token]. Returns [B, bottleneck_length, bottleneck_dim]."""

    def __init__(self, bottleneck_length: int, bottleneck_dim: int, model_dim: int = 32,
                 num_heads: int = 4, num_layers: int = 4, ff_dim: int = 32,
                 dropout: float = 0.1, selfattn: bool = False, concat: bool = True):
        super().__init__()
        self.concat = concat
        self.flux_embd = nn.Linear(1, model_dim)
        if concat:
            self.wavelength_embd = SinusoidalEmbedding(model_dim)
            self.spectrafc = MLP(2 * model_dim, model_dim, (model_dim,))
        else:
            self.wavelength_embd = SinusoidalMLPEmbedding(model_dim)
        self.phase_embd = SinusoidalMLPEmbedding(model_dim)
        self.initbottleneck = nn.Parameter(torch.randn(bottleneck_length, model_dim))
        self.blocks = TransformerStack(model_dim, num_heads, ff_dim, num_layers,
                                       dropout, selfattn)
        self.bottleneckfc = SingleLayerMLP(model_dim, bottleneck_dim)

    def forward(self, flux: torch.Tensor, wavelength: torch.Tensor, phase: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        flux_lin = self.flux_embd(flux[..., None])
        wl_embd = self.wavelength_embd(wavelength)
        if self.concat:
            tokens = self.spectrafc(torch.cat([flux_lin, wl_embd], dim=-1))
        else:
            tokens = flux_lin + wl_embd
        phase_embd = self.phase_embd(phase[..., None])
        context = torch.cat([tokens, phase_embd], dim=1)  # [B, N+1, E]
        if mask is not None:
            # the phase token is always observed
            mask = torch.cat([mask, mask.new_zeros((mask.shape[0], 1))], dim=1)
        x = self.initbottleneck[None].expand(flux.shape[0], -1, -1)
        h = self.blocks(x, context=context, mask=None, context_mask=mask)
        return self.bottleneckfc(x + h)


class SpectraTransformerDecoder(nn.Module):
    """Decode latent tokens into flux on a wavelength grid, conditioned on
    phase. Queries are the λ-embedding; the context is [projected latents,
    phase embedding]; the observation mask goes on the query
    self-attention. Returns [B, N]."""

    def __init__(self, bottleneck_dim: int, model_dim: int = 32, num_heads: int = 4,
                 ff_dim: int = 32, num_layers: int = 4, dropout: float = 0.1,
                 selfattn: bool = False):
        super().__init__()
        self.wavelength_embd_layer = SinusoidalMLPEmbedding(model_dim)
        self.phase_embd_layer = SinusoidalMLPEmbedding(model_dim)
        self.contextfc = MLP(bottleneck_dim, model_dim, (model_dim,))
        self.blocks = TransformerStack(model_dim, num_heads, ff_dim, num_layers,
                                       dropout, selfattn)
        self.get_flux = SingleLayerMLP(model_dim, 1)

    def forward(self, wavelength: torch.Tensor, phase: torch.Tensor,
                bottleneck: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.wavelength_embd_layer(wavelength)
        phase_embd = self.phase_embd_layer(phase[..., None])
        context = self.contextfc(bottleneck)
        context = torch.cat([context, phase_embd], dim=1)
        h = self.blocks(x, context=context, mask=mask, context_mask=None)
        return self.get_flux(x + h)[..., 0]
