"""Core neural building blocks of the port (torch.nn).

The same blocks as ``vaesne_tpu/nn/layers.py``, with submodules named after
the flax parameter tree so that ``utils.weights.load_jax_params`` maps one
onto the other mechanically:

  * ``SingleLayerMLP``, ``MLP``
  * ``SinusoidalEmbedding`` (dim/2 frequencies), ``SinusoidalMLPEmbedding``
    (dim frequencies, then an MLP head)
  * ``MultiHeadAttention``: torch ``nn.MultiheadAttention`` semantics, with
    key-padding masks (True = ignore) folded in as a −1e9 bias, not −inf, so
    a fully masked row averages uniformly instead of giving NaN. Large grids
    (``ops.dispatch.routes_to_kernel``) go to the fused CUDA kernel.
  * ``TransformerBlock`` (post-LN, LayerNorm eps 1e-5, exact erf GELU) and
    ``TransformerStack``.

Dropout follows the module's train/eval mode: ``model.eval()`` is the JAX
package's ``deterministic=True``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention_reference, fused_attention, routes_to_kernel

LN_EPS = 1e-5  # torch nn.LayerNorm default, as in the JAX package


class SingleLayerMLP(nn.Module):
    """fc(in→in) → ReLU → fc(in→out)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, in_dim)
        self.fc2 = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class MLP(nn.Module):
    """Dense+ReLU layers ``hidden_i`` and a linear head ``out``."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: Sequence[int] = (64, 64)):
        super().__init__()
        self.n_hidden = len(hidden_dim)
        for i, h in enumerate(hidden_dim):
            self.add_module(f"hidden_{i}", nn.Linear(in_dim, h))
            in_dim = h
        self.out = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = F.relu(getattr(self, f"hidden_{i}")(x))
        return self.out(x)


def _div_term(dim: int, step: int, device) -> torch.Tensor:
    """exp(arange(0, dim, step) · (−log(10000)/dim))."""
    return torch.exp(torch.arange(0, dim, step, dtype=torch.float32, device=device)
                     * (-math.log(10000.0) / dim))


class SinusoidalEmbedding(nn.Module):
    """cat[sin(x·ω), cos(x·ω)] of a real-valued coordinate, dim/2
    frequencies: [..., L] → [..., L, dim]."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ang = x[..., None] * _div_term(self.dim, 2, x.device)
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class SinusoidalMLPEmbedding(nn.Module):
    """Sinusoid with dim frequencies (2·dim features), then
    fc(2·dim→dim) → ReLU → fc(dim→dim)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.fc1 = nn.Linear(2 * dim, dim)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ang = x[..., None] * _div_term(self.dim, 1, x.device)
        enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.fc2(F.relu(self.fc1(enc)))


class MultiHeadAttention(nn.Module):
    """Multi-head attention over [B, L, E]: q/k/v/out projections E→E with
    bias, scaling 1/√head_dim, ``key_padding_mask`` bool [B, Lk] with
    True = ignore, dropout on the attention weights in train mode.

    Grids that ``routes_to_kernel`` picks go to ``ops.fused_attention`` (the
    CUDA kernel on a card, its plain version on the CPU); the rest take the
    plain einsum path. The kernel has no dropout yet: a routed grid with
    dropout active on a CUDA tensor raises."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed dim {embed_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dropout = dropout
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = self.q_proj(query)
        k = self.k_proj(key)
        v = self.v_proj(value)
        rate = self.dropout if self.training else 0.0
        lq, lk = q.shape[-2], k.shape[-2]
        routed = q.dim() == 3 and routes_to_kernel(q.shape[0], self.num_heads, lq, lk)
        if routed and rate == 0.0:
            if key_padding_mask is not None:
                key_padding_mask = key_padding_mask.contiguous()
            out = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  key_padding_mask, self.num_heads)
        elif routed and q.is_cuda:
            raise NotImplementedError(
                "attention dropout inside the fused kernel arrives with the "
                "training slice of the port; call model.eval() to serve")
        else:
            out = attention_reference(q, k, v, key_padding_mask, self.num_heads, rate)
        return self.out_proj(out)


class TransformerBlock(nn.Module):
    """Post-LN block with an optional cross-attention context:

      x   = LN1(x + drop(SelfAttn(x, key_padding_mask=mask)))
      ctx = LN_ctx(ctx + drop(CtxSelfAttn(ctx)))   # iff context_self_attn
      x   = LN2(x + drop(CrossAttn(x, ctx, key_padding_mask=context_mask)))
      x   = LN3(x + drop(FFN(x)))                   # Dense → GELU → Dense

    Every tower of the model calls its blocks with a context, so the
    cross-attention parameters always exist."""

    def __init__(self, embed_dim: int, num_heads: int, ff_dim: int,
                 dropout: float = 0.1, context_self_attn: bool = False):
        super().__init__()
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, dropout)
        self.layernorm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.context_self_attn = None
        if context_self_attn:
            self.context_self_attn = MultiHeadAttention(embed_dim, num_heads, dropout)
            self.layernorm_context = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.cross_attn = MultiHeadAttention(embed_dim, num_heads, dropout)
        self.layernorm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.ffn_0 = nn.Linear(embed_dim, ff_dim)
        self.ffn_2 = nn.Linear(ff_dim, embed_dim)
        self.layernorm3 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        attn = self.self_attn(x, x, x, key_padding_mask=mask)
        x = self.layernorm1(x + self.drop(attn))
        if context is not None:
            if self.context_self_attn is not None:
                ctx = self.context_self_attn(context, context, context,
                                             key_padding_mask=context_mask)
                context = self.layernorm_context(context + self.drop(ctx))
            cross = self.cross_attn(x, context, context, key_padding_mask=context_mask)
            x = self.layernorm2(x + self.drop(cross))
        h = self.ffn_2(F.gelu(self.ffn_0(x), approximate="none"))
        return self.layernorm3(x + self.drop(h))


class TransformerStack(nn.Module):
    """``num_layers`` TransformerBlocks ``block_i`` applied in turn."""

    def __init__(self, embed_dim: int, num_heads: int, ff_dim: int, num_layers: int,
                 dropout: float = 0.1, context_self_attn: bool = False):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                embed_dim, num_heads, ff_dim, dropout, context_self_attn))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, context, mask, context_mask)
        return x
