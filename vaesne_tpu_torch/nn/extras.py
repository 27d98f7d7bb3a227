"""Auxiliary building blocks completing the reference's API surface.

The counterparts of ``vaesne_tpu/nn/extras.py``: utilities of the
reference's ``util_layers.py`` that no model or script of the package
runs, kept so that a reference user finds every name. Submodules are named
after the flax parameter tree, so ``utils.weights.load_jax_params`` bridges
them mechanically.

  * ``LearnableFourierEncoding``: ``fc2(relu(fc1([sin(freq·x), cos(freq·x)])))``
    with ``freq`` a linear map without bias (the reference's body applies
    ``nn.ReLU`` as a constructor; this is the intended function, as in the
    JAX package)
  * ``RelativePosition``: the clipped-distance embedding table of Shaw et al.
  * ``RelativeMultiHeadAttention``: relative positions on keys and values
  * ``GumbelSoftmax``: linear logits and a Gumbel-Softmax sample, optionally
    a straight-through one-hot
  * ``flatten`` / ``reshape``: the reference's ``Flatten`` and ``Reshape``
  * ``TransformerModel``: ``num_layers`` blocks, a thin wrapper of
    ``TransformerStack``, whose attentions dispatch to the fused kernels as
    every other stack's do

Dropout follows the module's train/eval mode (``model.eval()`` is the JAX
package's ``deterministic=True``) and draws from an integer ``seed``, never
from torch's global generator.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import TransformerStack, _need_seed, dropout

__all__ = [
    "LearnableFourierEncoding",
    "RelativePosition",
    "RelativeMultiHeadAttention",
    "GumbelSoftmax",
    "flatten",
    "reshape",
    "TransformerModel",
]


class LearnableFourierEncoding(nn.Module):
    """[..., L] real coordinates → [..., L, dim]: learned frequencies
    ``freq`` (no bias), [sin, cos] of the angles, then fc1 → ReLU → fc2."""

    def __init__(self, dim: int = 64):
        super().__init__()
        self.freq = nn.Linear(1, dim, bias=False)
        self.fc1 = nn.Linear(2 * dim, dim)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ang = self.freq(x[..., None])
        enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.fc2(F.relu(self.fc1(enc)))


class RelativePosition(nn.Module):
    """Clipped-distance relative positional embeddings:
    ``(length_q, length_k) → [Lq, Lk, num_units]``, entry (i, j) being
    ``embeddings_table[clip(j − i, ±max) + max]``. The index of each
    (Lq, Lk) is built once, on the table's device."""

    def __init__(self, num_units: int, max_relative_position: int):
        super().__init__()
        self.max_relative_position = max_relative_position
        self.embeddings_table = nn.Parameter(
            torch.empty(2 * max_relative_position + 1, num_units))
        nn.init.xavier_uniform_(self.embeddings_table)
        self._index: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def index(self, length_q: int, length_k: int) -> torch.Tensor:
        """The table rows [Lq, Lk] (int64) of every (query, key) pair."""
        device = self.embeddings_table.device
        key = (length_q, length_k, device)
        if key not in self._index:
            m = self.max_relative_position
            dist = (torch.arange(length_k, device=device)[None, :]
                    - torch.arange(length_q, device=device)[:, None])
            self._index[key] = dist.clamp(-m, m) + m
        return self._index[key]

    def forward(self, length_q: int, length_k: int) -> torch.Tensor:
        return self.embeddings_table[self.index(length_q, length_k)]


class RelativeMultiHeadAttention(nn.Module):
    """Multi-head attention with relative positions on keys and values:
    ``logits = (QKᵀ + Q·R_kᵀ)/√hd``, ``out = A·V + A·R_v``, then ``fc_o``.

    ``mask`` follows the reference's convention, the reverse of the
    key-padding masks elsewhere in the port: 0/False is masked, and a
    masked logit becomes −1e10 in the logits' dtype; it broadcasts to
    [B, H, Lq, Lk]. In train mode with ``dropout`` > 0 the weights are
    dropped with a mask drawn from ``seed``.

    Plain torch (einsums over the [Lq, Lk, hd] tables), as the JAX version
    is plain jnp: the relative-key term enters the logits, and the fused
    attention kernel takes only a key-padding bias, so it cannot serve
    this module."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 max_relative_position: int = 2):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(f"embed dim {embed_dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dropout = dropout
        hd = embed_dim // num_heads
        self.fc_q = nn.Linear(embed_dim, embed_dim)
        self.fc_k = nn.Linear(embed_dim, embed_dim)
        self.fc_v = nn.Linear(embed_dim, embed_dim)
        self.fc_o = nn.Linear(embed_dim, embed_dim)
        self.relative_position_k = RelativePosition(hd, max_relative_position)
        self.relative_position_v = RelativePosition(hd, max_relative_position)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        e = query.shape[-1]
        hd = e // self.num_heads
        lq, lk = query.shape[-2], key.shape[-2]

        def split(x):  # [B, L, E] → [B, L, H, hd]
            return x.reshape(*x.shape[:-1], self.num_heads, hd)

        qh, kh, vh = split(self.fc_q(query)), split(self.fc_k(key)), split(self.fc_v(value))
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
        logits = logits + torch.einsum("bqhd,qkd->bhqk", qh, self.relative_position_k(lq, lk))
        logits = logits / math.sqrt(hd)
        if mask is not None:
            logits = logits.masked_fill(mask == 0, -1e10)
        weights = torch.softmax(logits, dim=-1)
        rate = self.dropout if self.training else 0.0
        if rate > 0.0:
            weights = dropout(weights, rate, _need_seed(seed, "relative attention dropout"))
        out = torch.einsum("bhqk,bkhd->bqhd", weights, vh)
        out = out + torch.einsum("bhqk,qkd->bqhd", weights, self.relative_position_v(lq, lk))
        return self.fc_o(out.reshape(*out.shape[:-2], e))


class GumbelSoftmax(nn.Module):
    """Linear logits and a Gumbel-Softmax sample, optionally discretized
    straight through: ``(logits [-1, c_dim], probs, sample)``, as the
    reference returns them.

    The uniform draw is fp32 from ``generator`` (on the logits' device), or
    ``u`` itself when given; the Gumbel noise is
    ``−log(−log(u + eps) + eps)``. ``hard`` gives the one-hot of the
    sample's argmax with the soft sample's gradient,
    ``(one_hot − y).detach() + y``."""

    def __init__(self, in_dim: int, c_dim: int, eps: float = 1e-20):
        super().__init__()
        self.c_dim = c_dim
        self.eps = eps
        self.logits = nn.Linear(in_dim, c_dim)

    def forward(self, x: torch.Tensor, temperature: float = 1.0, hard: bool = False,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        logits = self.logits(x).reshape(-1, self.c_dim)
        probs = torch.softmax(logits, dim=-1)
        if u is None:
            if generator is None:
                raise ValueError("GumbelSoftmax needs a generator (or u) to sample")
            u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                           device=logits.device)
        gumbel = -torch.log(-torch.log(u + self.eps) + self.eps)
        y = torch.softmax((logits + gumbel) / temperature, dim=-1)
        if hard:
            one_hot = F.one_hot(y.argmax(-1), self.c_dim).to(y.dtype)
            y = (one_hot - y).detach() + y
        return logits, probs, y


def flatten(x: torch.Tensor) -> torch.Tensor:
    """[B, ...] → [B, prod(...)]."""
    return x.reshape(x.shape[0], -1)


def reshape(x: torch.Tensor, outer_shape: Sequence[int]) -> torch.Tensor:
    """[B, N] → [B, *outer_shape]."""
    return x.reshape(x.shape[0], *outer_shape)


class TransformerModel(nn.Module):
    """``num_layers`` TransformerBlocks over (x, context), as the submodule
    ``layers``; ``selfattn`` switches on the blocks' context self-attention.
    Masks are key-padding masks (True = ignore); grids that
    ``ops.routes_to_kernel`` picks run on the fused attention kernels."""

    def __init__(self, embed_dim: int, num_heads: int, ff_dim: int, num_layers: int,
                 dropout: float = 0.1, selfattn: bool = True):
        super().__init__()
        self.layers = TransformerStack(embed_dim, num_heads, ff_dim, num_layers, dropout,
                                       context_self_attn=selfattn)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        return self.layers(x, context, mask, context_mask, seed)
