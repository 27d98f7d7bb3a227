"""Operations and bytes of the contrastive two-tower network's training
step, from its configuration alone: the model FLOPs and the attention grids
that go to K1 and K2.

The conventions are the package's (``counts/__init__.py``): model FLOPs
count the products of every linear layer and attention (QKᵀ and PV), the
forward once, a backward twice the forward, remat's re-run not at all.
InfoNCE's head adds the product z1·z2ᵀ of the batch's projections.
"""

from __future__ import annotations

from typing import List, NamedTuple

from . import Grid, _block, _linear, routes_to_kernel


class ContrastiveShape(NamedTuple):
    """The sizes the counts need: widths, the latent tokens, the
    projections, the light curve's points, the spectrum's bins, and whether
    the blocks hold the context self-attention."""

    E: int
    F: int
    H: int
    layers: int
    L: int
    D: int
    P: int
    n_photo: int
    n_spec: int
    selfattn: bool


def shape_of(config: dict) -> ContrastiveShape:
    m = config["model"]
    return ContrastiveShape(m["model_dim"], m["ff_dim"], m["num_heads"], m["num_layers"],
                            m["latent_len"], m["latent_dim"], config["proj_dim"],
                            config["photometry_points"], config["spectrum_bins"], m["selfattn"])


def context_length(s: ContrastiveShape, tower: str) -> int:
    """The tower's context: the light curve's points, or the spectrum's bins
    and the phase token."""
    return {"photo": s.n_photo, "spec": s.n_spec + 1}[tower]


def tower_grids(s: ContrastiveShape, tower: str, rows: int) -> List[Grid]:
    """Every attention of one pass of a tower over ``rows`` events, block by
    block: the L bottleneck tokens' self-attention, the context's
    self-attention (key-padded, where ``selfattn``), the bottleneck over the
    key-padded context."""
    n, L = context_length(s, tower), s.L
    out = []
    for _ in range(s.layers):
        out.append(Grid(rows, L, L, False))
        if s.selfattn:
            out.append(Grid(rows, n, n, True))
        out.append(Grid(rows, L, n, True))
    return out


def kernel_grids(s: ContrastiveShape, tower: str, rows: int) -> List[Grid]:
    """The tower's grids that go to K1 (and K2 in a backward)."""
    return [g for g in tower_grids(s, tower, rows) if routes_to_kernel(g.rows, s.H, g.lq, g.lk)]


def context_attentions(s: ContrastiveShape, rows: int) -> List[Grid]:
    """The context self-attentions of one pass of both towers, a block each
    where ``selfattn`` (each adds one to the port's ``ctx attn`` counter)."""
    if not s.selfattn:
        return []
    return [Grid(rows, n, n, True) for n in (s.n_photo, s.n_spec + 1) for _ in range(s.layers)]


def block_flops(s: ContrastiveShape, n: int) -> int:
    """Forward FLOPs of one block over one event with a context of ``n``
    tokens: the bottleneck's block (``_block``) and, where ``selfattn``,
    the context's self-attention (q, k, v and out over n tokens; QKᵀ, PV)."""
    ctx = 4 * _linear(s.E, s.E, n) + 4 * n * n * s.E if s.selfattn else 0
    return _block(s, s.L, n) + ctx


def tower_flops(s: ContrastiveShape, tower: str) -> int:
    """Forward FLOPs of one event through a tower and its projection head."""
    E, L, D = s.E, s.L, s.D
    sin_mlp = _linear(2 * E, E, 1) + _linear(E, E, 1)  # per token
    if tower == "photo":
        n = s.n_photo
        pre = _linear(1, E, n) + sin_mlp * n + _linear(3 * E, E, n) + _linear(E, E, n)
    else:
        n = s.n_spec
        pre = _linear(1, E, n) + _linear(2 * E, E, n) + _linear(E, E, n) + sin_mlp
    blocks = s.layers * block_flops(s, context_length(s, tower))
    head = _linear(E, E, L) + _linear(E, D, L) + _linear(L * D, L * D, 1) + _linear(L * D, s.P, 1)
    return pre + blocks + head


def info_nce_flops(s: ContrastiveShape, batch: int) -> int:
    """Forward FLOPs of InfoNCE's logits z1·z2ᵀ over a batch."""
    return 2 * batch * batch * s.P


def train_step_flops(s: ContrastiveShape, batch: int) -> int:
    """Model FLOPs of one training step: the forward of both towers over the
    batch and the head, and twice it for the backward."""
    return 3 * (batch * (tower_flops(s, "photo") + tower_flops(s, "spec"))
                + info_nce_flops(s, batch))
