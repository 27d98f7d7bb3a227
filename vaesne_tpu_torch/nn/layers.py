"""Core neural building blocks of the port (torch.nn).

The same blocks as ``vaesne_tpu/nn/layers.py``, with submodules named after
the flax parameter tree so that ``utils.weights.load_jax_params`` maps one
onto the other mechanically:

  * ``SingleLayerMLP``, ``MLP``
  * ``SinusoidalEmbedding`` (dim/2 frequencies), ``SinusoidalMLPEmbedding``
    (dim frequencies, then an MLP head)
  * ``sinusoidal_embedding_2d`` (a fixed sin-cos grid) and ``PatchEmbedding``
    (a Conv2d patchifier over NCHW images), for the image towers
  * ``MultiHeadAttention``: torch ``nn.MultiheadAttention`` semantics, with
    key-padding masks (True = ignore) folded in as a −1e9 bias, not −inf, so
    a fully masked row averages uniformly instead of giving NaN. Large grids
    (``ops.dispatch.routes_to_kernel``) go to the fused CUDA kernel.
  * ``LayerNorm``: ``nn.LayerNorm`` computed by ``ops.layer_norm`` (the
    port's CUDA kernels on the card, ``F.layer_norm`` on the CPU)
  * ``TransformerBlock`` (post-LN, LayerNorm eps 1e-5, exact erf GELU) and
    ``TransformerStack`` (each block rematerialised in the backward, as in
    the JAX package, unless ``VAESNE_REMAT=0``).
  * ``compute_dtype``, ``resolve_precision`` and ``autocast``: the JAX
    package's ``VAESNE_BF16`` switch, which the train step, the server and
    the evaluation harness read.

Dropout follows the module's train/eval mode: ``model.eval()`` is the JAX
package's ``deterministic=True``. In train mode every dropout site draws
from an integer ``seed`` passed to ``forward`` (``utils.rng.fold_in`` of the
caller's seed and the site's index), never from torch's global generator, so
a block re-run by ``torch.utils.checkpoint`` draws the same masks again.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import (attend, attention_weights, counters, dropout_bits, fused_attention,
                   partition, pin_dropout_bits, routes_to_kernel)
from ..ops.layer_norm import layer_norm
from ..utils.rng import device_generator, maybe_fold_in

LN_EPS = 1e-5  # torch nn.LayerNorm default, as in the JAX package
PRECISIONS = ("fp32", "bf16")


def compute_dtype() -> Optional[torch.dtype]:
    """``torch.bfloat16`` where ``VAESNE_BF16`` asks for bf16 compute, else
    None (fp32). The JAX package's parse (``vaesne_tpu/nn/layers.py``):
    anything but ``0``, ``false`` or ``False`` is on. The parameters stay
    fp32 either way; the port computes in bf16 under autocast."""
    return (torch.bfloat16
            if os.environ.get("VAESNE_BF16", "0") not in ("0", "false", "False") else None)


def resolve_precision(precision: Optional[str]) -> str:
    """``precision`` checked, or where None what ``VAESNE_BF16`` says now
    (``compute_dtype``): ``"fp32"`` or ``"bf16"``."""
    if precision is None:
        precision = "bf16" if compute_dtype() is not None else "fp32"
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be None, 'fp32' or 'bf16', got {precision!r}")
    return precision


def autocast(precision: str, device=None):
    """bf16 autocast over fp32 weights where ``precision`` is ``"bf16"``
    (nothing for ``"fp32"``), on ``device``'s type, or on the CPU and, where
    one is present, the card when ``device`` is None."""
    if precision != "bf16":
        return contextlib.nullcontext()
    if device is not None:
        return torch.autocast(torch.device(device).type, dtype=torch.bfloat16)
    stack = contextlib.ExitStack()
    for kind in ("cpu", "cuda") if torch.cuda.is_available() else ("cpu",):
        stack.enter_context(torch.autocast(kind, dtype=torch.bfloat16))
    return stack


@contextlib.contextmanager
def no_autocast_cache():
    """Autocast casts a weight anew at each use inside the block, as a CUDA
    graph's capture requires (cached casts would outlive the capture); the
    values are the same. An ``autocast`` entered inside the block takes the
    setting, and remat's re-run takes its forward's."""
    before = torch.is_autocast_cache_enabled()
    torch.set_autocast_cache_enabled(False)
    try:
        yield
    finally:
        torch.set_autocast_cache_enabled(before)


def remat_default() -> bool:
    """``TransformerStack``'s remat where none is given: the JAX package's
    parse of ``VAESNE_REMAT`` (``os.environ.get("VAESNE_REMAT", "1") !=
    "0"``: only ``0`` turns it off, so ``false`` leaves it on)."""
    return os.environ.get("VAESNE_REMAT", "1") != "0"


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


class _Embed(torch.autograd.Function):
    """Row lookup whose weight gradient is a one-hot matrix product. On the
    card ``nn.Embedding``'s backward adds the rows of more than 3072 indices
    in an order that varies from run to run, so two runs of one training
    step would differ in the last bits; the product adds them in a fixed
    order."""

    @staticmethod
    def forward(ctx, weight: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.rows = weight.shape[0]
        return F.embedding(idx, weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        onehot = F.one_hot(idx.reshape(-1), ctx.rows).to(grad.dtype)
        return onehot.t() @ grad.reshape(-1, grad.shape[-1]), None


def embed(table: nn.Embedding, idx: torch.Tensor) -> torch.Tensor:
    """``table(idx)``, with a gradient that is the same bits in every run."""
    return _Embed.apply(table.weight, idx)


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


def sinusoidal_embedding_2d(d_model: int, height: int, width: int,
                            device=None) -> torch.Tensor:
    """Fixed 2-D sin-cos grid embedding [H·W, d_model], rows in row-major
    (h, w) order: pos_x + pos_y, each cat[sin(c·ω), cos(c·ω)] with
    ω_i = 10000^(−i/(d/2)), i < d/2."""
    if d_model % 4 != 0:
        raise ValueError("d_model must be divisible by 4 for 2D sinusoidal embeddings.")
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                            torch.arange(width, dtype=torch.float32, device=device),
                            indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    half = d_model // 2
    omega = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32, device=device) / half))
    out_x, out_y = xs[:, None] * omega[None, :], ys[:, None] * omega[None, :]
    return (torch.cat([torch.sin(out_x), torch.cos(out_x)], dim=-1)
            + torch.cat([torch.sin(out_y), torch.cos(out_y)], dim=-1))


def cudnn_fp32_deterministic():
    """cuDNN flags for the port's convolutions: fp32 (cuDNN's default is
    TF32) and deterministic algorithms, whose weight gradient sums in a
    fixed order where the default ones may add with atomics (two card runs
    of one seed then differ). A convolution's backward reads the flags when
    it runs, so the train step (``training.make_train_step``) holds them
    too."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` over NCHW ``x`` under ``cudnn_fp32_deterministic``; one
    launch on the ``conv`` counter (``ops.counters``)."""
    counters.conv_launches += 1
    with cudnn_fp32_deterministic():
        return conv(x)


class PatchEmbedding(nn.Module):
    """Non-overlapping conv patchifier: NCHW [B, C, H, W] → tokens
    [B, (H/p)·(W/p), embed_dim], row-major over the patch grid (the order
    of the JAX layer's NHWC reshape)."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.proj).flatten(2).transpose(1, 2)


def _need_seed(seed: Optional[int], what: str) -> int:
    if seed is None:
        raise ValueError(f"{what} in train mode with dropout > 0 needs a seed")
    return seed


def dropout(x: torch.Tensor, rate: float, seed: Optional[int],
            head_axis: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout of ``x`` with a mask drawn from a generator seeded
    with ``seed`` on x's device (rate 0: ``x`` itself). On a shard of a
    mesh the mask is this rank's part of the whole step's
    (``partition.global_draw``; ``head_axis``: where x holds this rank's
    heads)."""
    if rate == 0.0:
        return x
    g = device_generator(_need_seed(seed, "dropout"), x.device)
    keep = partition.global_draw(
        lambda shape: torch.rand(shape, generator=g, device=x.device), tuple(x.shape),
        head_axis) >= rate
    return x * keep.to(x.dtype) * (1.0 / (1.0 - rate))


class MultiHeadAttention(nn.Module):
    """Multi-head attention over [B, L, E]: q/k/v/out projections E→E with
    bias, scaling 1/√head_dim, ``key_padding_mask`` bool [B, Lk] with
    True = ignore, dropout on the attention weights in train mode, drawn
    from ``seed``.

    Grids that ``routes_to_kernel`` picks go to ``ops.fused_attention`` (the
    CUDA kernels on a card, their plain versions on the CPU), whose dropout
    mask is the kernels' hash (``ops.attention.dropout_keep``). The rest take
    the plain einsum path and drop the softmax weights with ``dropout``, as
    the JAX layer's plain path draws a bernoulli mask: a few elementwise
    passes where the hash would take ~20 int64 passes over the weights.

    On an event shard (``ops.partition``) the dispatch rule is asked with
    the global rows and heads, and the kernel's seed is the shard's
    (``shard_seed``). ``tp_size`` > 1 (set by ``parallel.shard_params_tp``)
    means the projections hold this rank's heads: q/k/v their output
    columns, ``out_proj`` its input columns, whose partial products are
    summed over the model group before the bias."""

    tp_size = 1

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
                key_padding_mask: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        split = self.tp_size > 1
        if split:  # one all-reduce backward per distinct input
            copies = {}
            for t in (query, key, value):
                if id(t) not in copies:
                    copies[id(t)] = partition.copy_to_model(t)
            query, key, value = (copies[id(t)] for t in (query, key, value))
        q = self.q_proj(query)
        k = self.k_proj(key)
        v = self.v_proj(value)
        heads = self.num_heads // self.tp_size
        rate = self.dropout if self.training else 0.0
        if rate > 0.0:
            _need_seed(seed, "attention dropout")
        lq, lk = q.shape[-2], k.shape[-2]
        if q.dim() == 3 and routes_to_kernel(partition.global_rows(q.shape[0]),
                                             self.num_heads, lq, lk):
            if key_padding_mask is not None:
                key_padding_mask = key_padding_mask.contiguous()
            out = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  key_padding_mask, heads, rate,
                                  partition.kernel_seed(seed, q.shape[0], heads, split))
        else:
            weights = attention_weights(q, k, key_padding_mask, heads)
            out = attend(dropout(weights, rate, seed, -3 if split else None), v, heads)
        if split:
            return partition.reduce_from_model(
                F.linear(out, self.out_proj.weight)) + self.out_proj.bias
        return self.out_proj(out)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (same parameters, ``weight`` and ``bias``, same
    state dict) whose forward is ``ops.layer_norm.layer_norm``: the
    row-packed CUDA kernels for a CUDA input they take, ``F.layer_norm``
    otherwise."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)


class TransformerBlock(nn.Module):
    """Post-LN block with an optional cross-attention context:

      x   = LN1(x + drop(SelfAttn(x, key_padding_mask=mask)))
      ctx = LN_ctx(ctx + drop(CtxSelfAttn(ctx)))   # iff context_self_attn
      x   = LN2(x + drop(CrossAttn(x, ctx, key_padding_mask=context_mask)))
      x   = LN3(x + drop(FFN(x)))                   # Dense → GELU → Dense

    Every tower of the model calls its blocks with a context, so the
    cross-attention parameters always exist. In train mode the seven
    dropout sites (three attentions, four residual branches) draw from
    ``fold_in(seed, site)``. Each run of the context self-attention adds one
    to ``ops.counters`` ``ctx attn``. ``tp_size`` > 1 (``parallel.shard_params_tp``)
    means ``ffn_0`` holds this rank's hidden columns and ``ffn_2`` the
    matching rows."""

    tp_size = 1

    def __init__(self, embed_dim: int, num_heads: int, ff_dim: int,
                 dropout: float = 0.1, context_self_attn: bool = False):
        super().__init__()
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, dropout)
        self.layernorm1 = LayerNorm(embed_dim, eps=LN_EPS)
        self.context_self_attn = None
        if context_self_attn:
            self.context_self_attn = MultiHeadAttention(embed_dim, num_heads, dropout)
            self.layernorm_context = LayerNorm(embed_dim, eps=LN_EPS)
        self.cross_attn = MultiHeadAttention(embed_dim, num_heads, dropout)
        self.layernorm2 = LayerNorm(embed_dim, eps=LN_EPS)
        self.ffn_0 = nn.Linear(embed_dim, ff_dim)
        self.ffn_2 = nn.Linear(ff_dim, embed_dim)
        self.layernorm3 = LayerNorm(embed_dim, eps=LN_EPS)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0

        def site(i):
            return maybe_fold_in(seed, i)

        attn = self.self_attn(x, x, x, key_padding_mask=mask, seed=site(0))
        x = self.layernorm1(x + dropout(attn, rate, site(1)))
        if context is not None:
            if self.context_self_attn is not None:
                counters.ctx_attn_calls += 1
                ctx = self.context_self_attn(context, context, context,
                                             key_padding_mask=context_mask, seed=site(2))
                context = self.layernorm_context(context + dropout(ctx, rate, site(3)))
            cross = self.cross_attn(x, context, context, key_padding_mask=context_mask,
                                    seed=site(4))
            x = self.layernorm2(x + dropout(cross, rate, site(5)))
        if self.tp_size > 1:  # ffn_0's columns and ffn_2's rows of this rank
            h = F.gelu(self.ffn_0(partition.copy_to_model(x)), approximate="none")
            h = partition.reduce_from_model(F.linear(h, self.ffn_2.weight)) + self.ffn_2.bias
        else:
            h = self.ffn_2(F.gelu(self.ffn_0(x), approximate="none"))
        return self.layernorm3(x + dropout(h, rate, site(6)))


def _run_in_mode(block: nn.Module, training: bool, bits: int, *args):
    """Run ``block`` in the train/eval mode and at the kernels' dropout
    width ``bits`` it had at the forward. The checkpoint's re-run comes in
    the backward, when the caller may have switched modes (``encode`` runs
    an encoder in eval mode inside a training step) or the environment."""
    with pin_dropout_bits(bits):
        if block.training == training:
            return block(*args)
        was = block.training
        block.train(training)
        try:
            return block(*args)
        finally:
            block.train(was)


class TransformerStack(nn.Module):
    """``num_layers`` TransformerBlocks ``block_i`` applied in turn; block i
    takes ``fold_in(seed, i)``.

    ``remat`` (None: ``remat_default()``, on unless ``VAESNE_REMAT=0``, as
    in the JAX package, read when the stack is built where the JAX package
    reads it once, at import) rematerialises each block in the backward
    whenever gradients are recorded:
    ``torch.utils.checkpoint`` keeps only the block's inputs and re-runs it
    before its backward, trading compute for the activations over the
    982-token grids. The block's seed and the kernels' dropout width are
    arguments of the checkpointed call, so the re-run draws the same
    dropout masks."""

    def __init__(self, embed_dim: int, num_heads: int, ff_dim: int, num_layers: int,
                 dropout: float = 0.1, context_self_attn: bool = False,
                 remat: Optional[bool] = None):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat_default() if remat is None else remat
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                embed_dim, num_heads, ff_dim, dropout, context_self_attn))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                context_mask: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        bits = dropout_bits() if remat else None
        for i in range(self.num_layers):
            block = getattr(self, f"block_{i}")
            args = (x, context, mask, context_mask, maybe_fold_in(seed, i))
            if remat:
                # no global generator is drawn from, so none is saved either
                x = checkpoint(_run_in_mode, block, self.training, bits, *args,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(*args)
        return x
