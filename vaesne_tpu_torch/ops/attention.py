"""Fused masked multi-head attention, forward and backward, CUDA kernels for
Hopper.

``fused_attention`` computes, per row and head, softmax(q kᵀ/√Dh + bias) v
over ``[R, L, E]`` tensors (head h in columns h·Dh:(h+1)·Dh) with a boolean
key-padding mask (True = ignore) folded in as a −1e9 fp32 logit bias, and
attention-weight dropout at ``dropout_rate`` > 0.

Kernels, in ``csrc/``:

* K1 ``attention_fwd.cu`` replaces ``vaesne_tpu/ops/attention.py::_fwd_kernel``
  (both rates). A warp per 16 queries, an online exp2-domain softmax over
  key chunks; with a gradient to come it also writes the row max m and row
  sum l of the exp2-domain logits. fp32 at head size 8 with 64 to 1664 keys
  (``routes_pipelined``; counted in ``pipelined_launches``) takes the
  pipelined kernel: a block per (row, head) stages all its keys once, split
  into TF32 planes, and the next chunk's scores run on ``wgmma`` while the
  current chunk's softmax and PV products run. The rest streams key chunks
  through shared memory by cp.async.
* K2 ``attention_bwd.cu`` replaces ``_bwd_kernel``: one kernel a call, a
  block per (row, head) and a warp per 16 keys, which recomputes
  p = exp2(s − m)/l and the dropout mask once per (query, key, head), sums
  dk and dv in registers and dq in a fixed order, without atomics, so two
  runs give equal bits. fp32 at head size 8 with up to 1024 queries and at
  least 64 keys (``routes_bwd_pipelined``; counted in
  ``bwd_pipelined_launches``) takes the pipelined kernel: the block stages
  all its queries once (q and dout split into TF32 planes, D = Σ do·o, m,
  1/l, the hash row), each warpgroup walks slabs of 64 keys with k and v in
  registers, sᵀ and dpᵀ run on ``wgmma`` one chunk of 16 queries ahead of
  the chunk whose p, ds, dv and dk run, and dq sums in shared memory, slab
  by slab in order. The rest streams query chunks through shared memory and
  sums dq in an fp32 scratch of its own.

Every product runs on the tensor cores (``mma.sync`` m16n8k8): in bf16 with
fp32 accumulation, in fp32 as 3xTF32 (each operand split into two TF32
parts, three products), which keeps fp32 accuracy. At the flagship grid
(982×982, 4 heads, Dh 8) one exp2 per (query, key, head) and the scalar
instructions around it bound both kernels, not the tensor cores or device
memory (the design notes are in the CUDA sources).

**Dropout mask.** The JAX package's own counter hash (``_hash_bits``, the
stream its kernels use in interpret mode) with its single-draw seeding and
its draw width w of ``VAESNE_DROPOUT_BITS`` (8, the default, 16 or 32;
``dropout_bits``): for row r, head h, query q and key j, with the query tile
qt = min(1024, max(128, ⌈Lq/128⌉·128)),

    block_seed = seed + (r·H + h)·1024 + ⌊q/qt⌋·(qt/128)   (uint32)
    keep  ⇔  hash(block_seed, q mod qt, j) >> (32 − w)  ≥  round(2ʷ·rate)

so the keep probability is quantised to a multiple of 1/2ʷ (230/256 at rate
0.1 and w = 8), while the kept weights are rescaled by 1/(1 − rate) exactly,
as in the JAX package. The kernels take the threshold shifted to 32 bits,
round(2ʷ·rate)·2³²⁻ʷ, and compare the hash with it. They read the seed from
a uint32 word in device memory (``utils.rng.seed_word``), not from a launch
argument, so a CUDA graph of the train step (``training.make_scan_epoch``)
draws each replayed step's mask: the host rewrites the word before a
replay. A forward keeps the width it ran at for its backward, and
``TransformerStack``'s rematerialised re-run takes the forward's too
(``pin_dropout_bits``), so a change of the environment between them cannot
change a mask. ``dropout_keep`` is the plain version of the same function.

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions (``attention_reference``, ``attention_stats_reference``,
``attention_backward_reference``), and autograd differentiates the plain
forward. The mask gets no gradient.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import os
import threading
from typing import Optional, Tuple, Union

import torch

from ..utils.rng import seed_of, seed_word
from . import _build

Seed = Union[int, torch.Tensor]  # an int, or a seed word on the tensors' device

launches = 0          # K1 launches (any rate) since the last reset
dropout_launches = 0  # K1 launches at a dropout rate > 0
pipelined_launches = 0  # K1 launches that took the pipelined fp32 kernel
bwd_launches = 0      # K2 launches: one per backward
bwd_pipelined_launches = 0  # K2 launches that took the pipelined fp32 kernel

HEAD_DIMS = (4, 8, 16, 32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LOG2E = 1.4426950408889634
MASK_BIAS = -1e9

# dropout hash (vaesne_tpu/ops/attention.py::_hash_bits, _dropout_mask)
Q_TILE = 1024
DROPOUT_WIDTHS = (8, 16, 32)  # VAESNE_DROPOUT_BITS; 8 by default
_M32 = 0xFFFFFFFF
_C_SEED, _C_ROW, _C_COL = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_C_MIX1, _C_MIX2 = 0x7FEB352D, 0x846CA68B


def hash_tile(lq: int) -> int:
    """The query tile that seeds the dropout stream: min(1024, Lq rounded up
    to a multiple of 128)."""
    return min(Q_TILE, max(128, -(-lq // 128) * 128))


_pinned = threading.local()  # a width pinned by pin_dropout_bits, per thread


def dropout_bits() -> int:
    """The width w of the dropout draws: the one ``pin_dropout_bits`` holds
    in this thread, else ``VAESNE_DROPOUT_BITS`` (default 8) with the JAX
    package's parse and error (``vaesne_tpu/ops/attention.py::_dropout_bits``)."""
    bits = getattr(_pinned, "bits", None)
    if bits is not None:
        return bits
    w = int(os.environ.get("VAESNE_DROPOUT_BITS", "8"))
    if w not in DROPOUT_WIDTHS:
        raise ValueError(f"VAESNE_DROPOUT_BITS={w} must be 8, 16 or 32")
    return w


@contextlib.contextmanager
def pin_dropout_bits(bits: int):
    """``dropout_bits()`` is ``bits`` in this thread inside the block (a
    rematerialised re-run takes its forward's width this way)."""
    if bits not in DROPOUT_WIDTHS:
        raise ValueError(f"dropout width {bits} must be 8, 16 or 32")
    prev = getattr(_pinned, "bits", None)
    _pinned.bits = bits
    try:
        yield
    finally:
        _pinned.bits = prev


def drop_threshold(rate: float, bits: Optional[int] = None) -> int:
    """Keep a weight iff its w-bit draw is at least this: round(2ʷ·rate),
    capped at 2ʷ − 1 (26 at rate 0.1 and w = 8); w = ``bits`` or
    ``dropout_bits()``."""
    w = dropout_bits() if bits is None else bits
    return min(round(rate * 2 ** w), 2 ** w - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x·c mod 2³² for int64 x in [0, 2³²), in 16-bit halves so that no
    product leaves the int64 range."""
    hi = ((x >> 16) * c) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * c) & _M32


def dropout_keep(seed: Seed, rows: int, num_heads: int, lq: int, lk: int, rate: float,
                 device=None, bits: Optional[int] = None) -> torch.Tensor:
    """The kernels' keep mask, bool [rows, H, Lq, Lk], as plain int64 tensor
    arithmetic (see the module docstring), at draw width ``bits`` (None:
    ``dropout_bits()``). ``seed`` is an int or the kernels' seed word
    (``utils.rng.seed_word``), read on the device without a host sync."""
    w = dropout_bits() if bits is None else bits
    qt = hash_tile(lq)
    i64 = dict(dtype=torch.int64, device=device)
    r = torch.arange(rows, **i64).view(-1, 1, 1)
    h = torch.arange(num_heads, **i64).view(1, -1, 1)
    q = torch.arange(lq, **i64).view(1, 1, -1)
    block_seed = (seed_of(seed, device) + (r * num_heads + h) * 1024
                  + (q // qt) * (qt // 128)) & _M32
    row = _mul32(block_seed, _C_SEED) ^ _mul32(q % qt + 1, _C_ROW)
    col = _mul32(torch.arange(1, lk + 1, **i64), _C_COL)
    x = row[..., None] ^ col
    x = x ^ (x >> 16)
    x = _mul32(x, _C_MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C_MIX2)
    x = x ^ (x >> 16)
    return (x >> (32 - w)) >= drop_threshold(rate, w)


def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:  # [R, L, E] -> [R, L, H, Dh]
    return x.reshape(*x.shape[:-1], num_heads, x.shape[-1] // num_heads)


def _logits(q, k, key_padding_mask, num_heads):
    """s = q kᵀ/√Dh + bias, [..., H, Lq, Lk]."""
    hd = q.shape[-1] // num_heads
    logits = torch.einsum("...qhd,...khd->...hqk", _split(q, num_heads),
                          _split(k, num_heads)) / math.sqrt(hd)
    if key_padding_mask is not None:
        bias = torch.zeros(key_padding_mask.shape, dtype=logits.dtype, device=logits.device)
        logits = logits + bias.masked_fill(key_padding_mask, MASK_BIAS)[..., None, None, :]
    return logits


def attention_weights(q: torch.Tensor, k: torch.Tensor,
                      key_padding_mask: Optional[torch.Tensor], num_heads: int) -> torch.Tensor:
    """softmax(q kᵀ/√Dh + bias), [..., H, Lq, Lk]."""
    return torch.softmax(_logits(q, k, key_padding_mask, num_heads), dim=-1)


def attend(weights: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The weighted sum of v's heads: weights [..., H, Lq, Lk] → [..., Lq, E]."""
    out = torch.einsum("...hqk,...khd->...qhd", weights.to(v.dtype), _split(v, num_heads))
    return out.reshape(*out.shape[:-2], v.shape[-1])


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_padding_mask: Optional[torch.Tensor], num_heads: int,
                        dropout: float = 0.0, seed: Optional[Seed] = None,
                        bits: Optional[int] = None) -> torch.Tensor:
    """The plain version: einsum, −1e9 mask bias, softmax, dropout of the
    weights with ``dropout_keep`` at width ``bits`` (rescaled by
    1/(1 − rate)), einsum, over ``[R, L, E]`` (dropout needs exactly one
    leading axis). ``seed`` is an int or a seed word."""
    weights = attention_weights(q, k, key_padding_mask, num_heads)
    if dropout > 0.0:
        if seed is None:
            raise ValueError("attention dropout needs a seed")
        keep = dropout_keep(seed, q.shape[0], num_heads, q.shape[1], k.shape[1], dropout,
                            q.device, bits)
        weights = torch.where(keep, weights * (1.0 / (1.0 - dropout)), 0.0)
    return attend(weights, v, num_heads)


def attention_stats_reference(q, k, key_padding_mask, num_heads):
    """The plain version of K1's saved statistics: row max m and row sum l
    of the exp2-domain logits, fp32 [R, H, Lq] each."""
    s2 = _logits(q.float(), k.float(), key_padding_mask, num_heads) * LOG2E
    m = s2.amax(-1)
    return m, torch.exp2(s2 - m[..., None]).sum(-1)


def attention_backward_reference(q, k, v, key_padding_mask, dout, num_heads,
                                 dropout: float = 0.0, seed: Optional[Seed] = None,
                                 bits: Optional[int] = None):
    """The plain version of K2: (dq, dk, dv) by autograd through
    ``attention_reference``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_reference(*leaves, key_padding_mask, num_heads, dropout, seed, bits)
        return torch.autograd.grad(out, leaves, dout)


def _check(q, k, v, key_padding_mask, num_heads, dropout_rate, seed):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("fused_attention takes q [R, Lq, E] and k, v [R, Lk, E]")
    R, lq, e = q.shape
    if k.shape != v.shape or k.shape[0] != R or k.shape[2] != e:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if e % num_heads:
        raise ValueError(f"E={e} not divisible by num_heads={num_heads}")
    if e // num_heads not in HEAD_DIMS:
        raise ValueError(f"head dim {e // num_heads} not supported by the kernel "
                         f"(supported: {HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape[1] < 1:
        raise ValueError("fused_attention needs at least one key")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("fused_attention: dropout_rate > 0 requires a seed")
    tensors = [q, k, v]
    if key_padding_mask is not None:
        if key_padding_mask.dtype != torch.bool:
            raise TypeError(f"key_padding_mask must be bool, got {key_padding_mask.dtype}")
        if tuple(key_padding_mask.shape) != (R, k.shape[1]):
            raise ValueError(f"key_padding_mask must be [R, Lk] = {(R, k.shape[1])}, "
                             f"got {tuple(key_padding_mask.shape)}")
        tensors.append(key_padding_mask)
    for t in tensors:
        if t.device != q.device:
            raise ValueError("fused_attention: all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("fused_attention takes contiguous tensors")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention runs on CUDA or CPU tensors, not {q.device}")


_p, _i, _u, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_FWD_ARGS = (_p,) * 7 + (ctypes.c_longlong, _i, _i, _i, _i, _i, _p, _u, _i, _f, _p)
_BWD_ARGS = (_p,) * 13 + (ctypes.c_longlong, _i, _i, _i, _i, _i, _p, _u, _i, _f, _p)


def _dropout_args(rate, word, bits):
    """(the seed word's address, or 0 at rate 0, where the kernels read no
    seed; the keep threshold shifted to 32 bits; 1 where the width is 32
    (the hash's last step then counts); 1/(1 − rate)) for the kernels."""
    return (_ptr(word), drop_threshold(rate, bits) << (32 - bits), int(bits == 32),
            1.0 / (1.0 - rate))


def _word(rate, seed, device) -> Optional[torch.Tensor]:
    """The kernels' seed word at a dropout rate > 0 (``seed_word``), else
    None."""
    return seed_word(seed, device) if rate > 0.0 else None


_ready_devices = set()  # devices on which vaesne_attention_fwd_init has run


def _fwd_kernel(device: torch.device):
    """K1's C entry point, with the library's per-device set-up (the
    pipelined kernel's shared-memory limit, the SM count) run once per device
    first; call with ``device`` current."""
    fn = _build.function("attention_fwd", "vaesne_attention_fwd", _FWD_ARGS)
    if device.index not in _ready_devices:
        init = _build.function("attention_fwd", "vaesne_attention_fwd_init", ())
        _build.check(init(), "attention_fwd set-up")
        _ready_devices.add(device.index)
    return fn


@functools.lru_cache(maxsize=None)
def routes_pipelined(dtype: torch.dtype, head_dim: int, lk: int) -> bool:
    """Whether K1 takes its pipelined fp32 kernel for these inputs: the C
    dispatch's own rule (fp32, Dh 8, Lk from one full chunk of 64 keys up to
    what shared memory holds), asked of the library."""
    fn = _build.function("attention_fwd", "vaesne_attention_fwd_pipelined", (_i, _i, _i))
    return bool(fn(_DTYPE_CODES[dtype], head_dim, lk))


@functools.lru_cache(maxsize=None)
def routes_bwd_pipelined(dtype: torch.dtype, head_dim: int, lq: int, lk: int) -> bool:
    """Whether K2 takes its pipelined fp32 kernel for these inputs: the C
    dispatch's own rule (fp32, Dh 8, from one query up to the queries that
    shared memory holds, from one full slab of 64 keys), asked of the
    library."""
    fn = _build.function("attention_bwd", "vaesne_attention_bwd_pipelined", (_i, _i, _i, _i))
    return bool(fn(_DTYPE_CODES[dtype], head_dim, lq, lk))


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes (a
    view at an odd offset): the kernels stage rows with 16-byte cp.async."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_padding_mask: Optional[torch.Tensor], num_heads: int,
                        dropout_rate: float = 0.0, seed: Optional[Seed] = None,
                        stats: bool = True, bits: Optional[int] = None):
    """K1: (out [R, Lq, E] in q's dtype, m, l) with m, l the fp32 row max
    and row sum [R, H, Lq] of the exp2-domain logits (None unless
    ``stats``), its dropout drawn at width ``bits`` (None:
    ``dropout_bits()``) from ``seed``, an int or a seed word, which the
    kernel reads from device memory. Launches on the current stream without
    synchronising."""
    _check(q, k, v, key_padding_mask, num_heads, dropout_rate, seed)
    bits = dropout_bits() if bits is None else bits
    if q.device.type == "cpu":
        out = attention_reference(q, k, v, key_padding_mask, num_heads, dropout_rate, seed,
                                  bits)
        if not stats:
            return out, None, None
        return (out, *attention_stats_reference(q, k, key_padding_mask, num_heads))
    R, lq, e = q.shape
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty(R, num_heads, lq, dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    if R == 0 or lq == 0:
        return out, m, l
    word = _word(dropout_rate, seed, q.device)
    with torch.cuda.device(q.device):
        fn = _fwd_kernel(q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask),
                out.data_ptr(), _ptr(m), _ptr(l), R, lq, k.shape[1], num_heads,
                e // num_heads, _DTYPE_CODES[q.dtype], *_dropout_args(dropout_rate, word, bits),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "attention_fwd")
    global launches, dropout_launches, pipelined_launches
    launches += 1
    dropout_launches += dropout_rate > 0.0
    pipelined_launches += routes_pipelined(q.dtype, e // num_heads, k.shape[1])
    return out, m, l


def fused_attention_bwd(q, k, v, key_padding_mask, out, row_max, row_sum, dout,
                        num_heads: int, dropout_rate: float = 0.0,
                        seed: Optional[Seed] = None,
                        bits: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """K2: (dq, dk, dv) in q's dtype, from the forward's inputs, its output
    ``out`` and statistics, and the output gradient ``dout``, with the
    forward's dropout width ``bits`` (None: ``dropout_bits()``). Launches
    one kernel on the current stream; PR 3's chunked kernel gets fp32
    scratch for the delta row term Σ_d dout·out and the dq sums, the
    pipelined one keeps both in shared memory."""
    _check(q, k, v, key_padding_mask, num_heads, dropout_rate, seed)
    bits = dropout_bits() if bits is None else bits
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, key_padding_mask, dout, num_heads,
                                            dropout_rate, seed, bits)
    R, lq, e = q.shape
    lk, hd = k.shape[1], e // num_heads
    for name, t, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("row_max", row_max, (R, num_heads, lq)),
                           ("row_sum", row_sum, (R, num_heads, lq))):
        want = torch.float32 if name.startswith("row") else q.dtype
        if (t.shape != shape or t.dtype != want or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"fused_attention_bwd: {name} must be a contiguous {want} "
                             f"{tuple(shape)} tensor on {q.device}")
    q, k, v, out, dout = (_aligned(t) for t in (q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if R == 0 or lq == 0:
        return dq, dk.zero_(), dv.zero_()
    piped = routes_bwd_pipelined(q.dtype, hd, lq, lk)
    delta = dq_acc = None
    if not piped:
        delta = torch.empty_like(row_max)
        dq_acc = torch.empty(R, num_heads, lq, hd, dtype=torch.float32, device=q.device)
    fn = _build.function("attention_bwd", "vaesne_attention_bwd", _BWD_ARGS)
    word = _word(dropout_rate, seed, q.device)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask),
                out.data_ptr(), dout.data_ptr(), row_max.data_ptr(), row_sum.data_ptr(),
                _ptr(delta), _ptr(dq_acc), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), R, lq, lk, num_heads, hd, _DTYPE_CODES[q.dtype],
                *_dropout_args(dropout_rate, word, bits),
                torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "attention_bwd")
    global bwd_launches, bwd_pipelined_launches
    bwd_launches += 1
    bwd_pipelined_launches += piped
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """K1 forward, K2 backward. The statistics and the output ride along as
    saved tensors, the dropout width and seed word in the context; under
    ``torch.utils.checkpoint`` the forward re-runs in the backward with the
    same seed and width, so it regenerates the same mask."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, num_heads, dropout_rate, seed, bits):
        out, m, l = fused_attention_fwd(q, k, v, key_padding_mask, num_heads,
                                        dropout_rate, seed, stats=True, bits=bits)
        ctx.save_for_backward(q, k, v, key_padding_mask, out, m, l)
        ctx.config = (num_heads, dropout_rate, seed, bits)
        ctx.mark_non_differentiable(m, l)
        return out, m, l

    @staticmethod
    def backward(ctx, dout, _dm, _dl):
        q, k, v, key_padding_mask, out, m, l = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, key_padding_mask, out, m, l,
                                         dout.to(q.dtype).contiguous(), *ctx.config)
        return dq, dk, dv, None, None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor], num_heads: int,
                    dropout_rate: float = 0.0, seed: Optional[Seed] = None) -> torch.Tensor:
    """softmax(q_h k_hᵀ/√Dh + bias) v_h for every head h, fused, with
    attention-weight dropout at ``dropout_rate`` (which needs ``seed``, an
    int or a seed word; the same seed gives the same mask). At a rate > 0
    the seed becomes a word on q's device (``utils.rng.seed_word``: under a
    CUDA graph's capture the graph's word, which each replay rewrites) that
    the plain version and both kernels read.

    q [R, Lq, E]; k, v [R, Lk, E]; ``key_padding_mask`` bool [R, Lk]
    (True = ignore) or None. Returns [R, Lq, E] in q's dtype (float32 or
    bfloat16; softmax statistics and sums in fp32). On CUDA tensors it launches K1, and
    K2 in the backward when q, k or v needs a gradient; on CPU tensors it
    computes ``attention_reference``, which autograd differentiates. The
    dropout draws have the width ``dropout_bits()`` gives at this call."""
    _check(q, k, v, key_padding_mask, num_heads, dropout_rate, seed)
    bits = dropout_bits()
    seed = _word(dropout_rate, seed, q.device)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_padding_mask, num_heads, dropout_rate, seed,
                                   bits)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FusedAttention.apply(q, k, v, key_padding_mask, num_heads, dropout_rate,
                                     seed, bits)[0]
    return fused_attention_fwd(q, k, v, key_padding_mask, num_heads, dropout_rate, seed,
                               stats=False, bits=bits)[0]
