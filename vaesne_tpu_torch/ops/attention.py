"""Fused masked multi-head attention (forward), a CUDA kernel for Hopper.

``fused_attention`` computes, per row and head, softmax(q kᵀ/√Dh + bias) v
over ``[R, L, E]`` tensors (head h in columns h·Dh:(h+1)·Dh) with a boolean
key-padding mask (True = ignore) folded in as a −1e9 fp32 logit bias.

It replaces the TPU kernel ``vaesne_tpu/ops/attention.py::_fwd_kernel`` at
dropout rate 0, with ``csrc/attention_fwd.cu``: one thread per query with an
online exp2-domain softmax over key chunks staged in shared memory. At the
flagship grid (982×982, 4 heads, Dh 8) fp32 FMA issue bounds it, not device
memory: 123 Mflop against 0.5 MB of I/O per row, ~245 flop per byte (the
design notes are in the CUDA source).

A CUDA tensor launches the kernel or raises; a CPU tensor takes
``attention_reference``, the plain version of the same function.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

launches = 0  # kernel launches made by fused_attention since the last reset

HEAD_DIMS = (4, 8, 16, 32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_padding_mask: Optional[torch.Tensor],
                        num_heads: int, dropout: float = 0.0) -> torch.Tensor:
    """The plain version: einsum, −1e9 mask bias, softmax, einsum over
    ``[R, L, E]``. ``dropout`` > 0 drops attention weights (train mode,
    torch ``nn.MultiheadAttention`` placement)."""
    e = q.shape[-1]
    hd = e // num_heads

    def split(x):  # [R, L, E] -> [R, L, H, hd]
        return x.reshape(*x.shape[:-1], num_heads, hd)

    logits = torch.einsum("...qhd,...khd->...hqk", split(q), split(k)) / math.sqrt(hd)
    if key_padding_mask is not None:
        bias = torch.zeros(key_padding_mask.shape, dtype=logits.dtype,
                           device=logits.device)
        bias = bias.masked_fill(key_padding_mask, -1e9)
        logits = logits + bias[..., None, None, :]
    weights = torch.softmax(logits, dim=-1)
    if dropout > 0.0:
        weights = torch.nn.functional.dropout(weights, dropout, training=True)
    out = torch.einsum("...hqk,...khd->...qhd", weights, split(v))
    return out.reshape(*out.shape[:-2], e)


def _check(q, k, v, key_padding_mask, num_heads):
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


def _kernel_fn():
    fn = _build.load("attention_fwd").vaesne_attention_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor],
                    num_heads: int) -> torch.Tensor:
    """softmax(q_h k_hᵀ/√Dh + bias) v_h for every head h, fused.

    q [R, Lq, E]; k, v [R, Lk, E]; ``key_padding_mask`` bool [R, Lk]
    (True = ignore) or None. Returns [R, Lq, E] in q's dtype (float32 or
    bfloat16; all arithmetic is fp32). On CUDA tensors it launches the
    kernel on the current stream without synchronising; on CPU tensors it
    computes ``attention_reference``."""
    _check(q, k, v, key_padding_mask, num_heads)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_padding_mask, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on CUDA or CPU tensors, not {q.device}")
    R, lq, e = q.shape
    out = torch.empty_like(q)
    if R == 0 or lq == 0:
        return out
    fn = _kernel_fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                0 if key_padding_mask is None else key_padding_mask.data_ptr(),
                out.data_ptr(), R, lq, k.shape[1], num_heads, e // num_heads,
                _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out
