"""LayerNorm over the last axis, forward and backward, CUDA kernels for
Hopper.

``layer_norm`` is ``torch.nn.functional.layer_norm`` with a 1-D
``normalized_shape``: per row of N features

    y = (x − mean) / √(var + eps) · γ + β,   var the biased variance.

Kernels, in ``csrc/layer_norm.cu`` (no TPU kernel: the JAX package
normalises with flax's ``nn.LayerNorm``):

* ``vaesne_layer_norm_fwd_kernel`` packs rows into warps, N/4 lanes a row
  holding a float4 each, and writes y with the row's mean and 1/√(var + eps)
  for the backward. Its arithmetic is the formula's, two exact passes, IEEE
  division and square root, rounded where the formula rounds.
* ``vaesne_layer_norm_bwd_kernel`` writes dx in the same layout and, in the
  same pass, one [2, N] partial of Σ dy·x̂ and Σ dy per block;
  ``vaesne_layer_norm_gamma_beta_kernel`` adds the partials in a fixed
  order into dγ and dβ. No atomics: two runs give equal bits.

Which calls take the kernels: a CUDA tensor whose last axis is the whole
normalized shape, of width 32 or 64, with γ and β, in fp32 once autocast has
cast it (``torch.amp.custom_fwd``: under bf16 autocast the inputs are cast
to fp32 and the output is fp32, as autocast does for ``F.layer_norm``). Any
other CUDA call computes ``F.layer_norm`` and counts in ``plain_calls``; a
CPU tensor computes ``F.layer_norm`` and counts nowhere. A non-contiguous or
misaligned operand is copied first. The kernels are built by ``_build`` at
the first launch; the C side picks each launch's grid.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build

launches = 0      # forward launches ("LN")
bwd_launches = 0  # backward launches, each the row pass and then the γ/β stage ("LN bwd")
plain_calls = 0   # CUDA calls that computed F.layer_norm ("LN plain")

WIDTHS = (32, 64)
_AUTOCAST_CASTS = (torch.float16, torch.bfloat16, torch.float32)
_p, _ll, _i, _f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_FWD_ARGS = (_p, _p, _p, _p, _p, _p, _ll, _i, _f, _i, _p)
_BWD_ARGS = (_p, _p, _p, _p, _p, _p, _p, _p, _p, _ll, _i, _i, _i, _p)
_BLOCKS_ARGS = (_i, _i, _ll, _i, ctypes.POINTER(_i))


def takes_kernel(x: torch.Tensor, normalized_shape, weight, bias) -> bool:
    """True where ``layer_norm`` launches the kernels for these operands."""
    if x.device.type != "cuda" or x.dim() == 0 or weight is None or bias is None:
        return False
    n = x.shape[-1]
    if n not in WIDTHS or tuple(normalized_shape) != (n,):
        return False
    if weight.device != x.device or bias.device != x.device:
        return False
    cast = torch.is_autocast_enabled("cuda")
    return all(t.dtype == torch.float32 or (cast and t.dtype in _AUTOCAST_CASTS)
               for t in (x, weight, bias))


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy of it where it is not contiguous or does
    not start on a 16-byte boundary (the kernels load float4s)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def _check(rows: torch.Tensor, *others: torch.Tensor) -> None:
    """Raise unless ``rows`` is [M, N] and each of ``others`` [M, N] or
    [N], N one of WIDTHS, all fp32 CUDA tensors on one device, contiguous
    and 16-byte aligned (what ``_operand`` makes of them)."""
    if rows.dim() != 2 or rows.shape[1] not in WIDTHS:
        raise ValueError(f"the LayerNorm kernels take [M, N] with N in {WIDTHS}, "
                         f"got {tuple(rows.shape)}")
    operands = (rows, *others)
    for t in operands:
        if t.shape not in (rows.shape, rows.shape[1:]):
            raise ValueError(f"operand {tuple(t.shape)} does not fit rows {tuple(rows.shape)}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in operands):
        raise ValueError("the LayerNorm kernels take contiguous, 16-byte aligned operands")
    for t in operands:
        if t.dtype != torch.float32 or t.device != rows.device or t.device.type != "cuda":
            raise TypeError(f"the LayerNorm kernels take fp32 CUDA tensors on one device, got "
                            f"{t.dtype} on {t.device}")


def _stream(device: int) -> int:
    """The handle of the device's current stream, as torch's generated
    kernels take it: no Stream object made per launch."""
    return torch._C._cuda_getCurrentRawStream(device)


def _fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """The forward kernel over x's M rows of N (x of any rank, else as
    ``_check`` accepts it): y of x's shape and the row statistics [2, M]
    (mean, then rstd)."""
    n = x.shape[-1]
    M = x.numel() // n
    y = torch.empty_like(x)
    stats = torch.empty(2, M, dtype=torch.float32, device=x.device)
    if M == 0:
        return y, stats
    device = x.get_device()
    fn = _build.function("layer_norm", "vaesne_layer_norm_fwd", _FWD_ARGS)
    at = stats.data_ptr()
    _build.check(fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), at,
                    at + 4 * M, M, n, eps, device, _stream(device)), "layer_norm_fwd")
    global launches
    launches += 1
    return y, stats


def _bwd(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, mean_ptr: int, rstd_ptr: int):
    """The backward kernels over x's M rows of N and dy of x's shape (as
    ``_fwd`` takes x) and the forward's row statistics at ``mean_ptr``,
    ``rstd_ptr``: dx of x's shape, dγ [N] and dβ [N]."""
    n = x.shape[-1]
    M = x.numel() // n
    dx = torch.empty_like(x)
    dgamma = torch.empty(n, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(n, dtype=torch.float32, device=x.device)
    if M == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    device = x.get_device()
    blocks = _i(0)
    _build.check(_build.function("layer_norm", "vaesne_layer_norm_blocks", _BLOCKS_ARGS)(
        n, 1, M, device, ctypes.byref(blocks)), "layer_norm grid")
    partial = torch.empty(blocks.value, 2 * n, dtype=torch.float32, device=x.device)
    fn = _build.function("layer_norm", "vaesne_layer_norm_bwd", _BWD_ARGS)
    _build.check(fn(x.data_ptr(), dy.data_ptr(), mean_ptr, rstd_ptr, weight.data_ptr(),
                    dx.data_ptr(), partial.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), M, n,
                    blocks.value, device, _stream(device)), "layer_norm_bwd")
    global bwd_launches
    bwd_launches += 1
    return dx, dgamma, dbeta


def layer_norm_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """The forward kernel over x [M, N] (contiguous, fp32): y [M, N], mean
    [M] and rstd [M], launched on the current stream without
    synchronising."""
    _check(x, weight, bias)
    y, stats = _fwd(x, weight, bias, float(eps))
    return y, stats[0], stats[1]


def layer_norm_bwd(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor):
    """The backward kernels for the output gradient dy [M, N] (contiguous,
    fp32) of a forward over x: dx [M, N], dγ [N] and dβ [N]."""
    _check(x, dy, weight)
    for t in (mean, rstd):
        if (t.shape != x.shape[:1] or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"mean and rstd must be contiguous fp32 [{x.shape[0]}] on {x.device}")
    return _bwd(dy, x, weight, mean.data_ptr(), rstd.data_ptr())


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.float32)
    def forward(ctx, x, weight, bias, eps):
        x, weight, bias = _operand(x), _operand(weight), _operand(bias)
        y, stats = _fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    @once_differentiable
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        at = stats.data_ptr()
        dx, dgamma, dbeta = _bwd(_operand(dy.float()), x, weight, at, at + 4 * stats.shape[1])
        return dx, dgamma, dbeta, None


def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               eps: float = 1e-5) -> torch.Tensor:
    """``F.layer_norm(x, normalized_shape, weight, bias, eps)``, through the
    kernels where ``takes_kernel`` says so (differentiable in x, γ and β),
    else ``F.layer_norm`` itself."""
    if x.device.type != "cuda":
        return F.layer_norm(x, normalized_shape, weight, bias, eps)
    if not takes_kernel(x, normalized_shape, weight, bias):
        global plain_calls
        plain_calls += 1
        return F.layer_norm(x, normalized_shape, weight, bias, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, float(eps))
    # no graph to record: the forward kernel alone, in fp32 as under the
    # Function's custom_fwd
    if torch.is_autocast_enabled("cuda"):
        x, weight, bias = x.float(), weight.float(), bias.float()
    return _fwd(_operand(x), _operand(weight), _operand(bias), float(eps))[0]
