"""Fused masked Laplace log-likelihood, forward and backward, CUDA kernels
for Hopper.

The likelihood term of every objective is, per row,

    Σ_n −|x − loc|/s − log(2s),   s = 1 + big·mask,

over a grid of N points (the decoder's mask-variance trick). Kernels, in
``csrc/laplace.cu``:

* K3 ``vaesne_laplace_fwd`` replaces ``vaesne_tpu/ops/laplace.py::_fwd_kernel``:
  the scale, the log-pdf and the row sum fused, one row per block, every
  load of a row issued before any arithmetic.
* K4 ``vaesne_laplace_bwd`` replaces ``_bwd_kernel`` there: dloc =
  g·sign(x − loc)/s with respect to loc only (x and the mask are data),
  sign(0) = 0.

Two forms of the operands:

* flat: loc [R, N], x [Rx, N] with Rx dividing R (row r reads row
  r // (R/Rx) of x), mask [R, N] → [R];
* grid: loc [K, B, N], x and the mask broadcasting to [K, B, N] (x is
  usually the unexpanded data [B, N]) → [K, B]. This is the decoder's own
  layout: ``MaskedGridLaplace.grid_loglik`` hands over an expert's slice of
  the stacked decode as it lies (strides N and M·K·N, the mask likewise),
  and the kernels read it through its strides.

loc is fp32 or bf16 and is read in its own dtype; K4 returns dloc in loc's
shape and dtype (computed in fp32, rounded to nearest). x is read as fp32
(cast first if it is not), the mask as bool bytes; an operand whose last
axis has a stride other than 1 is copied first. On the decoder's output
none of these copies happens. Every sum is fp32.

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions (``masked_laplace_loglik_reference``, which autograd
differentiates, and ``masked_laplace_grad_reference``). The kernels are
built by ``_build`` at the first launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

launches = 0      # K3 launches since the last reset
bwd_launches = 0  # K4 launches since the last reset

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_p, _ll, _i, _f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_OPERAND = (_p, _ll, _ll)  # pointer, stride over k, stride over b
_FWD_ARGS = _OPERAND * 4 + (_ll, _ll, _i, _i, _i, _f, _f, _f, _p)
_BWD_ARGS = _OPERAND * 5 + (_ll, _ll, _i, _i, _i, _f, _p)
MAX_K = 65535  # the kernels' grid is (B, K) blocks


def _expand_rows(other: torch.Tensor, rows: int) -> torch.Tensor:
    """other [Ro, N] expanded to [rows, N], row r holding row r // (rows/Ro)."""
    return other.repeat_interleave(rows // other.shape[0], dim=0)


def masked_laplace_loglik_reference(loc: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                                    big: float) -> torch.Tensor:
    """The plain version: row sums of the Laplace log-pdf of x under loc
    with scale 1 + big·mask, in fp32; [R] in the flat form, [K, B] in the
    grid form."""
    if loc.dim() == 2:
        x = _expand_rows(x, loc.shape[0])
    scale = 1.0 + big * mask.float()
    return (-torch.abs(x.float() - loc.float()) / scale - torch.log(2.0 * scale)).sum(-1)


def masked_laplace_grad_reference(loc, x, mask, big: float, g: torch.Tensor) -> torch.Tensor:
    """The plain version of K4: dloc = g·sign(x − loc)/(1 + big·mask) in
    fp32, of loc's shape."""
    if loc.dim() == 2:
        x = _expand_rows(x, loc.shape[0])
    scale = 1.0 + big * mask.float()
    return g.float()[..., None] * torch.sign(x.float() - loc.float()) / scale


def _check(loc, x, mask):
    if loc.dim() == 2:
        if x.dim() != 2 or mask.dim() != 2:
            raise ValueError("masked_laplace_loglik takes loc [R, N], x [Rx, N], mask [R, N]")
        R, n = loc.shape
        if x.shape[1] != n or x.shape[0] < 1 or R % x.shape[0]:
            raise ValueError(f"x {tuple(x.shape)} must be [Rx, {n}] with Rx dividing R = {R}")
        if mask.shape != loc.shape:
            raise ValueError(f"mask {tuple(mask.shape)} must be [R, N] = {tuple(loc.shape)}")
    elif loc.dim() == 3:
        for name, t in (("x", x), ("mask", mask)):
            if t.dim() > 3 or any(s not in (1, n) for s, n in zip(t.shape[::-1], loc.shape[::-1])):
                raise ValueError(f"{name} {tuple(t.shape)} must broadcast to loc "
                                 f"[K, B, N] = {tuple(loc.shape)}")
    else:
        raise ValueError("masked_laplace_loglik takes loc [R, N] or [K, B, N], "
                         f"got {tuple(loc.shape)}")
    if x.device != loc.device or mask.device != loc.device:
        raise ValueError("masked_laplace_loglik: all tensors must be on one device")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if loc.dtype not in _DTYPE_CODES:
        raise TypeError(f"loc must be float32 or bfloat16, got {loc.dtype}")
    if loc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_laplace_loglik runs on CUDA or CPU tensors, not {loc.device}")


def _unit(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its last axis is not unit-stride."""
    return t if t.shape[-1] <= 1 or t.stride(-1) == 1 else t.contiguous()


def _layout(loc, x, mask):
    """(K, B, [(operand, stride over k, stride over b) for loc, x, mask],
    strides) of a launch, with ``strides(t)`` those of an output of loc's
    shape (or of its rows). The flat form runs as K = R/Rx and B = Rx: row
    r = b·K + k, which reads row b of x."""
    loc, mask = _unit(loc), _unit(mask)
    x = _unit(x if x.dtype == torch.float32 else x.float())
    if loc.dim() == 2:
        K, B = loc.shape[0] // x.shape[0], x.shape[0]
        if K > MAX_K:
            raise ValueError(f"masked_laplace_loglik takes R/Rx ≤ {MAX_K} on the card, got {K}")

        def strides(t):
            return t.stride(0), K * t.stride(0)

        return K, B, [(loc, *strides(loc)), (x, 0, x.stride(0)), (mask, *strides(mask))], strides
    K, B = loc.shape[:2]
    if K > MAX_K:
        raise ValueError(f"masked_laplace_loglik takes K ≤ {MAX_K} on the card, got {K}")

    def strides(t):
        return t.stride(0), t.stride(1)

    def broadcast(t):  # t's strides over k and b broadcast to [K, B, N]: 0 on a new axis
        lead = 3 - t.dim()
        return tuple(0 if i < lead or t.shape[i - lead] == 1 else t.stride(i - lead)
                     for i in (0, 1))

    return K, B, [(t, *broadcast(t)) for t in (loc, x, mask)], strides


@functools.lru_cache(maxsize=None)
def _log_terms(big: float):
    """(log 2, log(2(1 + big))) in fp32: log(2s) at an observed and at a
    masked point, computed as the plain version computes them."""
    scale = 1.0 + big * torch.tensor([0.0, 1.0])
    return tuple(torch.log(2.0 * scale).tolist())


def _pairs(n: int, operands) -> bool:
    """True where N is even and every row of every operand starts on a
    boundary of two points, so the kernels move points in pairs."""
    return n % 2 == 0 and all(
        t.data_ptr() % (2 * t.element_size()) == 0 and sk % 2 == 0 and sb % 2 == 0
        for t, sk, sb in operands)


def _args(operands):
    return [a for t, sk, sb in operands for a in (t.data_ptr(), sk, sb)]


def masked_laplace_loglik_fwd(loc: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                              big: float) -> torch.Tensor:
    """K3: row sums in fp32, [R] (flat form) or [K, B] (grid form); see the
    module docstring for the operands. Launches on the current stream
    without synchronising."""
    _check(loc, x, mask)
    if loc.device.type == "cpu":
        return masked_laplace_loglik_reference(loc, x, mask, big)
    n = loc.shape[-1]
    out = torch.empty(loc.shape[:-1], dtype=torch.float32, device=loc.device)
    if out.numel() == 0 or n == 0:
        return out.zero_()
    K, B, operands, strides = _layout(loc, x, mask)
    pairs = _pairs(n, operands)
    fn = _build.function("laplace", "vaesne_laplace_fwd", _FWD_ARGS)
    with torch.cuda.device(loc.device):
        rc = fn(*_args(operands + [(out, *strides(out))]), K, B, n, _DTYPE_CODES[loc.dtype],
                int(pairs), float(big), *_log_terms(float(big)),
                torch.cuda.current_stream(loc.device).cuda_stream)
    _build.check(rc, "laplace_fwd")
    global launches
    launches += 1
    return out


def masked_laplace_loglik_bwd(loc: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                              big: float, g: torch.Tensor) -> torch.Tensor:
    """K4: dloc of loc's shape and dtype for the output gradient g ([R] or
    [K, B], read through its strides: a broadcast g is not copied)."""
    _check(loc, x, mask)
    if tuple(g.shape) != tuple(loc.shape[:-1]):
        raise ValueError(f"g must be {tuple(loc.shape[:-1])}, got {tuple(g.shape)}")
    if loc.device.type == "cpu":
        return masked_laplace_grad_reference(loc, x, mask, big, g).to(loc.dtype)
    n = loc.shape[-1]
    dloc = torch.empty(loc.shape, dtype=loc.dtype, device=loc.device)
    if dloc.numel() == 0:
        return dloc
    K, B, operands, strides = _layout(loc, x, mask)
    g = g if g.dtype == torch.float32 else g.float()
    dloc_operand = (dloc, *strides(dloc))
    pairs = _pairs(n, operands + [dloc_operand])
    fn = _build.function("laplace", "vaesne_laplace_bwd", _BWD_ARGS)
    with torch.cuda.device(loc.device):
        rc = fn(*_args(operands + [(g, *strides(g)), dloc_operand]), K, B, n,
                _DTYPE_CODES[loc.dtype], int(pairs), float(big),
                torch.cuda.current_stream(loc.device).cuda_stream)
    _build.check(rc, "laplace_bwd")
    global bwd_launches
    bwd_launches += 1
    return dloc


class _MaskedLaplaceLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, loc, x, mask, big):
        ctx.save_for_backward(loc, x, mask)
        ctx.big = big
        return masked_laplace_loglik_fwd(loc, x, mask, big)

    @staticmethod
    def backward(ctx, g):
        loc, x, mask = ctx.saved_tensors
        return masked_laplace_loglik_bwd(loc, x, mask, ctx.big, g), None, None, None


def masked_laplace_loglik(loc: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                          big: float) -> torch.Tensor:
    """Row sums of the Laplace log-pdf with scale = 1 + big·mask, in fp32,
    differentiable in ``loc`` (fp32 or bf16): loc [R, N] with x [Rx, N] and
    the bool mask [R, N] gives [R]; loc [K, B, N] with x and the mask
    broadcasting to it gives [K, B]. x and the mask are data. On CUDA
    tensors it launches K3, and K4 in the backward; on CPU tensors it
    computes the plain version, which autograd differentiates."""
    _check(loc, x, mask)
    if loc.device.type == "cpu":
        return masked_laplace_loglik_reference(loc, x, mask, big)
    return _MaskedLaplaceLoglik.apply(loc, x, mask, float(big))
