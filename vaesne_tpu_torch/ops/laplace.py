"""Fused masked Laplace log-likelihood, forward and backward, Triton kernels
for Hopper.

The likelihood term of every objective is, per row r,

    Σ_n −|x − loc|/s − log(2s),   s = 1 + big·mask,

over [K·B, N] grids (the decoder's mask-variance trick). Kernels:

* K3 ``_fwd_kernel`` replaces ``vaesne_tpu/ops/laplace.py::_fwd_kernel``: one
  program per row, the whole row (N ≤ BLOCK, a power of two: 1024 for the
  982-bin spectra) in one block, scale, log-pdf and the row sum fused, so
  the [R, N] scale and log-pdf tensors never reach device memory.
* K4 ``_bwd_kernel`` replaces ``_bwd_kernel`` there: dloc = g·sign(x − loc)/s,
  with respect to loc only (x and the mask are data), sign(0) = 0.

What bounds them on the card: device memory and launch latency. At the
training shapes (R = 384, N = 982) K3 reads 3.4 MB and K4 moves 4.9 MB, a
microsecond or two at 3.35 TB/s, so a launch costs more than the data. Both
are single elementwise passes (K3 with one row reduction) with no matrix
product, shared-memory staging or cross-block state, which is what Triton's
block model writes directly.

Operands: ``loc`` and the bool ``mask`` are [R, N]; ``x`` may have fewer
rows, Rx dividing R, and row r then reads row r // (R/Rx) of x. The
objectives pass the unexpanded data [B, N] beside the batch-major [B·K, N]
loc (row b·K + k), so the K-fold broadcast of x is never materialised; the
mask comes from the decoder already [B·K, N]. The kernels take fp32 loc and
x; the wrapper casts.

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions (``masked_laplace_loglik_reference``, and autograd through it).
``triton`` is imported, and the kernels compiled, at the first launch.
"""

from __future__ import annotations

import functools

import torch

launches = 0      # K3 launches since the last reset
bwd_launches = 0  # K4 launches since the last reset


def _expand_rows(other: torch.Tensor, rows: int) -> torch.Tensor:
    """other [Ro, N] expanded to [rows, N], row r holding row r // (rows/Ro)."""
    return other.repeat_interleave(rows // other.shape[0], dim=0)


def masked_laplace_loglik_reference(loc: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                                    big: float) -> torch.Tensor:
    """The plain version: row sums [R] of the Laplace log-pdf of x under
    loc with scale 1 + big·mask, in fp32."""
    x = _expand_rows(x, loc.shape[0]).float()
    scale = 1.0 + big * mask.float()
    return (-torch.abs(x - loc.float()) / scale - torch.log(2.0 * scale)).sum(-1)


def masked_laplace_grad_reference(loc, x, mask, big: float, g: torch.Tensor) -> torch.Tensor:
    """The plain version of K4: dloc = g·sign(x − loc)/(1 + big·mask), [R, N]."""
    scale = 1.0 + big * mask.float()
    return g.float()[:, None] * torch.sign(_expand_rows(x, loc.shape[0]).float() - loc.float()) / scale


def _check(loc, x, mask):
    if loc.dim() != 2 or x.dim() != 2 or mask.dim() != 2:
        raise ValueError("masked_laplace_loglik takes loc [R, N], x [Rx, N], mask [R, N]")
    R, n = loc.shape
    if x.shape[1] != n or x.shape[0] < 1 or R % x.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} must be [Rx, {n}] with Rx dividing R = {R}")
    if mask.shape != loc.shape:
        raise ValueError(f"mask {tuple(mask.shape)} must be [R, N] = {tuple(loc.shape)}")
    if x.device != loc.device or mask.device != loc.device:
        raise ValueError("masked_laplace_loglik: all tensors must be on one device")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if loc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_laplace_loglik runs on CUDA or CPU tensors, not {loc.device}")


@functools.lru_cache(maxsize=None)
def _kernels():
    """Compile-on-first-use Triton kernels (no ``triton`` on a CPU host)."""
    import triton
    import triton.language as tl

    @triton.jit
    def fwd_kernel(loc_ptr, x_ptr, mask_ptr, out_ptr, n, x_rep, big,
                   BLOCK: tl.constexpr):
        r = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        inside = cols < n
        loc = tl.load(loc_ptr + r * n + cols, mask=inside, other=0.0)
        x = tl.load(x_ptr + (r // x_rep) * n + cols, mask=inside, other=0.0)
        m = tl.load(mask_ptr + r * n + cols, mask=inside, other=0)
        scale = 1.0 + big * m.to(tl.float32)
        lp = -tl.abs(x - loc) / scale - tl.log(2.0 * scale)
        tl.store(out_ptr + r, tl.sum(tl.where(inside, lp, 0.0), axis=0))

    @triton.jit
    def bwd_kernel(loc_ptr, x_ptr, mask_ptr, g_ptr, dloc_ptr, n, x_rep, big,
                   BLOCK: tl.constexpr):
        r = tl.program_id(0)
        cols = tl.arange(0, BLOCK)
        inside = cols < n
        loc = tl.load(loc_ptr + r * n + cols, mask=inside, other=0.0)
        x = tl.load(x_ptr + (r // x_rep) * n + cols, mask=inside, other=0.0)
        m = tl.load(mask_ptr + r * n + cols, mask=inside, other=0)
        scale = 1.0 + big * m.to(tl.float32)
        diff = x - loc
        sign = tl.where(diff > 0, 1.0, tl.where(diff < 0, -1.0, 0.0))
        g = tl.load(g_ptr + r)
        tl.store(dloc_ptr + r * n + cols, g * sign / scale, mask=inside)

    return triton, fwd_kernel, bwd_kernel


def _launch_args(loc, x, mask):
    triton, fwd, bwd = _kernels()
    R, n = loc.shape
    block = max(16, triton.next_power_of_2(n))
    # the mask travels as uint8 bytes (a bool tensor's storage, no copy)
    return (fwd, bwd, R, n, R // x.shape[0], block, mask.contiguous().view(torch.uint8))


def _warps(block: int) -> int:
    return 4 if block <= 1024 else 8


def masked_laplace_loglik_fwd(loc: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                              big: float) -> torch.Tensor:
    """K3: row sums [R] fp32 (see the module docstring for the shapes)."""
    _check(loc, x, mask)
    if loc.device.type == "cpu":
        return masked_laplace_loglik_reference(loc, x, mask, big)
    loc, x = loc.float().contiguous(), x.float().contiguous()
    fwd, _, R, n, x_rep, block, mask8 = _launch_args(loc, x, mask)
    out = torch.empty(R, dtype=torch.float32, device=loc.device)
    if R == 0 or n == 0:
        return out.zero_()
    with torch.cuda.device(loc.device):
        fwd[(R,)](loc, x, mask8, out, n, x_rep, float(big), BLOCK=block,
                  num_warps=_warps(block))
    global launches
    launches += 1
    return out


def masked_laplace_loglik_bwd(loc: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                              big: float, g: torch.Tensor) -> torch.Tensor:
    """K4: dloc [R, N] fp32 for the output gradient g [R]."""
    _check(loc, x, mask)
    if g.shape != loc.shape[:1]:
        raise ValueError(f"g must be [R] = {tuple(loc.shape[:1])}, got {tuple(g.shape)}")
    if loc.device.type == "cpu":
        return masked_laplace_grad_reference(loc, x, mask, big, g)
    loc, x, g = loc.float().contiguous(), x.float().contiguous(), g.float().contiguous()
    _, bwd, R, n, x_rep, block, mask8 = _launch_args(loc, x, mask)
    dloc = torch.empty(R, n, dtype=torch.float32, device=loc.device)
    if R == 0 or n == 0:
        return dloc
    with torch.cuda.device(loc.device):
        bwd[(R,)](loc, x, mask8, g, dloc, n, x_rep, float(big), BLOCK=block,
                  num_warps=_warps(block))
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
    """Row sums [R] of the Laplace log-pdf with scale = 1 + big·mask,
    differentiable in ``loc`` [R, N] (cast to fp32); x [Rx, N] and the bool
    mask [R, N] are data. On CUDA tensors it launches K3, and K4 in the
    backward; on CPU tensors it computes the plain version, which autograd
    differentiates."""
    _check(loc, x, mask)
    if loc.device.type == "cpu":
        return masked_laplace_loglik_reference(loc, x, mask, big)
    return _MaskedLaplaceLoglik.apply(loc.float(), x, mask, float(big))
