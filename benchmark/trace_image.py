"""The image cell's readings of a traced sub-window (``trace.Profile``):
K1's and K2's rooflines over the image's launch plan, and the cuDNN
convolutions' share of the busy time and of their roofline.

``trace.roofline_pct`` sizes the attention grids from the photometry +
spectra configuration; these read the image configuration's
(``counts.image``). Each returns None where there is nothing to read: no
plan (a run that was not traced), or a trace that disagrees with the
program's launch counters (the parent of the ``conv`` counter has none).
"""

from __future__ import annotations

import sys
from typing import Optional

from benchmark import counts
from benchmark.counts import image

# the cuDNN convolution kernels (implicit-GEMM forward, input and weight
# gradients, direct weight gradients, FFT tiles and their complex products)
CONV = ("_cudnn", "cudnn::", "fft2d_", "cf32cf32")
FORWARD = "fprop"


def attention_roofline_pct(prof, kernel: str, *names: str) -> Optional[float]:
    """K1's or K2's bound over its device time, %: the least time of every
    launch of the plan in the sub-window, over the time of the kernels named
    ``names``, if the trace holds as many as the plan."""
    plan = (prof.work.get("launches") or {}).get(kernel)
    seconds, launches = prof.kernel_seconds(*names)
    if not plan or seconds <= 0:
        return None
    s, dtype = image.shape_of(prof.config), prof.work["dtype"]
    bound = expected = 0
    for grid, stats, n in plan:
        if kernel == "K1":
            flops, nbytes = counts.attention_fwd(grid.rows, grid.lq, grid.lk, s.E, s.H,
                                                 grid.masked, bool(stats), dtype)
        else:
            flops, nbytes = counts.attention_bwd(grid.rows, grid.lq, grid.lk, s.E, s.H, dtype)
        bound += n * counts.bound_s(nbytes, flops, dtype)
        expected += n
    if launches != expected:
        print(f"benchmark: the trace holds {launches} {kernel} kernels where {expected} were "
              f"launched", file=sys.stderr)
        return None
    return 100.0 * bound / seconds


def _conv_plan(prof):
    """The convolutions' plan, if the trace's forward convolutions are as
    many as the ``conv`` counter counted."""
    plan = (prof.work.get("launches") or {}).get("conv")
    if not plan:
        return None
    _, forwards = prof.kernel_seconds(FORWARD)
    counted = prof.counters.get("conv")
    if forwards != counted:
        print(f"benchmark: the trace holds {forwards} forward convolutions where the conv "
              f"counter counted {counted}", file=sys.stderr)
        return None
    return plan


def conv_pct(prof) -> Optional[float]:
    """The convolution kernels' share of the device's busy time, %."""
    seconds, _ = prof.kernel_seconds(*CONV)
    if _conv_plan(prof) is None or prof.busy_s <= 0:
        return None
    return 100.0 * seconds / prof.busy_s


def conv_roofline_pct(prof) -> Optional[float]:
    """The convolutions' least time (every forward, dgrad and wgrad of the
    plan) over the convolution kernels' device time, %."""
    plan = _conv_plan(prof)
    seconds, _ = prof.kernel_seconds(*CONV)
    if plan is None or seconds <= 0:
        return None
    dtype = prof.work["dtype"]
    bound = sum(n * counts.bound_s(nbytes, flops, dtype)
                for conv, n in plan for _, flops, nbytes in image.conv_products(conv, dtype))
    return 100.0 * bound / seconds
