"""Lightweight profiling hooks of the port.

The counterpart of ``vaesne_tpu/utils/profiling.py``: per-step wall timing
with the first (warm-up) steps excluded, a throughput summary, a context
manager around a ``torch.profiler`` trace, and a sync that reads a value of
the result.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


@dataclass
class StepTimer:
    """Accumulates per-step wall times; the first ``skip`` steps (warm-up:
    the kernels' build, cuBLAS and the allocator) are excluded from the
    summary statistics."""

    skip: int = 1
    times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def steady(self) -> List[float]:
        return self.times[self.skip:]

    def summary(self, items_per_step: Optional[int] = None) -> dict:
        steady = self.steady or self.times
        mean = sum(steady) / max(len(steady), 1)
        out = {
            "steps": len(self.times),
            "mean_s": mean,
            "min_s": min(steady, default=0.0),
            "max_s": max(steady, default=0.0),
        }
        if items_per_step and mean > 0:
            out["items_per_sec"] = items_per_step / mean
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("build/prof"): ...`` records a ``torch.profiler`` trace
    of the host and, where a card is present, the device, written to
    ``log_dir`` as a Chrome trace (open it in Perfetto or TensorBoard)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def honest_sync(x) -> float:
    """Wait for the device by reading a value derived from ``x`` (a tensor
    or a nested tuple or list of tensors): a device-to-host copy of a
    scalar that depends on the computation cannot return before it ends."""
    while isinstance(x, (tuple, list)):
        x = x[0]
    return float(x.reshape(-1)[0])


def timed_steps(step_fn, state, batches, skip: int = 1):
    """Run ``step_fn(state, batch) -> (state, loss)`` over ``batches``, each
    step timed up to the read of its loss (``honest_sync``). Returns (final
    state, losses, StepTimer)."""
    timer = StepTimer(skip=skip)
    losses = []
    for batch in batches:
        with timer:
            state, loss = step_fn(state, batch)
            losses.append(honest_sync(loss))
    return state, losses, timer
