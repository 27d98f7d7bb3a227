"""Lightweight profiling hooks of the port.

The counterpart of ``vaesne_tpu/utils/profiling.py``: per-step wall timing
with the first (warm-up) steps excluded, a throughput summary, a context
manager around a ``torch.profiler`` trace, and a sync that reads a value of
the result.

Beyond it, the port's spans: ``span(name, **attrs)`` marks the host's work
in the trainer (``train.*``: ``training._GraphEpoch``,
``experiments.common.train_loop``) and the evaluation harness (``eval.*``).
A span records only while a ``torch.profiler`` is active (``trace()`` below,
or any profiler a caller runs); otherwise it costs one flag check. A
recorded span is also a profiler annotation (``record_function``), so the
Chrome trace shows it on the device operations' clock, and its record
(``spans()``) keeps its ``time.perf_counter`` interval, its parent span and
its attributes.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_CAPACITY = 1 << 16  # records kept; the oldest drop first


@dataclass(slots=True)
class SpanRecord:
    """One span: ``id``, ``name``, ``start`` and ``end`` on
    ``time.perf_counter`` (``end`` None while it is open), the ``id`` of the
    span open around it when it opened (``parent``, None at the top) and
    its ``attrs`` (small values: an epoch, a step's kind, a chunk index)."""

    id: int
    name: str
    start: float
    end: Optional[float]
    parent: Optional[int]
    attrs: dict


_done: Deque[SpanRecord] = collections.deque(maxlen=SPAN_CAPACITY)
_ids = itertools.count()
_local = threading.local()  # each thread's stack of open spans


class _Span:
    """A span being recorded: its record and its profiler annotation."""

    __slots__ = ("record", "_annotation")

    def __init__(self, name: str, attrs: dict):
        self.record = SpanRecord(next(_ids), name, 0.0, None, None, attrs)
        self._annotation = _autograd_profiler.record_function(name)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.record.parent = stack[-1].id if stack else None
        stack.append(self.record)
        self._annotation.__enter__()
        self.record.start = time.perf_counter()
        return self

    def __exit__(self, kind, value, traceback):
        self.record.end = time.perf_counter()
        self._annotation.__exit__(kind, value, traceback)
        _local.stack.pop()
        _done.append(self.record)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the span's work has run."""
        self.record.attrs.update(attrs)


class _NoSpan:
    """The span of a process with no profiler active: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, traceback):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """``with span("train.step", kind="replay"): ...`` records the block's
    host interval while a ``torch.profiler`` is active, as a record of
    ``spans()`` and a profiler annotation of the same name; with none
    active it is a shared context that records nothing. ``with ... as s``
    gives ``s.set(**attrs)`` for attributes known only at the end."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, attrs)


def spans() -> List[SpanRecord]:
    """The closed spans recorded so far, in the order they closed (a child
    before its parent), at most ``SPAN_CAPACITY`` of the newest."""
    return list(_done)


def clear_spans() -> None:
    """Forget every closed span."""
    _done.clear()


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
