"""The port's own spans over the traced sub-window: what the program's
host did while the card idled, from inside it.

The port records spans while a profiler runs (``vaesne_tpu_torch.utils.
profiling``: ``span``, read back by ``spans()``), each on
``time.perf_counter``, the clock of ``Profile.t0`` and ``t1``, with its
parent span and its attributes. Every reader here takes the spans that
overlap ``[prof.t0, prof.t1]`` and clips them to it; where the port records
no spans (a version without them) each returns None.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple


def window(prof) -> Optional[list]:
    """The port's closed spans that overlap the sub-window, or None where
    the port has no span recorder or recorded nothing."""
    from vaesne_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    spans = [s for s in read() if s.end > prof.t0 and s.start < prof.t1]
    return spans or None


def _seconds(intervals: List[Tuple[float, float]], t0: float, t1: float) -> float:
    """Seconds of the union of ``intervals`` inside [t0, t1]."""
    total, reach = 0.0, t0
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, t1)
        if b > a:
            total += b - a
            reach = b
    return total


def _share(prof, intervals: List[Tuple[float, float]]) -> float:
    return 100.0 * _seconds(intervals, prof.t0, prof.t1) / prof.window_s


def step_host_ms(prof) -> Optional[float]:
    """The median host time of the sub-window's replayed steps, ms: the
    ``train.step`` spans of kind ``replay`` that lie inside it."""
    spans = window(prof)
    steps = [s.end - s.start for s in spans or ()
             if s.name == "train.step" and s.attrs.get("kind") == "replay"
             and s.start >= prof.t0 and s.end <= prof.t1]
    return 1e3 * statistics.median(steps) if steps else None


def epoch_edges(spans) -> List[Tuple[float, float]]:
    """The epochs' edges: from each ``train.loss_read``'s end (or, before
    the first one recorded, the start of time) to the start of the next
    epoch's first ``train.replay``, or on to the end of time where no
    epoch follows. The start, not the end: a replay returns once the
    device's launch queue has room for the graph's kernels, so on the card
    an epoch's first replay, launched into an empty queue, lasts most of a
    device step that is no edge."""
    by_id: Dict[int, object] = {s.id: s for s in spans}

    def epoch_of(s):
        while s is not None and s.name != "train.epoch":
            s = by_id.get(s.parent)
        return s

    firsts: Dict[int, object] = {}
    for s in spans:
        if s.name == "train.replay":
            e = epoch_of(s)
            if e is not None and (e.id not in firsts or s.start < firsts[e.id].start):
                firsts[e.id] = s
    reads = sorted(s.end for s in spans if s.name == "train.loss_read")
    edges, taken = [], set()
    for first in sorted(firsts.values(), key=lambda s: s.start):
        before = [r for r in reads if r <= first.start]
        start = before[-1] if before else float("-inf")
        taken.add(start)
        edges.append((start, first.start))
    edges += [(r, float("inf")) for r in reads if r not in taken]
    return edges


def epoch_edge_pct(prof) -> Optional[float]:
    """The share of the sub-window at the epochs' edges (``epoch_edges``),
    when the card has no step queued: the loss read's return, the callback,
    the augmentation, a save, the next order and the first step's host
    work up to its graph's launch, %."""
    spans = window(prof)
    if spans is None or not any(s.name in ("train.replay", "train.loss_read") for s in spans):
        return None
    return _share(prof, epoch_edges(spans))


def save_pct(prof) -> Optional[float]:
    """The share of the sub-window in ``train.save``, %."""
    spans = window(prof)
    if spans is None:
        return None
    return _share(prof, [(s.start, s.end) for s in spans if s.name == "train.save"])


def suite_host_pct(prof) -> Optional[float]:
    """The share of the sub-window in ``eval.suite`` outside each chunk's
    device stretch, from its ``eval.forward``'s start to its ``eval.wait``'s
    end: the lead-in, the host copies and the next chunk's slicing between
    chunks, the concatenation, unpadding and denormalisation after the
    last, %."""
    spans = window(prof)
    if spans is None:
        return None
    suites = [s for s in spans if s.name == "eval.suite"]
    if not suites:
        return None
    forward: Dict[int, float] = {}
    wait: Dict[int, float] = {}
    for s in spans:
        if s.name == "eval.forward":
            forward[s.parent] = min(forward.get(s.parent, s.start), s.start)
        elif s.name == "eval.wait":
            wait[s.parent] = max(wait.get(s.parent, s.end), s.end)
    device = [(forward[c], wait[c]) for c in forward if c in wait]
    host = 0.0
    for s in suites:
        a, b = max(s.start, prof.t0), min(s.end, prof.t1)
        if b > a:
            host += (b - a) - _seconds(device, a, b)
    return 100.0 * host / prof.window_s
