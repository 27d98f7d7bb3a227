"""The traced sub-window of a ``--trace 1`` run: torch.profiler over a few
steady units of work, reduced to what the per-layer metrics read.

``Profile.start`` and ``stop`` bracket the sub-window (each after a device
synchronise). The profiler's trace gives every device operation (kernels,
copies, fills) with its time; the union of their intervals is the busy
time. The benchmark's spans (``core.Spans``) are profiler annotations too,
so each idle gap between device operations is named by the innermost span
the host was in at its middle.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Profile:
    """What the per-layer metrics read: the sub-window's wall (``window_s``),
    the device's busy seconds, the kernels' seconds and counts by name, the
    benchmark's spans, the launch counters' deltas and the driver's account
    of the work completed (``work``)."""

    def __init__(self, torch, spans, config: dict):
        self.torch, self.spans, self.config = torch, spans, config
        self.window_s = self.busy_s = 0.0
        self.kernels: Dict[str, Tuple[float, int]] = {}
        self.counters: Dict[str, int] = {}
        self.work: dict = {}
        self.gaps: List[Tuple[str, float]] = []
        self.t0 = self.t1 = 0.0
        self._prof = None
        self._before: Dict[str, int] = {}

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        from vaesne_tpu_torch.ops import counters

        self.torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.torch.cuda.synchronize()
        self._before = counters.launch_counts()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        from vaesne_tpu_torch.ops import counters

        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        after = counters.launch_counts()
        self.counters = {k: after[k] - self._before[k] for k in after}
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self._prof = None
        self._reduce(events)
        self.window_s = self.t1 - self.t0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _reduce(self, events: list) -> None:
        device, spans = [], []
        totals = defaultdict(lambda: [0.0, 0])
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                ts, dur = float(e["ts"]), float(e["dur"])
                device.append((ts, ts + dur))
                t = totals[e.get("name", "?")]
                t[0] += dur * 1e-6
                t[1] += 1
            elif cat == "user_annotation" and str(e.get("name", "")).startswith("bench."):
                ts = float(e["ts"])
                spans.append((e["name"], ts, ts + float(e["dur"])))
        self.kernels = {k: (v[0], v[1]) for k, v in totals.items()}
        device.sort()
        merged: List[List[float]] = []
        for a, b in device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        gaps = defaultdict(float)
        for (_, end), (start, _) in zip(merged, merged[1:]):
            mid = 0.5 * (end + start)
            inside = [s for s in spans if s[1] <= mid <= s[2]]
            label = min(inside, key=lambda s: s[2] - s[1])[0] if inside else "outside spans"
            gaps[label] += (start - end) * 1e-6
        self.gaps = sorted(gaps.items(), key=lambda kv: -kv[1])

    def kernel_seconds(self, *names: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name contains
        any of ``names``."""
        s = n = 0
        for k, (sec, cnt) in self.kernels.items():
            if any(x in k for x in names):
                s += sec
                n += cnt
        return s, n

    def span_seconds(self, name: str) -> float:
        return self.spans.total(name, self.t0, self.t1)

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        return {"device_ops": [[k[:200], v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps[:TOP]]}


def read_metrics(names, metrics_dir, prof: Profile, load_module) -> Dict[str, Optional[float]]:
    """Each per-layer metric's reader (``metrics/<name>.py``: ``read(prof)``)
    over the profile; a reader that finds nothing to read returns None."""
    out = {}
    for name in names:
        value = load_module(metrics_dir / f"{name}.py").read(prof)
        if value is not None:
            out[name] = value
    return out


def window_share(prof: Profile, span: str) -> float:
    """The share of the sub-window's wall spent in ``span``, %."""
    return 100.0 * prof.span_seconds(span) / prof.window_s


def busy_share(prof: Profile, *names: str) -> Optional[float]:
    """The named kernels' share of the device's busy time, %."""
    seconds, _ = prof.kernel_seconds(*names)
    return 100.0 * seconds / prof.busy_s if prof.busy_s > 0 else None


def idle_pct(prof: Profile) -> float:
    return 100.0 * max(0.0, 1.0 - prof.busy_s / prof.window_s)


def mfu_pct(prof: Profile) -> Optional[float]:
    """The model FLOPs completed in the sub-window over its wall time times
    the peak of the work's precision, %."""
    from benchmark import counts

    flops = prof.work.get("flops")
    if not flops:
        return None
    return 100.0 * flops / (prof.window_s * counts.PEAK_FLOPS[prof.work["dtype"]])


def roofline_pct(prof: Profile, kernel: str, *names: str) -> Optional[float]:
    """The kernel's bound over its device time, %: the least time of every
    launch the dispatch rule predicts in the sub-window (the launch counters
    agreeing), over the time of the kernels named ``names``."""
    from benchmark import counts

    plan = (prof.work.get("launches") or {}).get(kernel)
    seconds, launches = prof.kernel_seconds(*names)
    if not plan or seconds <= 0:
        return None
    s, dtype = counts.shape_of(prof.config), prof.work["dtype"]
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
