"""The harness's common parts: the benchmark's files found by name, seeds,
the weights, spans, and the device.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix. Each lives in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``, whose ``driver``
names ``drivers/<driver>.py``; each per-layer metric is
``metrics/<name>.py``, and each cell's correctness limits are
``checks/<workload>.json``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MASK64 = (1 << 64) - 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell_files(spec_: dict, workload: str) -> Tuple[dict, dict, dict, dict]:
    """(workload entry, configuration, traffic mix, correctness limits)."""
    w = by_name(spec_["workloads"], workload, "workload")
    c = by_name(spec_["configs"], w["config"], "config")
    return (w, load_json(ROOT / c["file"]), load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
            load_json(BENCH / "checks" / f"{workload}.json"))


def load_module(path: Path):
    """A benchmark file as a module (its name may hold dots)."""
    name = "benchmark_" + path.stem.replace(".", "_").replace("-", "_")
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def _mix64(x: int) -> int:
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & MASK64
    return x ^ (x >> 31)


def derive(seed: int, *path: int) -> int:
    """A seed in [0, 2**31) from any whole ``seed`` and a path of ints."""
    x = _mix64(seed & MASK64)
    for p in path:
        x = _mix64((x + p + 1) & MASK64)
    return x % (1 << 31)


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, "torch.Tensor"]:
    """Initial fp32 weights on the card from ``seed``, in two draws of a
    generator there: Linear weight and bias ~ U(±1/√fan_in), LayerNorm 1
    and 0, embeddings and the bottleneck tokens ~ N(0, 1)."""
    import torch

    names = sorted(shapes)
    uniform = [n for n in names if ".layernorm" not in n and not _is_normal(n)]
    normal = [n for n in names if _is_normal(n)]
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(math.prod(shapes[n]) for n in uniform), generator=g, device=device)
    z = torch.randn(sum(math.prod(shapes[n]) for n in normal), generator=g, device=device)
    out, at = {}, 0
    for n in uniform:
        size = math.prod(shapes[n])
        weight = shapes[n[:-len("bias")] + "weight"] if n.endswith(".bias") else shapes[n]
        bound = 1.0 / math.sqrt(weight[-1])
        out[n] = ((2.0 * u[at:at + size] - 1.0) * bound).view(shapes[n])
        at += size
    at = 0
    for n in normal:
        size = math.prod(shapes[n])
        out[n] = z[at:at + size].view(shapes[n])
        at += size
    for n in names:
        if ".layernorm" in n:
            fill = 1.0 if n.endswith(".weight") else 0.0
            out[n] = torch.full(shapes[n], fill, device=device)
    return out


def _is_normal(name: str) -> bool:
    return name.endswith("initbottleneck") or "bandembd" in name


class Spans:
    """Host intervals around the calls into the program's layers, kept in
    memory: (name, start, end) on ``time.perf_counter``. Each is also a
    profiler annotation, so a traced run sees on the trace's clock what
    the host was doing while the card idled."""

    def __init__(self):
        self.done: List[Tuple[str, float, float]] = []
        self._open: Dict[str, tuple] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        self.open(name)
        try:
            yield
        finally:
            self.close(name)

    def open(self, name: str) -> None:
        from torch.profiler import record_function

        rf = record_function(name)
        rf.__enter__()
        self._open[name] = (time.perf_counter(), rf)

    def close(self, name: str) -> None:
        if name not in self._open:
            return
        t0, rf = self._open.pop(name)
        rf.__exit__(None, None, None)
        self.done.append((name, t0, time.perf_counter()))

    def total(self, name: str, t0: float, t1: float) -> float:
        """Seconds of ``name`` spans inside [t0, t1]."""
        return sum(max(0.0, min(b, t1) - max(a, t0)) for n, a, b in self.done if n == name)


def device_info(torch, device) -> dict:
    """The result's ``device``: the card and its peak allocation so far."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def synchronize(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(torch, device) -> None:
    """Return the program's freed memory to the card before the reference runs."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def relative_gap(a: float, b: float, floor: float = 0.0) -> float:
    """|a − b| over max(|b|, floor)."""
    den = max(abs(b), floor)
    return abs(a - b) / den if den > 0 else (0.0 if a == b else math.inf)
