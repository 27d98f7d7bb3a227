#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``vaesne_tpu_torch``) and
one NVIDIA card. The cell (``BENCHMARK.json``) names a configuration and a
traffic mix; the traffic names the driver that runs it. The run builds its
inputs and weights from ``--seed``, warms up (``setup_s``), measures for
``--seconds``, checks what the timed path produced against the plain
reference (``correct``), and prints one JSON object: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled sub-window. Each number compared, with its limit, is printed last
on standard error and under ``checks`` in the result.

It exits with 2, printing no result, without a card, and with 3 where the
JAX package or JAX was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vaesne_tpu")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout, and
    one host thread for the libraries' own thread pools: the host's work
    here is one Python thread driving the card, and idle pool threads that
    spin only take cores from it."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _steal_s() -> float:
    """Seconds all CPUs have had stolen by the hypervisor (``/proc/stat``)."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return float("nan")


def host_report(steal0: float) -> str:
    """The process's CPU seconds (user and system), wall seconds, page
    faults, involuntary context switches and the CPUs' stolen seconds:
    whether a slow run lost its host."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    return (f"benchmark: host cpu {r.ru_utime:.2f} + {r.ru_stime:.2f} s of "
            f"{time.perf_counter() - T_START:.2f} s wall, {r.ru_minflt} minor and "
            f"{r.ru_majflt} major page faults, {r.ru_nivcsw} involuntary switches, "
            f"{_steal_s() - steal0:.2f} s stolen")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """One run of one cell, as a driver sees it."""

    name: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    limits: dict
    torch: object
    device: object
    spans: object
    t_start: float = T_START

    def profile(self):
        from benchmark.trace import Profile

        return Profile(self.torch, self.spans, self.config)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _caches()
    steal0 = _steal_s()
    sys.path.insert(0, str(ROOT))
    from benchmark import core, trace

    spec = core.spec()
    workload, config, traffic, limits = core.cell_files(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"benchmark: the cell needs {workload['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload, args.seed, args.seconds, bool(args.trace), config, traffic,
                limits, torch, torch.device("cuda", 0), core.Spans())
    driver = core.load_module(core.BENCH / "drivers" / f"{traffic['driver']}.py")
    out = driver.run(cell)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result = assemble(spec, args.workload, out, core, trace)
    print(host_report(steal0), file=sys.stderr)
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def assemble(spec: dict, workload: str, out: dict, core, trace) -> dict:
    """The result line: correct, attempted, failed, the metrics, the device,
    (the breakdown), and last the numbers compared beside their limits."""
    checks = out["checks"]
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    prof = out.get("profile")

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    metrics = {}
    if prof is None:
        for m in spec["end_to_end"]:
            if applies(m) and m["name"] in out["metrics"]:
                metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    else:
        wanted = [m for m in spec["per_layer"] if applies(m)]
        values = trace.read_metrics([m["name"] for m in wanted], core.BENCH / "metrics", prof,
                                    core.load_module)
        for m in wanted:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": out["device"]}
    if prof is not None:
        result["device"].update(busy_s=prof.busy_s, window_s=prof.window_s)
        result["breakdown"] = prof.breakdown()
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
