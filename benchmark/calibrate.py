#!/usr/bin/env python3
"""Readings for the correctness limits of a cell, on the card, and their
judgement under the cell's limits.

    python3 benchmark/calibrate.py --workload <name> --seeds <n> ... \
        [--controls <k>] [--seconds <s>] [--out <file>]
    python3 benchmark/calibrate.py --workload <name> --judge <file>

For every seed it runs the cell once (a short window, the checks as a run
makes them) and keeps each number compared: the program's readings, whose
largest over a dozen seeds or more is a limit's lower reading. For the
first ``--controls`` seeds it also reads the control (the reference in the
program's place, in the precision below the configuration's) and the
faults the cell's driver plants (``controls``), whose smallest reading is
a limit's upper one. Then it judges every reading as a run would
(``run.assemble`` over the cell's limits): each sound run has to come out
correct, and each control and fault not. ``--judge`` judges a file that an
earlier call wrote, under the limits as they are now, without a card. It
exits with 1 where a judgement fails. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def judge(summary: dict, workload: str) -> list:
    """The readings that ``run.assemble`` judges wrongly under the cell's
    limits now: a sound run not correct, a control or fault correct."""
    from benchmark import core, trace
    from benchmark.run import assemble

    spec = core.spec()
    _, _, _, limits = core.cell_files(spec, workload)
    wrong = []
    for row in summary["rows"]:
        for kind, readings in row.items():
            if kind in ("seed", "metrics"):
                continue
            out = {"metrics": {}, "device": {}, "attempted": 0, "failed": 0,
                   "checks": {k: {"value": readings[k], "limit": limits[k]} for k in limits}}
            correct = assemble(spec, workload, out, core, trace)["correct"]
            print(f"calibrate: seed {row['seed']} {kind}: correct {correct}", file=sys.stderr)
            if correct != (kind == "program"):
                wrong.append((row["seed"], kind))
    return wrong


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+")
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    p.add_argument("--judge", default=None, help="a file an earlier call wrote")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.judge:
        wrong = judge(json.loads(Path(args.judge).read_text()), args.workload)
        print(json.dumps({"workload": args.workload, "judged_wrongly": wrong}))
        return 1 if wrong else 0
    from benchmark import core
    from benchmark.run import Cell, _caches

    _caches()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, config, traffic, limits = core.cell_files(core.spec(), args.workload)
    driver = core.load_module(core.BENCH / "drivers" / f"{traffic['driver']}.py")
    rows = []
    for i, seed in enumerate(args.seeds):
        cell = Cell(args.workload, seed, args.seconds, False, config, traffic, limits, torch,
                    torch.device("cuda", 0), core.Spans(), t_start=time.perf_counter())
        out = driver.run(cell)
        readings = out.get("readings") or {k: v["value"] for k, v in out["checks"].items()}
        row = {"seed": seed, "program": readings,
               "metrics": out["metrics"]}
        if i < args.controls:
            row.update(driver.controls(cell))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "card": core.power_limit(), "rows": rows,
               "lower": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]}}
    for kind in {k for r in rows for k in r} - {"seed", "program", "metrics"}:
        got = [r[kind] for r in rows if kind in r]
        summary[f"{kind}_least"] = {k: min(g[k] for g in got) for k in got[0]}
    wrong = judge(summary, args.workload)
    summary["judged_wrongly"] = wrong
    out_path = Path(args.out or ROOT / "build" / "calibrate" / f"{args.workload}.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
