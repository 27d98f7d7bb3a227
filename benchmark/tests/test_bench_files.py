"""The benchmark's files: every cell finds its configuration, traffic,
driver, limits and metrics by name, and every name, unit and key keeps to
the benchmark's format."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = core.spec()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    for path in SPEC["paths"]:
        assert (core.ROOT / path).is_dir()
    assert all(isinstance(w, str) and "\t" not in w for w in SPEC["command"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_are_found_by_name(workload):
    w, config, traffic, limits = core.cell_files(SPEC, workload)
    assert (core.BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
    assert w["chips"] == 1
    assert limits and all(v > 0 for v in limits.values())
    reported = [m for m in SPEC["per_layer"] if workload in m.get("workloads", WORKLOADS)]
    assert reported, "every cell reports a per-layer metric"
    for m in reported:
        module = core.load_module(core.BENCH / "metrics" / f"{m['name']}.py")
        assert callable(module.read)
    e2e = [m["name"] for m in SPEC["end_to_end"] if workload in m.get("workloads", WORKLOADS)]
    assert "setup_s" in e2e and len(e2e) >= 2


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        config = core.load_json(core.ROOT / c["file"])
        assert config["reduced"] == c["reduced"] and config["name"] == c["name"]
        assert config["source"] == c["source"]
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert len(w["why"]) <= 200
        names.append(w["name"])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(len(ls) == 1 for ls in layers.values()), "a metric family names one layer"


def test_share_metrics_say_percent():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
