"""A whole run of each cell on the CPU, the card's look skipped, at a size
the CPU holds: the timed path agrees with the plain reference; with the
timed path broken underneath (a step that leaves the state unchanged,
half of each batch with the mean over the rest, an answer altered where it
is produced) ``correct`` comes out false, as ``run.assemble`` judges it;
the control (the reference at TF32 in the program's place) stands clear
of the program's readings. On the card, at the cells' own sizes, the
control and the faults come out not correct (``calibrate.py``)."""

from __future__ import annotations

import pytest
import torch

from benchmark import core

WORKLOADS = [w["name"] for w in core.spec()["workloads"]]


def driver(cell):
    return core.load_module(core.BENCH / "drivers" / f"{cell.traffic['driver']}.py")


def correct(cell, out) -> bool:
    from benchmark import run, trace

    return run.assemble(core.spec(), cell.name, dict(out, profile=None), core, trace)["correct"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_timed_path_agrees_with_the_reference_and_the_control_does_not(tiny_cell, workload):
    cell = tiny_cell(workload)
    d = driver(cell)
    out = d.run(cell)
    assert correct(cell, out), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(v > 0 for v in out["metrics"].values())
    # at this size the control's gaps are smaller than at the cell's own, where
    # they read over the limits (PERF.md); here they stand well clear of the
    # program's own on some number compared
    sound = out.get("readings") or {k: c["value"] for k, c in out["checks"].items()}
    control = d.controls(cell)["control"]
    assert any(control[k] >= 3 * max(sound[k], 1e-9) for k in cell.limits), (sound, control)


def _unchanged(monkeypatch):
    from vaesne_tpu_torch import training

    monkeypatch.setattr(training, "_clip_and_update", lambda state, optimizer, shard: None)


def _half_batch(monkeypatch):
    from vaesne_tpu_torch import objectives
    from vaesne_tpu_torch.distributions import log_mean_exp

    def half(qz_xs, px_zs, zss, x, scalings, pz):
        lw = objectives.m_iwae_log_weights(qz_xs, px_zs, zss, x, scalings, pz)
        b = lw.shape[1]
        return log_mean_exp(lw[:, :b // 2], axis=0).sum() * (b / (b // 2))

    monkeypatch.setattr(objectives, "m_iwae_terms", half)


def _altered_reconstruction(monkeypatch):
    from vaesne_tpu_torch.models import mmvae

    reconstruct = mmvae.MMVAE.reconstruct
    monkeypatch.setattr(mmvae.MMVAE, "reconstruct", lambda self, *a, **k: [
        [c * 1.01 for c in row] for row in reconstruct(self, *a, **k)])


def _altered_metrics(monkeypatch):
    from vaesne_tpu_torch.evaluation import harness

    aggregate = harness.aggregate_metrics

    def altered(*a, **k):
        out = aggregate(*a, **k)
        out["mm_mse"] = out["mm_mse"] * 1.001
        return out

    monkeypatch.setattr(harness, "aggregate_metrics", altered)


FAULTS = [("flagship-train-b16", _unchanged), ("flagship-train-b16", _half_batch),
          ("ztf-train-k8", _unchanged), ("ztf-train-k8", _half_batch),
          ("flagship-eval-k100", _altered_reconstruction),
          ("flagship-eval-k100", _altered_metrics)]


@pytest.mark.parametrize("workload, fault", FAULTS, ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, workload, fault):
    fault(monkeypatch)
    cell = tiny_cell(workload)
    assert not correct(cell, driver(cell).run(cell))


def test_no_card_means_no_result(monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card, capsys):
    import json

    from benchmark import run

    assert run.main(["--workload", "flagship-eval-k100", "--seed", str(2 ** 31 + 99),
                     "--seconds", "3"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"eval_events_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_and_the_faults_are_not_correct_on_the_card(card, tmp_path, workload):
    from benchmark import calibrate

    assert calibrate.main(["--workload", workload, "--seeds", str(2 ** 31 + 4242),
                           "--controls", "1", "--seconds", "2",
                           "--out", str(tmp_path / "readings.json")]) == 0
