"""The port's spans (``utils.profiling.span``) on the CPU: nothing recorded
without a profiler; under one, the trainer's and the evaluation harness's
spans in the expected numbers and nesting, each a profiler annotation of
the Chrome trace, and a run that is bitwise the run without them."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vaesne_tpu_torch import objectives as tobj
from vaesne_tpu_torch.data import augment_multimodal, make_goldstein_like, multimodal_tuple
from vaesne_tpu_torch.evaluation import mmvae_reconstruction_suite
from vaesne_tpu_torch.experiments import common, train_photospectra
from vaesne_tpu_torch.ops import counters
from vaesne_tpu_torch.utils import config as tcfg
from vaesne_tpu_torch.utils import profiling

TINY = ["model.latent_len=2", "model.latent_dim=2", "model.model_dim=16", "model.ff_dim=16",
        "model.num_layers=1", "model.num_heads=2"]
EPOCHS, EVENTS, BATCH = 2, 12, 4
STEPS = EVENTS // BATCH
CHUNKS, CHUNK = 3, 2
COPIES = 6  # the suite's outputs a chunk: four reconstructions and two posterior means


def _train(tmp_path):
    cfg = tcfg.parse_overrides(tcfg.PhotoSpectraMMVAEConfig(), TINY + [
        f"train.batch_size={BATCH}", f"train.epochs={EPOCHS}", "train.save_every=1",
        f"train.ckpt_dir={tmp_path}", f"train.log_dir={tmp_path}"])
    data = make_goldstein_like(n=EVENTS, seed=0, spectrum_bins=24, photometry_length=8)
    state, losses = common.train_loop(
        train_photospectra.build_model(cfg), multimodal_tuple(data, device="cpu"),
        tobj.as_loss(tobj.m_iwae, K=2), cfg.train, augment_fn=augment_multimodal, log=False,
        device="cpu")
    return state, losses


def _suite(model):
    data = make_goldstein_like(n=CHUNKS * CHUNK - 1, seed=1, spectrum_bins=24,
                               photometry_length=8)  # the last chunk padded
    return mmvae_reconstruction_suite(model, multimodal_tuple(data, device="cpu"), K=3,
                                      chunk_size=CHUNK, seed=5, device="cpu")


def _run_both(tmp_path):
    state, losses = _train(tmp_path)
    recs = _suite(state.model)
    return state, losses, recs


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The spans and the Chrome trace's annotations of one profiled run,
    and its losses, parameters and reconstructions."""
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, losses, recs = _run_both(tmp_path_factory.mktemp("traced"))
    records = profiling.spans()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotations = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    profiling.clear_spans()
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    return records, annotations, losses, params, recs


def _named(records, name):
    return [r for r in records if r.name == name]


def test_nothing_is_recorded_without_a_profiler(tmp_path):
    profiling.clear_spans()
    _run_both(tmp_path)
    assert profiling.spans() == []


def test_training_spans_and_their_nesting(traced):
    records = traced[0]
    by_id = {r.id: r for r in records}
    epochs = _named(records, "train.epoch")
    assert [r.attrs["epoch"] for r in epochs] == list(range(EPOCHS))
    assert all(r.parent is None for r in epochs)
    steps = sorted(_named(records, "train.step"), key=lambda r: r.start)
    assert [r.attrs["kind"] for r in steps] == ["warm_up"] + ["eager"] * (EPOCHS * STEPS - 1)
    assert all(by_id[r.parent].name == "train.epoch" for r in steps)
    for name in ("train.order", "train.loss_read"):
        assert len(_named(records, name)) == EPOCHS
        assert all(by_id[r.parent].name == "train.epoch" for r in _named(records, name))
    gathers = _named(records, "train.gather")
    assert len(gathers) == EPOCHS * STEPS
    assert all(by_id[r.parent].name == "train.step" for r in gathers)
    # the CPU runs the step eagerly: no graph to re-seed or replay
    assert not {"train.reseed", "train.replay", "train.collective"} & {r.name for r in records}
    for name in ("train.augment", "train.save"):  # a save every epoch
        assert [r.attrs["epoch"] for r in _named(records, name)] == list(range(EPOCHS))
        assert all(r.parent is None for r in _named(records, name))


def test_evaluation_spans_and_their_nesting(traced):
    records = traced[0]
    by_id = {r.id: r for r in records}
    (suite,) = _named(records, "eval.suite")
    assert suite.attrs == {"seed": 5} and suite.parent is None
    chunks = _named(records, "eval.chunk")
    assert sorted(r.attrs["index"] for r in chunks) == list(range(CHUNKS))
    assert all(r.parent == suite.id for r in chunks)
    for name, count in (("eval.forward", 1), ("eval.wait", 1), ("eval.host_copy", COPIES)):
        children = _named(records, name)
        assert len(children) == CHUNKS * count, name
        assert sorted(by_id[r.parent].attrs["index"] for r in children) == sorted(
            list(range(CHUNKS)) * count), name
    assert _named(records, "eval.metrics") == []  # the suite alone computes no metric


def test_every_span_is_an_annotation_inside_its_parent(traced):
    records, annotations = traced[:2]
    assert {r.name for r in records} <= annotations
    by_id = {r.id: r for r in records}
    for r in records:
        assert r.start <= r.end
        if r.parent is not None:
            parent = by_id[r.parent]
            assert parent.start <= r.start and r.end <= parent.end, (r, parent)


def test_the_profiler_changes_no_number(traced, tmp_path):
    _, _, losses, params, recs = traced
    state, plain_losses, plain_recs = _run_both(tmp_path)
    assert plain_losses == losses
    for name, p in state.model.state_dict().items():
        assert torch.equal(p, params[name]), name
    assert plain_recs.keys() == recs.keys()
    for k in recs:
        np.testing.assert_array_equal(plain_recs[k], recs[k], err_msg=k)


def test_the_metrics_span(traced):
    from vaesne_tpu_torch.evaluation import evaluate_mmvae

    recs = traced[4]
    phase = np.linspace(-10.0, 30.0, recs["LC2spec"].shape[1])
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        evaluate_mmvae(None, None, phase, recs["LC2spec"][0], recs=recs)
    assert [r.name for r in profiling.spans()] == ["eval.metrics"]
    profiling.clear_spans()


def test_the_store_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_done", profiling.collections.deque(maxlen=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.span("s", index=i):
                pass
    assert [r.attrs["index"] for r in profiling.spans()] == [2, 3, 4]


def test_set_adds_attributes_and_is_a_no_op_without_a_profiler():
    profiling.clear_spans()
    with profiling.span("s") as s:
        s.set(kind="x")
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("s", a=1) as s:
            s.set(kind="x")
    (r,) = profiling.spans()
    assert r.attrs == {"a": 1, "kind": "x"}
    profiling.clear_spans()


def test_captures_is_a_counter_beside_the_launches():
    counts = counters.launch_counts()
    assert counts["captures"] == counters.captures
    counters.add_launch_counts({"captures": 1})
    try:
        assert counters.launch_counts()["captures"] == counts["captures"] + 1
        # a replay adds the launches its capture recorded, in which captures stood still
        replay = {name: 0 for name in counts}
        counters.add_launch_counts(replay)
        assert counters.launch_counts()["captures"] == counts["captures"] + 1
    finally:
        counters.set_launch_counts({"captures": counts["captures"]})
