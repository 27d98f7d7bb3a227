"""The readers of the port's own spans (``benchmark/port_spans.py`` and the
per-layer metrics that use it) on hand-made spans and a stub profile,
clipping at the sub-window's edges included."""

from __future__ import annotations

import types

import pytest

from benchmark import core, port_spans


def _prof(t0, t1):
    return types.SimpleNamespace(t0=t0, t1=t1, window_s=t1 - t0)


class _Spans:
    """Hand-made spans: ``add(name, start, end, parent=None, **attrs)``
    returns the record's id."""

    def __init__(self):
        from vaesne_tpu_torch.utils.profiling import SpanRecord

        self.record, self.done = SpanRecord, []

    def add(self, name, start, end, parent=None, **attrs):
        self.done.append(self.record(len(self.done), name, start, end, parent, attrs))
        return len(self.done) - 1


@pytest.fixture
def spans(monkeypatch):
    from vaesne_tpu_torch.utils import profiling

    made = _Spans()
    monkeypatch.setattr(profiling, "spans", lambda: list(made.done))
    return made


def _read(metric, prof):
    return core.load_module(core.BENCH / "metrics" / f"{metric}.py").read(prof)


def _epoch(spans, start, end, replays, read):
    """An epoch of replayed steps: ``replays`` [(start, end)] each under a
    step, then the loss read [read]."""
    e = spans.add("train.epoch", start, end)
    for a, b in replays:
        step = spans.add("train.step", a - 0.1, b + 0.1, e, kind="replay")
        spans.add("train.gather", a - 0.1, a - 0.05, step)
        spans.add("train.replay", a, b, step)
    spans.add("train.loss_read", *read, e)


def test_step_host_ms_is_the_median_replayed_step_inside_the_window(spans):
    e = spans.add("train.epoch", 0.0, 1.0)
    for a, ms in ((0.10, 2.0), (0.20, 4.0), (0.30, 3.0), (0.95, 1.0)):  # the last crosses t1
        spans.add("train.step", a, a + ms * 1e-3 if a < 0.9 else 1.0, e, kind="replay")
    spans.add("train.step", 0.05, 0.09, e, kind="capture")
    assert _read("step_host_ms.train", _prof(0.0, 0.96)) == pytest.approx(3.0)


def test_epoch_edges_from_each_loss_read_to_the_next_first_launch(spans):
    _epoch(spans, 1.0, 9.6, [(2.0, 3.0), (4.0, 5.0)], (8.0, 9.5))  # read before the window
    _epoch(spans, 11.0, 15.0, [(11.5, 12.0), (12.5, 13.0)], (14.0, 14.5))
    spans.add("train.save", 15.0, 15.5)
    _epoch(spans, 16.0, 19.6, [(16.5, 17.0), (17.5, 18.0)], (19.0, 19.5))
    prof = _prof(10.0, 20.0)
    # [10, 11.5] (the window opens at an edge), [14.5, 16.5], [19.5, 20]
    assert _read("epoch_edge_pct.train", prof) == pytest.approx(100.0 * (1.5 + 2.0 + 0.5) / 10.0)
    assert _read("save_pct.train", prof) == pytest.approx(5.0)


def test_an_epoch_s_later_replays_make_no_edge(spans):
    _epoch(spans, 0.0, 4.0, [(0.5, 1.0), (1.5, 2.0), (2.5, 3.0)], (3.5, 3.9))
    # [0, 0.5] and [3.9, 4]
    assert _read("epoch_edge_pct.train", _prof(0.0, 4.0)) == pytest.approx(100.0 * 0.6 / 4.0)


def test_save_pct_clips_at_the_window(spans):
    spans.add("train.save", 5.0, 6.0)   # outside
    spans.add("train.save", 18.0, 21.0)  # 2 s inside
    spans.add("train.augment", 11.0, 12.0)
    assert _read("save_pct.train", _prof(10.0, 20.0)) == pytest.approx(20.0)


def test_suite_host_pct_leaves_out_each_chunk_from_forward_to_wait(spans):
    suite = spans.add("eval.suite", -1.0, 9.0, seed=3)
    for i, (fwd, wait) in enumerate((((-0.5, 2.0), (2.0, 4.0)), ((4.5, 6.0), (6.0, 7.0)))):
        chunk = spans.add("eval.chunk", fwd[0] - 0.1, wait[1] + 0.4, suite, index=i)
        spans.add("eval.forward", *fwd, chunk)
        spans.add("eval.wait", *wait, chunk)
        for k in range(6):
            spans.add("eval.host_copy", wait[1] + 0.05 * k, wait[1] + 0.05 * (k + 1), chunk)
    spans.add("eval.metrics", 9.0, 10.0)
    # the suite's [0, 9] less [0, 4] and [4.5, 7]
    assert _read("suite_host_pct.eval", _prof(0.0, 10.0)) == pytest.approx(25.0)


def test_nothing_to_read(spans, monkeypatch):
    from vaesne_tpu_torch.utils import profiling

    prof = _prof(0.0, 1.0)
    names = ("step_host_ms.train", "epoch_edge_pct.train", "save_pct.train",
             "suite_host_pct.eval")
    assert [_read(n, prof) for n in names] == [None] * 4  # no span recorded
    spans.add("train.augment", 0.2, 0.3)
    assert [_read(n, prof) for n in names] == [None, None, 0.0, None]
    monkeypatch.delattr(profiling, "spans")  # a port without the recorder
    assert [_read(n, prof) for n in names] == [None] * 4


def test_union_of_overlapping_intervals():
    assert port_spans._seconds([(0.0, 2.0), (1.0, 3.0), (5.0, 9.0)], 0.5, 6.0) == \
        pytest.approx(3.5)
