"""The inputs are fixed by the seed: the same seed gives the same data,
weights and checked events; another seed other ones, at the same sizes."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import core, program

EVAL = core.load_module(core.BENCH / "drivers" / "eval_suite.py")
TRAFFIC = core.load_json(core.BENCH / "traffic" / "eval-suite-k100.json")
CONFIG = core.load_json(core.BENCH / "configs" / "flagship-photospec.json")
BIG = 2 ** 31 + 977


def test_checked_events_repeat_per_seed():
    n, chunk, count = 103, TRAFFIC["chunk"], TRAFFIC["check_events"]
    a = EVAL.checked_events(BIG, n, chunk, count)
    assert a == EVAL.checked_events(BIG, n, chunk, count)
    assert a != EVAL.checked_events(BIG + 1, n, chunk, count)
    assert len(a) in (count - 1, count) and (n - 1) // chunk * chunk in a
    assert all(0 <= e < n for e in a)


def test_data_and_weights_repeat_per_seed():
    config = dict(CONFIG, synthetic_events=16)
    a, b = program.data(config, BIG), program.data(config, BIG)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["flux"], program.data(config, BIG + 1)["flux"])
    w1 = program.weights(CONFIG, BIG, torch.device("cpu"))
    w2 = program.weights(CONFIG, BIG, torch.device("cpu"))
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert w1["vaes.1.dec.blocks.block_0.layernorm1.weight"].eq(1).all()


def test_derive_takes_any_whole_seed():
    seeds = {core.derive(s, 1) for s in (0, 1, 2 ** 31, 2 ** 31 + 1, 2 ** 40)}
    assert len(seeds) == 5 and all(0 <= s < 2 ** 31 for s in seeds)
