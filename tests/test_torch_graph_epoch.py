"""The capture-ready epoch of the port (``training.make_scan_epoch``) on the
CPU: the seeds a CUDA graph's replay writes against the seeds the eager
step derives, the seed word of the attention kernels against the int
seed, ``train.scan_epoch`` true and false through ``train_loop``, and the
port's scanned epoch against the JAX package's ``make_scan_epoch``.

On the CPU the capture-ready body runs eagerly at every step; the graph
itself, and its replays, run on the card only (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 17)."""

import jax
import numpy as np
import pytest
import torch

import torch_parity
import vaesne_tpu_torch.ops.attention as attention
from vaesne_tpu import objectives as jobj
from vaesne_tpu import training as jtr
from vaesne_tpu_torch import PhotometricVAE, PhotoSpecMMVAE, SpectraVAE, init_params
from vaesne_tpu_torch import objectives as tobj
from vaesne_tpu_torch import training as ttr
from vaesne_tpu_torch.data import make_goldstein_like
from vaesne_tpu_torch.experiments import train_photospectra
from vaesne_tpu_torch.utils import rng, to_jax_params
from vaesne_tpu_torch.utils.checkpoint import STATE_FILE

from torch_parity import SMALL, fixed_noise, jx, make_batch, make_pair, tx  # noqa: F401

K = 2
# 256 spectrum bins: the decoder's 256x256 self-attention routes to the
# fused attention (plain version here), whose dropout seed is a seed word
NS = 256


def _m_iwae(model, batch, seed):
    return tobj.m_iwae(model, batch, K, seed=seed)


def _model(dropout=0.1):
    kw = dict(SMALL, dropout=dropout)
    return init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                       torch.Generator().manual_seed(0))


def _eager_sites(model, batch):
    """The (kind, seed) of every draw site of one step of the step loop
    (``make_train_step``), in order."""
    opt = ttr.adamw(1e-3)
    state = ttr.TrainState.create(model, opt, device="cpu")
    step = ttr.make_train_step(model, opt, _m_iwae, device="cpu")
    with rng.recording(rng.SeedTape()) as tape:
        step(state, batch)
    assert all(path is None for _, path, _ in tape.sites)  # plain ints
    return [(kind, value) for kind, _, value in tape.sites]


@pytest.mark.parametrize("step_seed", [0, 7, 123456789, 2**31 - 1])
def test_replayed_site_seeds_are_the_eager_steps(monkeypatch, step_seed):
    """The capture-ready step's tape, recorded once at one step seed,
    recomputes for another step seed, site by site, the seed of every
    posterior and dropout generator and every kernel seed word that the
    eager step derives from that seed: no seed is frozen into a graph."""
    batch = tx(make_batch(B=4, lp=12, ns=NS, seed=1))
    model = _model().train()
    opt = ttr.adamw(1e-3)
    state = ttr.TrainState.create(model, opt, device="cpu")
    run = ttr.make_scan_epoch(model, opt, _m_iwae, device="cpu")
    with rng.recording(rng.SeedTape()) as tape:  # one step of the capture-ready epoch
        run(state, batch, torch.Generator().manual_seed(3), 4)
    kinds = [kind for kind, _, _ in tape.sites]
    assert kinds.count("generator") > 1 and kinds.count("word") > 1
    assert all(path for _, path, _ in tape.sites)  # every site derives from the step seed

    monkeypatch.setattr(ttr, "draw_seed", lambda g: step_seed)
    eager = _eager_sites(_model().train(), batch)
    assert [kind for kind, _ in eager] == kinds
    generators, words = tape.values(step_seed)
    assert generators == [v for kind, v in eager if kind == "generator"]
    by_path = dict(zip(tape.paths("word"), words))
    assert [by_path[path] for kind, path, _ in tape.sites if kind == "word"] == \
        [v for kind, v in eager if kind == "word"]
    other = tape.values(step_seed + 1)
    assert all(a != b for a, b in zip(generators + words, other[0] + other[1]))


def test_a_capture_refuses_a_seed_that_does_not_follow_the_step():
    """Under a capture's tape a site whose seed is a plain int (not folded
    from the step's seed) raises rather than freeze it into the graph."""
    tape = rng.SeedTape(generators=[torch.Generator()], words=torch.zeros(1, dtype=torch.int32))
    with rng.recording(tape):
        with pytest.raises(RuntimeError, match="frozen into the CUDA graph"):
            rng.device_generator(5, "cpu")
        with pytest.raises(RuntimeError, match="frozen into the CUDA graph"):
            rng.seed_word(5, "cpu")
        step = rng.StepSeed(5)
        assert rng.device_generator(rng.fold_in(step, 1), "cpu") is tape.generators[0]
        word = rng.seed_word(rng.fold_in(step, 2), "cpu")
        assert word.data_ptr() == tape.words.data_ptr()
        assert rng.seed_word(rng.fold_in(step, 2), "cpu").data_ptr() == word.data_ptr()
    assert tape.values(5) == ([rng.fold_in(5, 1)], [rng.fold_in(5, 2)])


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 7, 2**32 - 1])
def test_seed_word_gives_the_int_seeds_mask(seed):
    """``dropout_keep`` and ``attention_reference`` read the kernels' seed
    word (int32 holding the uint32 seed) bitwise as they read the int."""
    word = rng.seed_word(seed, "cpu")
    assert word.dtype == torch.int32 and word.shape == (1,)
    for bits in (8, 32):
        want = attention.dropout_keep(seed, 3, 2, 70, 50, 0.1, bits=bits)
        assert torch.equal(attention.dropout_keep(word, 3, 2, 70, 50, 0.1, bits=bits), want)
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(3, 70, 16, generator=g) for _ in range(3))
    mask = torch.rand(3, 70, generator=g) < 0.3
    assert torch.equal(attention.attention_reference(q, k, v, mask, 2, 0.1, word),
                       attention.attention_reference(q, k, v, mask, 2, 0.1, seed))


TINY = ["model.latent_len=2", "model.latent_dim=2", "model.model_dim=16", "model.ff_dim=16",
        "model.num_layers=1", "model.num_heads=2"]


def test_train_loop_writes_one_checkpoint_with_and_without_scan_epoch(tmp_path):
    """``train.scan_epoch`` true (the capture-ready epoch) and false (the
    step loop) write bitwise the same checkpoint: parameters, moments,
    step, generator and losses."""
    np.savez(tmp_path / "data.npz", **make_goldstein_like(
        n=24, seed=0, spectrum_bins=NS, photometry_length=16))
    saved = []
    for scan in ("true", "false"):
        root = tmp_path / scan
        train_photospectra.main([f"data={tmp_path / 'data.npz'}", *TINY, "train.batch_size=8",
                                 "train.epochs=2", f"train.scan_epoch={scan}",
                                 f"train.ckpt_dir={root}", f"train.log_dir={root}"],
                                device="cpu")
        ckpt = root / "goldstein_photospec_2-2_K2_beta1.0"
        saved.append((torch.load(ckpt / STATE_FILE, weights_only=True),
                      np.load(ckpt / "losses.npy")))
    (a, losses_a), (b, losses_b) = saved
    assert np.array_equal(losses_a, losses_b) and a["step"] == b["step"] == 4
    assert torch.equal(a["generator"], b["generator"])
    assert a["model"].keys() == b["model"].keys()
    for name in a["model"]:
        assert torch.equal(a["model"][name], b["model"][name]), name
    moments = [(x, y) for sa, sb in zip(a["optimizer"]["state"].values(),
                                        b["optimizer"]["state"].values())
               for x, y in zip(sa.values(), sb.values())]
    assert moments and all(torch.equal(x, y) for x, y in moments)


_NOISE = torch_parity.noise


def _batch_shared_noise(shape):
    """``torch_parity.noise`` drawn for one event and shared by every event
    of the batch (axis 1 of a posterior draw [K, B, L, D]): an event's
    noise does not depend on where the shuffle put it."""
    one = _NOISE(shape[:1] + (1,) + tuple(shape[2:]))
    return np.ascontiguousarray(np.broadcast_to(one, shape))


def test_scan_epoch_tracks_the_jax_scan_epoch(monkeypatch, fixed_noise):
    """Three epochs of the JAX package's ``make_scan_epoch`` and of the
    port's (the capture-ready body), from the same weights, at batch = the
    dataset (each package's shuffle only reorders the one batch), dropout
    0, the posterior noise pinned and shared by the batch's events: the
    epoch losses within rtol 1e-5, and the parameters within 2% of the
    distance they travelled (measured: 0.77%). The two runs differ by fp32
    reduction order alone: the shuffled events sum in another order (m-IWAE
    sums over the batch), and XLA and torch order their other reductions
    differently. An entrywise bound does not hold: Adam moves an entry by
    O(lr) whatever the size of its gradient, so entries whose gradient is
    round-off (the attention key biases, to which softmax is blind; dead
    ReLU units) move by amounts that round-off sets, up to 2.1e-3 here
    against 1e-5 of max |param| = 3.4e-5, as in
    ``test_three_adamw_steps_track_jax``."""
    monkeypatch.setattr(torch_parity, "noise", _batch_shared_noise)
    monkeypatch.setenv("VAESNE_PALLAS", "1")
    monkeypatch.setenv("VAESNE_PALLAS_INTERPRET", "1")
    n = 6
    batch = make_batch(B=n, lp=12, ns=130, seed=4)
    jm, variables, tm = make_pair(dict(SMALL, dropout=0.0), batch)
    first = {p: np.asarray(a).copy()
             for p, a in jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
    opt_j = jtr.adamw(1e-3)
    state_j = jtr.TrainState.create(variables["params"], opt_j, jax.random.PRNGKey(0))
    run_j = jtr.make_scan_epoch(jm, opt_j, lambda m, v, b, k: jobj.m_iwae(
        m, v, b, K, key=k, deterministic=False), accum_reduction="sum")
    opt_t = ttr.adamw(1e-3)
    state_t = ttr.TrainState.create(tm.train(), opt_t, seed=0, device="cpu")
    run_t = ttr.make_scan_epoch(tm, opt_t, _m_iwae, accum_reduction="sum", device="cpu")
    losses_j, losses_t = [], []
    for epoch in range(3):
        state_j, loss = run_j(state_j, jx(batch), jax.random.PRNGKey(10 + epoch), n)
        losses_j.append(loss)
        state_t, loss = run_t(state_t, tx(batch), torch.Generator().manual_seed(10 + epoch), n)
        losses_t.append(loss)
    assert state_t.step == int(state_j.step) == 3
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    got = dict(jax.tree_util.tree_flatten_with_path(to_jax_params(tm)["params"])[0])
    want = {p: np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(state_j.params)[0]}
    assert got.keys() == want.keys()
    err = sum(float(((got[p] - want[p]) ** 2).sum()) for p in want) ** 0.5
    travelled = sum(float(((first[p] - want[p]) ** 2).sum()) for p in want) ** 0.5
    assert err <= 2e-2 * travelled, (err, travelled)
