"""The data-parallel graph epoch of the port (``training.make_scan_epoch``
under a mesh) on gloo ranks on the CPU: its three stages (the gradients,
the all-reduce, the update) against the DDP step loop bitwise (torch's
``DistributedDataParallel``, ``torch_dp_workers.ddp_epoch``), against the
JAX package's scanned epoch on two devices, the seeds a replay would write
on each rank against the DDP step's, ``train.scan_epoch`` through a driver
at ``train.mesh=2`` and its resume, the tensor-parallel mesh whose step
runs a collective inside it, which keeps the step loop, and
``train_contrastive``, whose gather the graph splits its step at.

On the CPU the stages run eagerly at every step; the graphs and their
replays run on the card only (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 18). The ranks run ``torch_dp_workers`` (torch
only) through ``parallel.launch``."""

import jax
import numpy as np
import pytest
import torch

import torch_dp_workers
import torch_parity
from vaesne_tpu import objectives as jobj
from vaesne_tpu import training as jtr
from vaesne_tpu.parallel import make_mesh as jax_make_mesh
from vaesne_tpu.parallel import replicate_state as jax_replicate_state
from vaesne_tpu_torch import PhotometricVAE, PhotoSpecMMVAE, SpectraVAE, init_params
from vaesne_tpu_torch.data import make_goldstein_like
from vaesne_tpu_torch.experiments import train_contrastive, train_photometry
from vaesne_tpu_torch.parallel import launch, resolve_mesh
from vaesne_tpu_torch.utils import to_jax_params

from torch_parity import (  # noqa: F401
    SMALL,
    fixed_noise,
    jx,
    make_batch,
    make_pair,
    rank_deadlines,
    tx,
)

K = 2
# 256 spectrum bins: the decoder's 256x256 self-attention routes to the
# fused attention (its plain version here), whose dropout seed is a rank's
# shard seed
NS = 256


def _model(dropout):
    kw = dict(SMALL, dropout=dropout)
    return init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                       torch.Generator().manual_seed(0)).train()


def _same_state(a, b):
    """Parameters, AdamW moments, step and generator bitwise equal."""
    assert a["step"] == b["step"] and torch.equal(a["generator"], b["generator"])
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    moments = [(x, y) for sa, sb in zip(a["optimizer"]["state"].values(),
                                        b["optimizer"]["state"].values())
               for x, y in zip(sa.values(), sb.values())]
    assert moments and all(torch.equal(x, y) for x, y in moments)


# each batch reduction meets both dropout rates and both accumulation
# counts; the last case freezes the photometry VAE, as train_regression
# freezes a backbone
CASES = [(0.0, 1, "sum", None), (0.1, 1, "mean", None), (0.0, 2, "mean", None),
         (0.1, 2, "sum", None), (0.1, 1, "sum", "vaes.0.")]
STEP_SEEDS = (7, 2**31 - 1)
N_JAX = 6  # the JAX comparison's dataset, one batch of 3 events a rank


def _jax_batch():
    return make_batch(B=N_JAX, lp=12, ns=130, seed=4)


@pytest.fixture(scope="module")
def ranks():
    """Every rank program of this file that needs no driver, in one launch
    of two gloo ranks (a launch costs seconds of process start-up): the
    stages against the DDP step loop for each of CASES, the stages on the
    JAX comparison's model and batch with pinned batch-shared noise, and
    the draw sites of one step at STEP_SEEDS."""
    import vaesne_tpu_torch.parallel.mesh as tmesh

    data = tx(make_batch(B=8, lp=12, ns=NS, seed=5))
    models = {dropout: _model(dropout) for dropout in (0.0, 0.1)}
    cases = [(models[dropout], data, 2, 4, K, reduction, accum_steps, False, False, "cpu", 1e-3,
              frozen) for dropout, accum_steps, reduction, frozen in CASES]
    jax_model = make_pair(dict(SMALL, dropout=0.0), _jax_batch())[2].train()
    shared = (jax_model, tx(_jax_batch()), 3, N_JAX, K, "sum", 1, True, True)
    sites = (models[0.1], tx(make_batch(B=4, lp=12, ns=NS, seed=1)), STEP_SEEDS)
    with pytest.MonkeyPatch.context() as mp:  # five times one launch's deadline
        mp.setattr(tmesh, "LAUNCH_TIMEOUT", 5 * torch_parity.RANKS_DEADLINE)
        mp.setattr(tmesh, "GROUP_TIMEOUT", torch_parity.COLLECTIVE_DEADLINE)
        staged, jax_run, site_runs = launch(torch_dp_workers.dp_graph_checks,
                                            resolve_mesh("2", device="cpu"), cases, shared,
                                            sites)
    return dict(zip(CASES, staged)), models, jax_run, site_runs


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_the_dp_graph_stages_are_the_ddp_step_loop_bitwise(ranks, case):
    """Two epochs of two steps on two ranks (4 events a step, 2 a rank),
    m-IWAE with the gradients summed or averaged over the ranks (DDP's comm
    hook or its reducer's 1/n), rank 1's parameters first moved by 1e-3
    (both runs start from rank 0's: DDP's constructor and the graph
    epoch's broadcast): the graph's stages give the DDP step loop's losses,
    parameters, AdamW moments, step and generator bit for bit, and the
    ranks end equal. At dropout 0.1 the decoder's attention draws with the
    ranks' shard seeds; at two accumulation steps each microbatch of the
    global batch is split, and the gradients are reduced once; frozen
    parameters stay out of the reduction and the update, at rank 0's
    values."""
    runs, models, _, _ = ranks
    out, frozen = runs[case], case[3]
    (g_losses, g_state, g_ranks, g_reason), (e_losses, e_state, e_ranks, _) = (out[True],
                                                                               out[False])
    assert g_reason is None
    assert g_losses == e_losses and np.isfinite(g_losses).all()
    _same_state(g_state, e_state)
    assert g_state["step"] == 4
    for per_rank in (g_ranks, e_ranks):
        assert all(torch.equal(a, b) for a, b in zip(*per_rank))
    assert all(torch.equal(a, b) for a, b in zip(g_ranks[0], e_ranks[0]))
    start = models[case[0]].state_dict()
    moved = {k for k in start if not torch.equal(g_state["model"][k], start[k])}
    assert moved
    if frozen:
        assert moved == {k for k in start if not k.startswith(frozen)}, moved


def test_the_dp_graph_epoch_tracks_the_jax_dp_scan_epoch(ranks, monkeypatch, fixed_noise):
    """Three epochs of the JAX package's ``make_scan_epoch`` on a 2-device
    mesh and of the port's data-parallel graph epoch on two ranks, from the
    same weights, at batch = the dataset (6 events, 3 a rank), dropout 0,
    the posterior noise pinned and shared by the batch's events: the epoch
    losses within rtol 1e-5 and the parameters within 2% of the distance
    they travelled, as ``test_torch_graph_epoch`` holds the one-process
    epochs (the shuffles only reorder the one batch; the two packages order
    their fp32 sums differently)."""
    monkeypatch.setattr(torch_parity, "noise", torch_dp_workers.shared_noise)
    monkeypatch.setenv("VAESNE_PALLAS", "1")
    monkeypatch.setenv("VAESNE_PALLAS_INTERPRET", "1")
    batch = _jax_batch()
    jm, variables, tm = make_pair(dict(SMALL, dropout=0.0), batch)
    first = {p: np.asarray(a).copy()
             for p, a in jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
    mesh_j = jax_make_mesh(jax.devices()[:2])
    opt_j = jtr.adamw(1e-3)
    state_j = jax_replicate_state(
        jtr.TrainState.create(variables["params"], opt_j, jax.random.PRNGKey(0)), mesh_j)
    run_j = jtr.make_scan_epoch(jm, opt_j, lambda m, v, b, k: jobj.m_iwae(
        m, v, b, K, key=k, deterministic=False), accum_reduction="sum", mesh=mesh_j)
    losses_j = []
    for epoch in range(3):
        state_j, loss = run_j(state_j, jx(batch), jax.random.PRNGKey(10 + epoch), N_JAX)
        losses_j.append(loss)
    losses_t, state_t, _, _ = ranks[2][True]
    assert state_t["step"] == int(state_j.step) == 3
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    tm.load_state_dict(state_t["model"])
    got = dict(jax.tree_util.tree_flatten_with_path(to_jax_params(tm)["params"])[0])
    want = {p: np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(state_j.params)[0]}
    assert got.keys() == want.keys()
    err = sum(float(((got[p] - want[p]) ** 2).sum()) for p in want) ** 0.5
    travelled = sum(float(((first[p] - want[p]) ** 2).sum()) for p in want) ** 0.5
    assert err <= 2e-2 * travelled, (err, travelled)


def test_a_rank_replay_recomputes_its_shard_seeds(ranks):
    """On each of two ranks, the data-parallel step's tape, recorded once
    at one step seed and recomputed for others, gives site by site the
    (kind, seed) of the DDP step's draw sites at that seed
    (``torch_dp_workers.ddp_train_step``): each posterior
    and dropout generator (the whole step's draw, of which the rank keeps
    its part) and each K1/K2 seed word, the step's seed plus the rank's
    shard offset. Every site keeps its path from the step's seed; rank 1's
    words carry its offset, rank 0's an offset of 0."""
    site_runs = ranks[3]
    for i in range(len(STEP_SEEDS)):
        for r, per_seed in enumerate(site_runs):
            replayed, eager, paths, eager_paths = per_seed[i]
            kinds = [kind for kind, _ in eager]
            assert kinds.count("generator") > 1 and kinds.count("word") > 1, r
            assert replayed == eager, (i, r)
            assert all(paths) and not any(eager_paths), r
            offsets = [path[-1] for path, (kind, _) in zip(paths, eager) if kind == "word"]
            assert all(op == "+" and (k > 0 if r else k == 0) and k % (2 * 1024) == 0
                       for op, k in offsets), (r, offsets)
        assert [v for _, v in site_runs[0][i][1]] != [v for _, v in site_runs[1][i][1]]


TINY = ["model.latent_len=2", "model.num_layers=1", "model.model_dim=16", "model.num_heads=2",
        "model.ff_dim=16", "train.epochs=2", "train.batch_size=8", "train.K=1"]


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("dpgraph") / "g.npz"
    np.savez(path, **make_goldstein_like(n=32, seed=0, spectrum_bins=48, photometry_length=16))
    return path


def _train(driver, npz, root, mesh, *extra):
    return driver.main([f"data={npz}", *TINY, f"train.mesh={mesh}", f"train.ckpt_dir={root}",
                        f"train.log_dir={root}", *extra], device="cpu")


def test_the_driver_writes_one_checkpoint_under_the_dp_graph_and_resumes(npz, tmp_path,
                                                                           capfd):
    """``train_photometry`` at ``train.mesh=2``: two epochs of the step
    loop (``train.scan_epoch=false``: the stages run eagerly) against one
    epoch of the graph's stages (``true``) resumed under the graph to the
    second: the same losses and bitwise the same checkpoint (parameters,
    AdamW moments, step, generator), and no step-loop line. With
    ``test_torch_dp_train.py``'s resume under the graph, the graph's
    uninterrupted run is the step loop's too. The stages are held to the
    DDP step loop bitwise by
    ``test_the_dp_graph_stages_are_the_ddp_step_loop_bitwise``."""
    loop, loop_losses = _train(train_photometry, npz, tmp_path / "loop", "2",
                               "train.scan_epoch=false")
    _train(train_photometry, npz, tmp_path / "graph", "2", "train.epochs=1")
    graph, graph_losses = _train(train_photometry, npz, tmp_path / "graph", "2",
                                 "train.resume=true")
    assert "step loop" not in capfd.readouterr().out
    assert graph_losses == loop_losses and len(loop_losses) == 2
    saved = [torch.load(tmp_path / run / "goldstein_photometry_2-2" / "state.pt",
                        weights_only=True) for run in ("loop", "graph")]
    _same_state(*saved)
    _same_state(graph.state_dict(), loop.state_dict())
    assert saved[0]["step"] == graph.step > 0


@pytest.mark.parametrize("case", ["tensor parallel", "contrastive"])
def test_a_collective_inside_the_step_keeps_the_step_loop(npz, tmp_path, capfd, case):
    """Under a 1x2 mesh the tensor-parallel layers all-reduce inside the
    step: the first step counts those collectives, the later ones run the
    step loop, and the driver prints which collective kept it there.
    ``train_contrastive`` at ``train.mesh=2`` gathers the events for InfoNCE
    inside its step too, but the graph splits the step at the gather and
    runs its all-reduces between the stages: no step-loop line, and one
    epoch resumed under the graph to the second writes bitwise the
    checkpoint of two epochs of the step loop (the stages eagerly), which
    ``test_torch_dp_graph_contrastive.py`` holds to the DDP step loop."""
    if case == "tensor parallel":
        _train(train_photometry, npz, tmp_path, "1x2")
        lines = [line for line in capfd.readouterr().out.splitlines() if "step loop" in line]
        assert len(lines) == 1 and "runs copy_to_model, reduce_from_model inside" in lines[0], lines
        return
    loop, loop_losses = _train(train_contrastive, npz, tmp_path / "loop", "2", "proj_dim=3",
                               "train.scan_epoch=false")
    _train(train_contrastive, npz, tmp_path / "graph", "2", "proj_dim=3", "train.epochs=1")
    graph, graph_losses = _train(train_contrastive, npz, tmp_path / "graph", "2", "proj_dim=3",
                                 "train.resume=true")
    assert "step loop" not in capfd.readouterr().out
    assert graph_losses == loop_losses and len(loop_losses) == 2
    saved = [torch.load(path, weights_only=True) for run in ("loop", "graph")
             for path in (tmp_path / run).glob("goldstein_contrastive_*/state.pt")]
    assert len(saved) == 2
    _same_state(*saved)
    _same_state(graph.state_dict(), loop.state_dict())
    assert saved[0]["step"] == graph.step > 0
