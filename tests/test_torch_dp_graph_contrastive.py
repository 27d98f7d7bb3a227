"""The data-parallel graph epoch of InfoNCE (``training.make_scan_epoch``
under a mesh with ``objectives.gathered``'s split, ``training._GatheredStep``)
on two gloo ranks on the CPU: its stages (the towers, the gather's
all-reduce, the head, the gather's backward all-reduce, the towers'
backward, then the gradient all-reduce and the update) against the DDP step
loop (torch's ``DistributedDataParallel`` around the unsplit objective,
``torch_dp_workers.ddp_epoch``) bitwise, with and without the context
self-attention, remat on and off, one and two accumulation steps, and
against the JAX package's scanned epoch on two devices.

On the CPU the stages run eagerly at every step; the graphs and their
replays run on the card only (``chip_smoke.py`` phase 18). The ranks run
``torch_dp_workers`` (torch only) through ``parallel.launch``."""

import jax
import numpy as np
import pytest
import torch

import torch_dp_workers
import torch_parity
from vaesne_tpu import models as jmodels
from vaesne_tpu import objectives as jobj
from vaesne_tpu import training as jtr
from vaesne_tpu.parallel import make_mesh as jax_make_mesh
from vaesne_tpu.parallel import replicate_state as jax_replicate_state
from vaesne_tpu_torch import init_params
from vaesne_tpu_torch.models import ContraPhotSpec
from vaesne_tpu_torch.nn.layers import TransformerStack
from vaesne_tpu_torch.parallel import launch, resolve_mesh
from vaesne_tpu_torch.utils import to_jax_params

from torch_parity import jax_params_from, jx, make_batch, rank_deadlines, tx  # noqa: F401

TOWER = dict(latent_len=2, latent_dim=2, proj_dim=3, photo_model_dim=16, photo_num_heads=2,
             photo_ff_dim=16, photo_num_layers=2, spec_model_dim=16, spec_num_heads=2,
             spec_ff_dim=16, spec_num_layers=2)
# 256 spectrum bins: with the context self-attention the spectra tower's
# 257x257 grid routes to the fused attention (its plain version here), whose
# dropout seed is a rank's shard seed
NS = 256
# (selfattn, remat, accum_steps)
CASES = [(selfattn, remat, accum) for selfattn in (False, True) for remat in (True, False)
         for accum in (1, 2)]
N_JAX = 6  # the JAX comparison's dataset, one batch of 3 events a rank


def _model(selfattn, remat, dropout):
    model = init_params(ContraPhotSpec(**TOWER, selfattn=selfattn, photo_dropout=dropout,
                                       spec_dropout=dropout), torch.Generator().manual_seed(0))
    for stack in model.modules():
        if isinstance(stack, TransformerStack):
            stack.remat = remat
    return model.train()


def _jax_batch():
    """``make_batch`` with both fluxes times 10: at unit fluxes the
    random-init towers give every event nearly one projection, InfoNCE sits
    at ln 6 and its gradient is fp32 round-off (one process of each package
    is then 1.6% of the travelled distance apart, no mesh involved); at 10
    the events' projections differ and the gradient is the objective's."""
    (flux, *photo), (spec, *rest) = make_batch(B=N_JAX, lp=12, ns=40, seed=4)
    return (flux * 10, *photo), (spec * 10, *rest)


def _same_state(a, b):
    """Parameters, AdamW moments, step and generator bitwise equal."""
    assert a["step"] == b["step"] and torch.equal(a["generator"], b["generator"])
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    moments = [(x, y) for sa, sb in zip(a["optimizer"]["state"].values(),
                                        b["optimizer"]["state"].values())
               for x, y in zip(sa.values(), sb.values())]
    assert moments and all(torch.equal(x, y) for x, y in moments)


@pytest.fixture(scope="module")
def ranks():
    """Every case in one launch of two gloo ranks (a launch costs seconds
    of process start-up): two epochs of two steps (8 events a step, 4 a
    rank) at dropout 0.1 for each of CASES, rank 1's parameters first moved
    by 1e-3, and three epochs of the JAX comparison's model at dropout 0."""
    import vaesne_tpu_torch.parallel.mesh as tmesh

    data = tx(make_batch(B=16, lp=12, ns=NS, seed=5))
    models = {case: _model(*case[:2], 0.1) for case in CASES}
    cases = [(models[case], data, 2, 8, case[2], 1e-3) for case in CASES]
    jax_case = (_model(False, True, 0.0), tx(_jax_batch()), 3, N_JAX, 1, 0.0)
    with pytest.MonkeyPatch.context() as mp:  # three times one launch's deadline
        mp.setattr(tmesh, "LAUNCH_TIMEOUT", 3 * torch_parity.RANKS_DEADLINE)
        mp.setattr(tmesh, "GROUP_TIMEOUT", torch_parity.COLLECTIVE_DEADLINE)
        *runs, jax_run = launch(torch_dp_workers.contrastive_scan_epochs,
                                resolve_mesh("2", device="cpu"), [*cases, jax_case])
    return dict(zip(CASES, runs)), models, jax_run


@pytest.mark.parametrize("case", CASES, ids=[
    f"{'selfattn' if s else 'plain'}-remat{int(r)}-accum{a}" for s, r, a in CASES])
def test_the_contrastive_dp_graph_stages_are_the_ddp_step_loop_bitwise(ranks, case):
    """InfoNCE over the global batch at dropout 0.1 on two ranks: the
    graph's stages split at the gather (no step-loop fallback) give the
    DDP step loop's losses, parameters, AdamW moments, step and generator
    bit for bit, and the ranks end equal; with the context self-attention
    the spectra tower's fused attention draws with the ranks' shard seeds,
    under remat its blocks re-run (and draw again) in the towers' backward,
    and at two accumulation steps each microbatch gathers its own events
    and the gradients are reduced once."""
    runs, models, _ = ranks
    out = runs[case]
    (g_losses, g_state, g_ranks, g_reason), (e_losses, e_state, e_ranks, _) = (out[True],
                                                                               out[False])
    assert g_reason is None
    assert g_losses == e_losses and np.isfinite(g_losses).all()
    _same_state(g_state, e_state)
    assert g_state["step"] == 4
    for per_rank in (g_ranks, e_ranks):
        assert all(torch.equal(a, b) for a, b in zip(*per_rank))
    assert all(torch.equal(a, b) for a, b in zip(g_ranks[0], e_ranks[0]))
    start = models[case].state_dict()
    assert all(not torch.equal(g_state["model"][k], start[k]) for k in start)


def test_the_contrastive_dp_graph_epoch_tracks_the_jax_dp_scan_epoch(ranks):
    """Three epochs of the JAX package's ``make_scan_epoch`` of
    ``neg_info_nce`` on a 2-device mesh and of the port's contrastive
    data-parallel graph epoch on two ranks, from the same weights, at
    batch = the dataset (6 events, 3 a rank), dropout 0: the epoch losses
    within rtol 1e-5 and the parameters within 2% of the distance they
    travelled (the shuffles only reorder the one batch, which InfoNCE does
    not see; the two packages order their fp32 sums differently)."""
    batch = _jax_batch()
    kw = dict(TOWER, photo_dropout=0.0, spec_dropout=0.0)
    tm = _model(False, True, 0.0)
    jm = jmodels.ContraPhotSpec(**kw)
    variables = jax_params_from(tm, jm, jx(batch))
    first = {p: np.asarray(a).copy()
             for p, a in jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
    mesh_j = jax_make_mesh(jax.devices()[:2])
    opt_j = jtr.adamw(1e-3)
    state_j = jax_replicate_state(
        jtr.TrainState.create(variables["params"], opt_j, jax.random.PRNGKey(0)), mesh_j)
    run_j = jtr.make_scan_epoch(jm, opt_j, lambda m, v, b, k: jobj.neg_info_nce(
        m, v, b, 0.1, key=k, deterministic=False), mesh=mesh_j)
    losses_j = []
    for epoch in range(3):
        state_j, loss = run_j(state_j, jx(batch), jax.random.PRNGKey(10 + epoch), N_JAX)
        losses_j.append(loss)
    losses_t, state_t, _, reason = ranks[2][True]
    assert reason is None
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
