"""Data- and tensor-parallel training of the port on gloo ranks on the CPU,
against one process and against the JAX package on its virtual CPU devices.

The ranks run ``torch_dp_workers`` (torch only) through ``parallel.launch``.
Posterior noise is pinned in both packages (``fixed_noise``; inside each
rank ``torch_dp_workers.pinned_noise``, which draws the whole batch's noise
and keeps the rank's events), so the steps are comparable number for
number.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import torch_dp_workers
from vaesne_tpu import objectives as jobj
from vaesne_tpu import training as jtr
from vaesne_tpu.parallel import make_mesh as jax_make_mesh
from vaesne_tpu.parallel import replicate_state, shard_batch
from vaesne_tpu.parallel import shard_state_tp as jax_shard_state_tp
from vaesne_tpu_torch import PhotometricVAE, PhotoSpecMMVAE, SpectraVAE, init_params
from vaesne_tpu_torch import objectives as tobj
from vaesne_tpu_torch import training as ttr
from vaesne_tpu_torch.data import make_goldstein_like, photometry_tuple
from vaesne_tpu_torch.experiments import train_photometry
from vaesne_tpu_torch.parallel import launch, resolve_mesh

from torch_parity import (  # noqa: F401
    SMALL,
    fixed_noise,
    jx,
    make_batch,
    make_pair,
    rank_deadlines,
)

K, STEPS = 2, 2


def _model(dropout=0.0):
    kw = dict(SMALL, dropout=dropout)
    return init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                       torch.Generator().manual_seed(0))


def _one_process(model, batch, accum_steps=1):
    opt = ttr.adamw(1e-3)
    state = ttr.TrainState.create(model, opt, seed=0, device="cpu")
    step = ttr.make_train_step(model, opt, tobj.as_loss(tobj.m_iwae, K=K), accum_steps, "sum",
                               device="cpu")
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(loss.item())
    return losses, model.state_dict()


def _jax_steps(jm, variables, batch, mesh, tp=False):
    opt = jtr.adamw(1e-3, flatten=not tp)
    state = jtr.TrainState.create(variables["params"], opt, jax.random.PRNGKey(0))
    state = jax_shard_state_tp(state, opt, mesh) if tp else replicate_state(state, mesh)
    step = jtr.make_train_step(jm, opt, lambda m, v, b, k: jobj.m_iwae(
        m, v, b, K, key=k, deterministic=False))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, shard_batch(jx(batch), mesh))
        losses.append(float(loss))
    return losses


def _close_in_travel(got, want, start):
    """The parameters within 2% of the distance they travelled (Adam moves
    an entry whose gradient is ~0 by round-off-sized amounts, differently
    in any two reduction orders; ``test_torch_training`` explains)."""
    err = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    travelled = sum(float(((start[k] - want[k]) ** 2).sum()) for k in want)
    assert err ** 0.5 <= 2e-2 * travelled ** 0.5, (err, travelled)


@pytest.mark.parametrize("dropout,accum_steps", [(0.0, 1), (0.1, 1), (0.0, 2)])
def test_data_parallel_steps_match_one_process_and_jax(fixed_noise, dropout, accum_steps):
    """Two m-IWAE + AdamW steps on two gloo ranks (4 events, 2 a rank)
    against one process: losses within 1e-5 relative, parameters within 2%
    of their travel. At dropout 0.1 the plain path's masks are the one
    process's (each rank keeps its part of the whole step's draw); with two
    accumulation steps each microbatch of the global batch is split. At
    dropout 0, against the JAX package's step on two devices too."""
    batch = make_batch(B=4, lp=12, ns=40, seed=6)
    model = _model(dropout)
    start = copy.deepcopy(model.state_dict())
    want, want_params = _one_process(copy.deepcopy(model), batch, accum_steps)
    got, got_params = launch(torch_dp_workers.train_steps, resolve_mesh("2", device="cpu"),
                             model, batch, STEPS, K, "sum", True, accum_steps)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _close_in_travel(got_params, want_params, start)
    if dropout == 0.0 and accum_steps == 1:
        jm, variables, _ = make_pair(dict(SMALL, dropout=0.0), batch)
        jax_losses = _jax_steps(jm, variables, batch, jax_make_mesh(jax.devices()[:2]))
        np.testing.assert_allclose(got, jax_losses, rtol=1e-5)


def test_tensor_parallel_steps_match_one_process_and_jax(fixed_noise):
    """Two steps on a 2x2 mesh (two event shards, each model's heads and
    FFN split over two ranks, Megatron's all-reduce pair around each
    split) against one process (losses within 1e-5, parameters within 2%
    of their travel) and against the JAX package's 2x2 step with its
    tensor-parallel state (losses within 2e-4, its own bound against one
    device)."""
    batch = make_batch(B=4, lp=12, ns=40, seed=7)
    model = _model()
    start = copy.deepcopy(model.state_dict())
    want, want_params = _one_process(copy.deepcopy(model), batch)
    got, got_params = launch(torch_dp_workers.train_steps, resolve_mesh("2x2", device="cpu"),
                             model, batch, STEPS)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _close_in_travel(got_params, want_params, start)
    jm, variables, _ = make_pair(dict(SMALL, dropout=0.0), batch)
    jax_losses = _jax_steps(jm, variables, batch,
                            jax_make_mesh(jax.devices()[:4], data=2, model=2), tp=True)
    np.testing.assert_allclose(got, jax_losses, rtol=2e-4)


TINY = ["model.latent_len=2", "model.num_layers=1", "model.model_dim=16", "model.num_heads=2",
        "model.ff_dim=16", "train.epochs=2", "train.batch_size=8", "train.K=1"]


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("dp") / "g.npz"
    np.savez(path, **make_goldstein_like(n=32, seed=0, spectrum_bins=48, photometry_length=16))
    return path


def _train(npz, root, mesh, *extra):
    return train_photometry.main([f"data={npz}", *TINY, f"train.mesh={mesh}",
                                  f"train.ckpt_dir={root}", f"train.log_dir={root}", *extra],
                                 device="cpu")


def test_the_driver_trains_data_parallel_as_one_process(npz, tmp_path):
    """``train_photometry`` at ``train.mesh=2`` against ``train.mesh=none``
    (dropout 0.1, augmentation on): the loss curves within 2e-4 and the
    trained models within 1e-3 in function space, as the JAX package pins
    (``tests/test_dp_drivers.py``); rank 0 wrote the checkpoint."""
    one, one_losses = _train(npz, tmp_path / "one", "none")
    dp, dp_losses = _train(npz, tmp_path / "dp", "2")
    np.testing.assert_allclose(dp_losses, one_losses, rtol=2e-4)
    data = np.load(npz)
    batch = photometry_tuple(data, idx=np.arange(8), device="cpu")
    values = [tobj.elbo(state.model.eval(), batch, 1, seed=3).item() for state in (one, dp)]
    np.testing.assert_allclose(values[1], values[0], rtol=1e-3)
    saved = torch.load(tmp_path / "dp" / "goldstein_photometry_2-2" / "state.pt",
                       weights_only=True)
    assert all(torch.equal(saved["model"][k], v) for k, v in dp.model.state_dict().items())


def test_a_data_parallel_resume_is_bitwise(npz, tmp_path):
    """Two ranks for one epoch, stopped, resumed on the same mesh to the
    second: the parameters, AdamW moments and losses of the run that
    never stopped, bit for bit."""
    whole, whole_losses = _train(npz, tmp_path / "whole", "2")
    _train(npz, tmp_path / "split", "2", "train.epochs=1")
    resumed, losses = _train(npz, tmp_path / "split", "2", "train.resume=true")
    assert losses == whole_losses
    a, b = whole.state_dict(), resumed.state_dict()
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    for i, entry in a["optimizer"]["state"].items():
        assert all(torch.equal(t, b["optimizer"]["state"][i][key]) for key, t in entry.items())
