"""Every training driver of the port on two gloo ranks on the CPU against
one process, InfoNCE's gathered gradients, and the mesh's group and
replication helpers.

Each driver runs through ``main`` at ``train.mesh=2`` and ``train.mesh=none``
at a small size: its loss, augmentation and (for InfoNCE) the projections
gathered from both ranks must give the one process's loss curve, as the
JAX package pins for its drivers (``tests/test_dp_drivers.py``).
"""

import copy

import numpy as np
import pytest
import torch

import torch_dp_workers
from vaesne_tpu_torch import init_params
from vaesne_tpu_torch.data import make_goldstein_like, make_ztf_like
from vaesne_tpu_torch.experiments import (
    train_contrastive,
    train_image,
    train_photospectra,
    train_spectra,
    train_ztf_photospect,
    train_ztf_spectra,
)
from vaesne_tpu_torch.models import ContraPhotSpec
from vaesne_tpu_torch.parallel import launch, resolve_mesh

from torch_parity import make_batch, rank_deadlines  # noqa: F401

TINY = ["model.latent_len=2", "model.latent_dim=2", "model.model_dim=16", "model.ff_dim=16",
        "model.num_layers=1", "model.num_heads=2", "train.batch_size=8", "train.epochs=2"]
TOWER = dict(latent_len=2, latent_dim=2, proj_dim=3, photo_model_dim=16, photo_num_heads=2,
             photo_ff_dim=16, photo_num_layers=1, spec_model_dim=16, spec_num_heads=2,
             spec_ff_dim=16, spec_num_layers=1)

# (driver, its data kind, its own arguments); dropout 0.1 and the driver's
# augmentation stay on in every one
DRIVERS = {
    "photospectra": (train_photospectra, "goldstein", ["train.K=2"]),
    "spectra": (train_spectra, "goldstein", []),
    "ztf_photospect": (train_ztf_photospect, "ztf", ["repeat_factor=1", "train.K=2"]),
    "ztf_spectra": (train_ztf_spectra, "ztf", ["repeat_factor=1"]),
    "contrastive": (train_contrastive, "goldstein", ["proj_dim=3"]),
    "image": (train_image, "image", ["img_size=12", "model.model_dim=8", "model.ff_dim=8",
                                     "train.epochs=1", "aug_factor=1"]),
}


def _data(root, kind):
    if kind == "image":  # the driver's own 512 synthetic images
        return []
    maker = make_goldstein_like if kind == "goldstein" else make_ztf_like
    path = root / f"{kind}.npz"
    np.savez(path, **maker(n=24, seed=0, spectrum_bins=48, photometry_length=16))
    return [f"data={path}"]


@pytest.mark.parametrize("name", list(DRIVERS))
def test_each_driver_trains_data_parallel_as_one_process(tmp_path, name):
    """``main`` at ``train.mesh=2`` against ``train.mesh=none``: the loss
    curves within 2e-4 relative, and the checkpoint rank 0 wrote holds the
    returned parameters."""
    driver, kind, extra = DRIVERS[name]
    argv = [*_data(tmp_path, kind), *TINY, *extra, f"train.log_dir={tmp_path / 'logs'}"]
    one, one_losses = driver.main(argv + ["train.mesh=none", f"train.ckpt_dir={tmp_path / 'one'}"],
                                  device="cpu")
    two, two_losses = driver.main(argv + ["train.mesh=2", f"train.ckpt_dir={tmp_path / 'two'}"],
                                  device="cpu")
    assert np.isfinite(one_losses).all() and two.step == one.step
    np.testing.assert_allclose(two_losses, one_losses, rtol=2e-4)
    (ckpt,) = (tmp_path / "two").iterdir()
    saved = torch.load(ckpt / "state.pt", weights_only=True)["model"]
    assert all(torch.equal(saved[k], v) for k, v in two.model.state_dict().items())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_info_nce_gradients_on_two_ranks_match_one_process(dtype):
    """One InfoNCE step of a two-tower model (dropout 0.1) on 8 events, 4 a
    rank: both projections are gathered from the ranks, and the gradient
    the step applies (the gather's backward, then the mean over the
    ranks) is the one process's. In fp64 within 1e-9 of the largest entry of the whole
    gradient, which only the same function gives. In fp32 the loss within
    1e-5 relative and the gradient within 5e-4 of its largest entry: at
    random weights the loss sits at ln B, the gradient (~2e-2) is what is
    left of terms of order 1/temperature = 14, and fp32 round-off in
    another summation order shows at up to ~1e-4 of it."""
    model = init_params(ContraPhotSpec(**TOWER, photo_dropout=0.1, spec_dropout=0.1),
                        torch.Generator().manual_seed(2))
    batch = make_batch(B=8, lp=12, ns=40, seed=5)
    want_loss, want = torch_dp_workers.info_nce_grads(copy.deepcopy(model), batch, dtype)
    got_loss, got = launch(torch_dp_workers.info_nce_grads, resolve_mesh("2", device="cpu"),
                           model, batch, dtype)
    fp64 = dtype == torch.float64
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-12 if fp64 else 1e-5)
    assert got.keys() == want.keys()
    assert all(g.dtype == dtype for g in got.values())
    scale = max(w.abs().max().item() for w in want.values())
    for k in want:
        assert (got[k] - want[k]).abs().max().item() <= (1e-9 if fp64 else 5e-4) * scale, k


def test_the_groups_and_replication_helpers():
    """On a 2x2 mesh every rank's data group is {m, 2 + m} and its model
    group {2d, 2d + 1} (rank = 2d + m); ``shard_data_parallel`` gives each
    rank its data slice and rank 0's parameters, which differed by rank
    before (each rank checks its own and raises otherwise)."""
    model = init_params(ContraPhotSpec(**TOWER), torch.Generator().manual_seed(3))
    members = launch(torch_dp_workers.groups_and_replication, resolve_mesh("2x2", device="cpu"),
                     model)
    assert members == ([0, 2], [0, 1])
