"""Data-parallel serving and evaluation of the port on gloo ranks on the
CPU, against one process, and the launch's failure modes.

Every rank takes the whole request or test set, runs its events of each
padded bucket or chunk, draws its part of the whole bucket's posterior
noise, and assembles the result; the one process's outputs must come back
within 1e-5."""

import numpy as np
import pytest
import torch

import torch_dp_workers
import vaesne_tpu_torch.parallel.mesh as tmesh
from vaesne_tpu_torch import InferenceServer, PhotometricVAE, PhotoSpecMMVAE, SpectraVAE
from vaesne_tpu_torch import init_params
from vaesne_tpu_torch.data import make_goldstein_like
from vaesne_tpu_torch.evaluation import masking_sweep, mmvae_reconstruction_suite
from vaesne_tpu_torch.experiments import eval_goldstein, train_regression
from vaesne_tpu_torch.parallel import launch, make_mesh, resolve_mesh

from torch_parity import RANKS_DEADLINE, SMALL, make_batch, rank_deadlines, tx  # noqa: F401


def _model():
    return init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **SMALL),
                                       SpectraVAE(**SMALL)]),
                       torch.Generator().manual_seed(1)).eval()


def _close(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_data_parallel_serving_matches_one_process():
    """embed, crossmodal (means and predictive draws), crossmodal_ci and
    reconstruct of 5 events (padded to the bucket of 8, 4 a rank) on two
    ranks: the one process's outputs."""
    photo, spec = make_batch(B=5, lp=12, ns=40, seed=3)
    model = _model()
    server = InferenceServer(model, device="cpu", buckets=(4, 8))

    def g():
        return torch.Generator().manual_seed(11)

    want = {"embed0": server.embed(photo, modality=0),
            "embed1": server.embed(spec, modality=1),
            "crossmodal": server.crossmodal(photo, spec, K=3, generator=g()),
            "predictive": server.crossmodal(photo, spec, K=3, generator=g(), predictive=True),
            "ci": server.crossmodal_ci(photo, spec, K=3, generator=g()),
            "reconstruct": server.reconstruct((photo, spec), K=3, generator=g())}
    got = launch(torch_dp_workers.serve, resolve_mesh("2", device="cpu"), model, photo, spec,
                 3, 11)
    _close(got, want)


def test_a_bucket_must_divide_the_data_axis():
    with pytest.raises(ValueError, match="buckets \\[3\\] not divisible by the mesh data axis"):
        InferenceServer(_model(), mesh=make_mesh(["cpu"] * 2), device="cpu", buckets=(3, 8))
    with pytest.raises(ValueError, match="not a rank of the 2x1 mesh"):
        InferenceServer(_model(), mesh=make_mesh(["cpu"] * 2), device="cpu", buckets=(4, 8))


def test_data_parallel_evaluation_matches_one_process():
    """The reconstruction suite and the masking sweep over 6 test events in
    chunks of 4 (the last padded), 2 events a rank: the one process's
    arrays."""
    test_batch = tx(make_batch(B=6, lp=12, ns=40, seed=4))
    model = _model()
    want = (mmvae_reconstruction_suite(model, test_batch, K=3, chunk_size=4, seed=3,
                                       device="cpu"),
            masking_sweep(model, test_batch, (0.0, 0.5), K=3, chunk_size=4, device="cpu"))
    got = launch(torch_dp_workers.evaluate, resolve_mesh("2", device="cpu"), model, test_batch,
                 3, 4)
    _close(got, want)


def test_eval_goldstein_on_two_ranks_writes_the_one_process_results(tmp_path):
    """``eval_goldstein mesh=2``: chunks of 64 split over two ranks; rank 0
    writes the reconstructions and metrics of ``mesh=none``."""
    npz = tmp_path / "g.npz"
    np.savez(npz, **make_goldstein_like(n=24, seed=0, spectrum_bins=48, photometry_length=12))
    for mesh in ("none", "2"):
        eval_goldstein.main([f"data={npz}", "K=4", f"out={tmp_path / mesh}", f"mesh={mesh}"],
                            device="cpu")
    for name in ("reconstructions.npz", "avg_metrics.npz"):
        one, two = np.load(tmp_path / "none" / name), np.load(tmp_path / "2" / name)
        assert set(one.files) == set(two.files)
        for k in one.files:
            np.testing.assert_allclose(two[k], one[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_a_frozen_backbone_trains_data_parallel(tmp_path):
    """``train_regression`` over a frozen MMVAE backbone on two ranks: the
    one process's losses, the frozen parameters bitwise theirs and outside
    the gradient all-reduce and AdamW (``opt_mask`` is resolved before the
    ranks start)."""
    npz = tmp_path / "g.npz"
    np.savez(npz, **make_goldstein_like(n=40, seed=1, spectrum_bins=48, photometry_length=12))
    argv = [f"data={npz}", "modality=photometry", "backbone=mmvae", "train.batch_size=8",
            "train.epochs=1", f"train.log_dir={tmp_path}"]
    one, one_losses = train_regression.main(argv + ["train.mesh=none",
                                                    f"train.ckpt_dir={tmp_path / 'one'}"],
                                            device="cpu")
    two, two_losses = train_regression.main(argv + ["train.mesh=2",
                                                    f"train.ckpt_dir={tmp_path / 'two'}"],
                                            device="cpu")
    np.testing.assert_allclose(two_losses, one_losses, rtol=2e-4)
    trainable = {id(p) for p in two.trainable_parameters()}
    frozen = [n for n, p in two.model.named_parameters() if id(p) not in trainable]
    assert frozen and len(two.optimizer.state) == len(trainable)
    want = one.model.state_dict()
    assert all(torch.equal(two.model.state_dict()[n], want[n]) for n in frozen)


def test_a_failing_rank_fails_the_launch(monkeypatch):
    """A rank that raises fails the launch; ranks that outrun the launch's
    deadline (``LAUNCH_TIMEOUT``, where one is set) are killed and fail it;
    by default a launch has no deadline and its collectives torch's."""
    assert tmesh.LAUNCH_TIMEOUT == RANKS_DEADLINE  # this module's, set by rank_deadlines
    mesh = make_mesh(["cpu"] * 2)
    with pytest.raises(Exception, match="rank 1 failed"):
        launch(torch_dp_workers.fail_on_rank_one, mesh)
    monkeypatch.setattr(tmesh, "LAUNCH_TIMEOUT", 5.0)
    with pytest.raises(TimeoutError, match="did not finish within 5 s"):
        launch(torch_dp_workers.sleep_forever, mesh)
    monkeypatch.undo()
    assert tmesh.LAUNCH_TIMEOUT is None and tmesh.GROUP_TIMEOUT is None
