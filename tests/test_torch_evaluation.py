"""The port's evaluation layer on the CPU, held against the JAX package's:
the metrics bitwise on the same arrays, ``batched_apply``, the
reconstruction suite and the masking sweep on pinned posterior draws, the
eval drivers end to end, and the bridged flagship checkpoint."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import vaesne_tpu.evaluation as jeval
import vaesne_tpu.models as jmodels
import vaesne_tpu_torch.evaluation as teval
import vaesne_tpu_torch.evaluation.harness as harness
import vaesne_tpu_torch.models as tmodels
from vaesne_tpu_torch import InferenceServer, TrainState, adamw
from vaesne_tpu_torch.data import make_goldstein_like
from vaesne_tpu_torch.experiments import eval_goldstein, eval_masking, train_photospectra
from vaesne_tpu_torch.parallel import launch, resolve_mesh
from vaesne_tpu_torch.utils import checkpoint as tck
from vaesne_tpu_torch.utils import fold_in, init_params
from vaesne_tpu_torch.utils.config import PhotoSpectraMMVAEConfig, SpectraVAEConfig

import torch_dp_workers
from torch_parity import (  # noqa: F401
    SMALL,
    export_port_checkpoint,
    fixed_noise,
    jax_params_from,
    jx,
    make_batch,
    make_pair,
    rank_deadlines,
    tx,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = os.path.join(REPO, "artifacts", "ckpt", "goldstein_photospec_4-4_K2_beta1.0")
BRIDGED = os.path.join(REPO, "artifacts", "ckpt_torch", "goldstein_photospec_4-4_K2_beta1.0")

# -- metrics: the port's copy is the JAX module, bit for bit ------------------


def _metric_inputs(nan):
    """K = 100 draws of 9 events × 11 bins, phases around every bucket but
    +30 d (an empty bucket) and off the grid by less than half a day. With
    ``nan`` a tenth of the draws are NaN (the port then takes the JAX
    module's np.nanquantile; without, np.quantile)."""
    rng = np.random.default_rng(0)
    recon = rng.normal(size=(100, 9, 11)).astype(np.float32)
    if nan:
        recon[rng.uniform(size=recon.shape) < 0.1] = np.nan
    gt = rng.normal(size=(9, 11)).astype(np.float32)
    phase = np.array([-10.2, -9.7, 0.3, 0.0, 10.4, 9.8, 20.1, 19.6, 0.2])
    return recon, gt, phase


@pytest.mark.parametrize("nan", [False, True])
def test_metrics_are_the_jax_functions_bitwise(nan):
    recon, gt, phase = _metric_inputs(nan)
    for got, want in zip(teval.get_metric(recon, gt), jeval.get_metric(recon, gt)):
        np.testing.assert_array_equal(got, want)
    resi, cover, width = jeval.get_metric(recon, gt)
    rounded = np.round(phase)
    for got, want in zip(teval.aggr_phase(resi, cover, width, rounded),
                         jeval.aggr_phase(resi, cover, width, rounded)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    sets, gts = {"mm": recon, "speconly": recon[::-1]}, {"mm": gt, "speconly": gt}
    got, want = teval.aggregate_metrics(sets, gts, phase), jeval.aggregate_metrics(sets, gts, phase)
    assert got.keys() == want.keys() and len(got) == 12
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert np.isnan(got["mm_mse"][-1])  # the empty +30 d bucket
    assert not np.isnan(got["mm_width_mean"][-1]).any()  # width over ALL phases
    pred, target, std = recon[0], gt, np.abs(gt[0]) + 0.5
    np.testing.assert_array_equal(teval.regression_abs_error_in_sigma(pred, target, std),
                                  jeval.regression_abs_error_in_sigma(pred, target, std))


# -- batched_apply --------------------------------------------------------------


def test_batched_apply_matches_unchunked_and_unpads():
    # 10 rows, chunks of 4 (pads to 12); mixed output axes are declared
    x = torch.arange(10.0)[:, None] * torch.ones(1, 3)
    seen = []

    def fn(c):
        seen.append(c.clone())
        return {"y": c * 2.0, "k": torch.stack([c, -c])}

    out = teval.batched_apply(fn, x, chunk_size=4, out_axes={"y": 0, "k": 1})
    torch.testing.assert_close(out["y"], x * 2.0)
    assert out["k"].shape == (2, 10, 3)
    torch.testing.assert_close(out["k"][1], -x)
    assert torch.equal(seen[-1][2:], x[[9, 9]])  # padded with the LAST event
    assert teval.batched_apply(fn, x, 4, out_axes={"y": 0, "k": 1}, unpad_to=3)["y"].shape[0] == 3


def test_batched_apply_rejects_a_wrong_declared_axis():
    with pytest.raises(ValueError, match="out_axes declares batch axis"):
        teval.batched_apply(lambda c: torch.ones(7, 7), torch.ones(4, 3), chunk_size=4)


def test_batched_apply_axis_one_equal_to_chunk_size_is_fine():
    out = teval.batched_apply(lambda c: np.stack([c] * 4), np.arange(8.0), chunk_size=4,
                              out_axes=1)
    assert out.shape == (4, 8)
    np.testing.assert_array_equal(out[0], np.arange(8.0))


def test_batched_apply_takes_tuple_data():
    data = (torch.arange(6.0), torch.arange(6.0) + 10.0)
    out = teval.batched_apply(lambda c: c[0] + c[1], data, chunk_size=3)
    torch.testing.assert_close(out, torch.arange(6.0) * 2 + 10.0)


def test_batched_apply_gives_each_chunk_its_own_stream():
    seeds = []

    def fn(c, seed):
        seeds.append(seed)
        return torch.randn(c.shape, generator=torch.Generator().manual_seed(seed))

    x = torch.zeros(8, 5)
    out = teval.batched_apply(fn, x, chunk_size=4, seed=7)
    assert seeds == [fold_in(7, 0), fold_in(7, 1)]
    assert not torch.allclose(out[:4], out[4:])
    assert torch.equal(out, teval.batched_apply(fn, x, chunk_size=4, seed=7))


@pytest.mark.parametrize("mesh", ["2", "2x2", 4])
def test_batched_apply_runs_on_one_device(mesh):
    """The single-device specs resolve to one process; a mesh whose data
    axis divides the chunk runs on the ranks of that mesh and gives the one
    process's result, each rank running its share of every chunk; one that
    does not raises the JAX package's error; outside its ranks a mesh
    raises."""
    data = torch.arange(10.0)
    one = resolve_mesh("1", device="cpu")
    assert teval.batched_apply(lambda c: c, torch.zeros(4), 2, mesh=one).shape == (4,)
    if mesh == 4:
        with pytest.raises(ValueError, match="batch dim 2 not divisible by data axis 4"):
            teval.batched_apply(lambda c: c, torch.zeros(4), 2,
                                mesh=resolve_mesh(str(mesh), device="cpu"))
        return
    with pytest.raises(ValueError, match="not a rank of the"):
        teval.batched_apply(lambda c: c, torch.zeros(4), 2,
                            mesh=resolve_mesh(mesh, device="cpu"))
    want = torch_dp_workers.apply(data, 4)
    got = launch(torch_dp_workers.apply, resolve_mesh(mesh, device="cpu"), data, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- the suite and the sweep against the JAX harness ----------------------------

NORM = {"flux_std": 2.0, "flux_mean": 1.0, "photoflux_std": 3.0, "photoflux_mean": -1.0}


@pytest.fixture(scope="module")
def pair():
    """B = 5 events at SMALL widths: the JAX MMVAE with the port's weights,
    the port's twin, and a spectra VAE pair for the ``speconly`` baseline."""
    batch = make_batch(B=5)
    jm, params, tm = make_pair(SMALL, batch)
    js, ts = jmodels.SpectraVAE(**SMALL), tmodels.SpectraVAE(**SMALL)
    init_params(ts, torch.Generator().manual_seed(1))
    return batch, (jm, params, tm), (js, jax_params_from(ts, js, jx(batch)[1]), ts.eval())


@pytest.mark.parametrize("case", ["raw", "norm", "speconly", "predictive"])
def test_reconstruction_suite_matches_the_jax_suite(pair, fixed_noise, case):
    """Chunks of 2 over 5 events (so the last chunk is padded), K = 3, on
    pinned posterior draws: every key within rtol 1e-4."""
    batch, (jm, jv, tm), (js, jsv, ts) = pair
    kw = dict(K=3, chunk_size=2, norm=NORM if case != "raw" else None,
              predictive=case == "predictive")
    want = jeval.mmvae_reconstruction_suite(
        jm, jv, jx(batch), key=jax.random.PRNGKey(1),
        spec_only=(js, jsv) if case == "speconly" else None, **kw)
    got = teval.mmvae_reconstruction_suite(
        tm, tx(batch), seed=1, spec_only=ts if case == "speconly" else None, device="cpu", **kw)
    assert got.keys() == want.keys()
    assert ("speconly" in got) == (case == "speconly")
    for k in want:
        assert got[k].shape == want[k].shape and isinstance(got[k], np.ndarray), k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_evaluate_mmvae_reuses_recs(pair, monkeypatch):
    batch, (_, _, tm), _ = pair
    recs = teval.mmvae_reconstruction_suite(tm, tx(batch), K=4, chunk_size=2, device="cpu")
    phase = np.array([-10.0, 0.0, 10.0, 20.0, 30.0])
    gt = batch[1][0]
    monkeypatch.setattr(harness, "mmvae_reconstruction_suite", None)  # no second pass
    out = teval.evaluate_mmvae(tm, tx(batch), phase, gt, recs=recs)
    want = teval.aggregate_metrics({"mm": recs["LC2spec"]}, {"mm": gt}, phase)
    assert out.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(out[k], want[k])
    assert out["mm_resi_mean"].shape == (5, gt.shape[1])


def test_masking_sweep_at_zero_is_the_jax_sweep(pair, fixed_noise):
    batch, (jm, jv, tm), _ = pair
    want = jeval.masking_sweep(jm, jv, jx(batch), missing_portions=(0.0,), K=3, chunk_size=2)
    got = teval.masking_sweep(tm, tx(batch), missing_portions=(0.0,), K=3, chunk_size=2,
                              device="cpu")
    assert list(got) == [0.0] and got[0.0].shape == (3, 5, batch[1][0].shape[1])
    np.testing.assert_allclose(got[0.0], np.asarray(want[0.0]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("missing", [0.1, 0.5, 0.9])
def test_masking_flips_only_observed_points_at_the_portion(missing):
    mask = torch.from_numpy(np.random.default_rng(0).uniform(size=(400, 60)) < 0.2)
    photo = (torch.zeros(400, 60), torch.zeros(400, 60), torch.zeros(400, 60, dtype=torch.long),
             mask)
    new = harness.mask_light_curve(photo, missing, seed=3)[3]
    assert bool((new | mask).eq(new).all())  # every masked point stays masked
    flipped = new & ~mask
    n = int((~mask).sum())
    share = int(flipped.sum()) / n
    assert abs(share - missing) <= 4 * (missing * (1 - missing) / n) ** 0.5, share
    assert torch.equal(new, harness.mask_light_curve(photo, missing, seed=3)[3])


def test_masking_sweep_draws_its_flips_from_the_portion_seeds(pair, monkeypatch):
    batch, (_, _, tm), _ = pair
    calls = []
    real = harness.mask_light_curve

    def record(photo, missing, seed):
        calls.append((missing, seed))
        return real(photo, missing, seed)

    monkeypatch.setattr(harness, "mask_light_curve", record)
    out = teval.masking_sweep(tm, tx(batch), missing_portions=(0.0, 0.5), K=2, chunk_size=2,
                              device="cpu")
    assert calls == [(0.0, fold_in(fold_in(42, 0), 0)), (0.5, fold_in(fold_in(42, 1), 0))]
    assert sorted(out) == [0.0, 0.5] and all(np.isfinite(v).all() for v in out.values())


# -- the eval drivers end to end ------------------------------------------------

TINY = ["model.latent_len=2", "model.latent_dim=2", "model.model_dim=16", "model.ff_dim=16",
        "model.num_layers=1", "model.num_heads=2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port checkpoint of a non-default architecture, trained one epoch
    on tiny synthetic data, and that data's npz."""
    root = tmp_path_factory.mktemp("eval")
    npz = root / "g.npz"
    np.savez(npz, **make_goldstein_like(n=24, seed=0, spectrum_bins=48, photometry_length=12))
    train_photospectra.main([f"data={npz}", *TINY, "train.epochs=1", "train.batch_size=8",
                             f"train.ckpt_dir={root}", f"train.log_dir={root / 'logs'}"],
                            device="cpu")
    return str(npz), str(root / "goldstein_photospec_2-2_K2_beta1.0"), root


RECON_KEYS = {"LC2LC", "LC2spec", "spec2LC", "spec2spec", "LCencode", "specencode"}
METRIC_KEYS = {f"mm_{k}" for k in ("resi_mean", "resi_sd", "coverage_mean", "width_mean",
                                   "width_sd", "mse")}


def test_eval_goldstein_end_to_end(trained):
    """The JAX key layout on disk, metrics recomputable from the saved
    reconstructions, and predictive=1 widening the band more than twofold
    (the K draws sample the observed-point likelihood)."""
    npz, ckpt, root = trained
    common = [f"data={npz}", f"mm_ckpt={ckpt}", "K=16", "mesh=none"]
    m_lat = eval_goldstein.main(common + [f"out={root / 'lat'}"], device="cpu")
    m_pred = eval_goldstein.main(common + ["predictive=1", f"out={root / 'pred'}"],
                                 device="cpu")
    recs = np.load(root / "lat" / "reconstructions.npz")
    saved = np.load(root / "lat" / "avg_metrics.npz")
    assert set(recs.files) == RECON_KEYS and set(saved.files) == METRIC_KEYS == set(m_lat)
    n_test = len(np.load(npz)["testing_idx"])
    assert recs["LC2spec"].shape == (16, n_test, 48) and recs["LCencode"].shape == (n_test, 2, 2)
    assert saved["mm_resi_mean"].shape == (5, 48) and saved["mm_mse"].shape == (5,)
    data = np.load(npz)
    te = data["testing_idx"]
    phase = data["phase"][te] * float(data["phase_std"]) + float(data["phase_mean"])
    gt = data["flux"][te] * float(data["flux_std"]) + float(data["flux_mean"])
    again = teval.aggregate_metrics({"mm": recs["LC2spec"]}, {"mm": gt}, phase)
    for k in METRIC_KEYS:
        np.testing.assert_array_equal(saved[k], again[k])
    w_lat = float(np.nanmean(m_lat["mm_width_mean"]))
    w_pred = float(np.nanmean(m_pred["mm_width_mean"]))
    assert w_pred > 2 * w_lat, (w_lat, w_pred)


def test_eval_masking_end_to_end(trained):
    npz, ckpt, root = trained
    mses = eval_masking.main([f"data={npz}", f"mm_ckpt={ckpt}", "K=4", f"out={root / 'mask'}"],
                             device="cpu")
    saved = np.load(root / "mask" / "masking_sweep.npz")
    assert set(saved.files) == {"portions", "mse"}
    np.testing.assert_array_equal(saved["portions"], [0.0, 0.1, 0.3, 0.5, 0.7, 0.9])
    np.testing.assert_array_equal(saved["mse"], [mses[p] for p in saved["portions"]])
    assert np.isfinite(saved["mse"]).all() and (saved["mse"] > 0).all()


def test_config_for_rebuilds_the_trained_architecture(trained):
    _, ckpt, _ = trained
    cfg = eval_goldstein._config_for(ckpt, PhotoSpectraMMVAEConfig)
    assert (cfg.model.latent_len, cfg.model.model_dim, cfg.model.num_layers) == (2, 16, 1)
    model = eval_goldstein._restore(ckpt, train_photospectra.build_model(cfg))
    saved = torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)["model"]
    assert all(torch.equal(v, saved[k]) for k, v in model.state_dict().items())
    with pytest.raises(ValueError, match="trained as"):
        eval_goldstein._config_for(ckpt, SpectraVAEConfig)
    assert eval_goldstein._config_for(None, PhotoSpectraMMVAEConfig) == PhotoSpectraMMVAEConfig()


@pytest.mark.parametrize("driver", [eval_goldstein, eval_masking])
def test_eval_drivers_refuse_what_they_cannot_run(trained, monkeypatch, driver):
    npz, ckpt, root = trained
    argv = [f"data={npz}", "K=2", f"out={root / 'refused'}"]
    with pytest.raises(ValueError, match="not divisible by data axis 3"):
        driver.main(argv + [f"mm_ckpt={ckpt}", "mesh=3"], device="cpu")  # chunks of 64 / 32
    with pytest.raises(ValueError, match="JAX \\(Orbax\\) checkpoint"):
        driver.main(argv + [f"mm_ckpt={ORBAX}"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(argv + [f"mm_ckpt={ckpt}"])
    assert not (root / "refused").exists()


# -- the bridged flagship checkpoint ----------------------------------------------


def test_the_committed_bridge_is_the_orbax_checkpoint(tmp_path):
    """artifacts/ckpt_torch/... is export_port_checkpoint of the shipped
    Orbax checkpoint, parameter for parameter, bitwise; it serves, and a
    run cannot resume from it (its AdamW moments are not bridged)."""
    export_port_checkpoint(ORBAX, str(tmp_path))
    fresh = torch.load(tmp_path / "state.pt", weights_only=True)
    committed = torch.load(os.path.join(BRIDGED, "state.pt"), weights_only=True)
    assert set(fresh) == set(committed) == {"model"}
    assert fresh["model"].keys() == committed["model"].keys()
    for k, v in fresh["model"].items():
        assert torch.equal(v, committed["model"][k]), k
    with open(os.path.join(BRIDGED, "config.json")) as f:
        assert json.load(f) == json.loads((tmp_path / "config.json").read_text())
    server = InferenceServer.from_checkpoint(BRIDGED, buckets=(2,), device="cpu")
    assert type(server._model) is tmodels.PhotoSpecMMVAE
    model = train_photospectra.build_model(PhotoSpectraMMVAEConfig())
    with pytest.raises(ValueError, match="parameters only"):
        tck.restore_checkpoint(BRIDGED, TrainState.create(model, adamw(1e-4), device="cpu"))
