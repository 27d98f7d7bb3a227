"""``VAESNE_BF16`` and ``VAESNE_REMAT`` through the port's entry points on
the CPU, against the JAX package under the same environment: every train
driver, the server and the evaluation harness in bf16; remat off against
remat on (a driver epoch against JAX's: ``test_torch_bf16_epoch.py``).

Tolerances: under ``VAESNE_BF16=1`` the JAX package keeps its Dense,
Embed and LayerNorm outputs in bf16, while torch's autocast runs matmuls in
bf16 and keeps LayerNorm, softmax and the reductions in fp32, so the two
round at different places; they are held to each other at 3e-2 relative
(the losses and outputs; the cross-modal decode at 0.15 of its largest
value, as its docstring says), against 1e-5 in fp32."""

import jax
import numpy as np
import pytest
import torch

import vaesne_tpu.evaluation as jeval
import vaesne_tpu_torch.evaluation as teval
import vaesne_tpu_torch.training as ttraining
from vaesne_tpu.serving import InferenceServer as JInferenceServer
from vaesne_tpu_torch import InferenceServer, PhotometricVAE, PhotoSpecMMVAE, SpectraVAE
from vaesne_tpu_torch import init_params
from vaesne_tpu_torch import objectives as tobj
from vaesne_tpu_torch.data import make_goldstein_like, make_ztf_like
from vaesne_tpu_torch.experiments import (
    train_contrastive,
    train_image,
    train_photometry,
    train_photospectra,
    train_regression,
    train_spectra,
    train_ztf_photospect,
    train_ztf_spectra,
)

from torch_parity import SMALL, fixed_noise, jx, make_batch, make_pair  # noqa: F401

BF16_RTOL = 3e-2
CROSSMODAL_ATOL = 0.15  # of max |JAX output|, see test_server_precision_follows_the_environment
TINY = ["model.latent_len=2", "model.latent_dim=2", "model.model_dim=16", "model.ff_dim=16",
        "model.num_layers=1", "model.num_heads=2"]


def _npz(root, kind):
    maker = make_goldstein_like if kind == "goldstein" else make_ztf_like
    path = root / f"{kind}.npz"
    np.savez(path, **maker(n=24, seed=0, spectrum_bins=48, photometry_length=16))
    return [f"data={path}"]


# the eight training drivers: (module, data kind, their own arguments)
DRIVERS = {
    "photospectra": (train_photospectra, "goldstein", TINY + ["train.K=2"]),
    "photometry": (train_photometry, "goldstein", TINY),
    "spectra": (train_spectra, "goldstein", TINY),
    "ztf_photospect": (train_ztf_photospect, "ztf", TINY + ["repeat_factor=1", "train.K=2"]),
    "ztf_spectra": (train_ztf_spectra, "ztf", TINY + ["repeat_factor=1"]),
    "contrastive": (train_contrastive, "goldstein", TINY + ["proj_dim=3"]),
    "image": (train_image, None, TINY + ["img_size=12", "model.model_dim=8",
                                         "model.ff_dim=8"]),
    "regression": (train_regression, "goldstein", ["modality=spec", "backbone=end2end"]),
}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_bf16_reaches_every_train_driver(tmp_path, monkeypatch, name):
    """Each driver's ``main`` under VAESNE_BF16=1 builds its train step in
    bf16 and runs every step under autocast, with no config field; its
    parameters and moments stay fp32 and its losses are finite."""
    monkeypatch.setenv("VAESNE_BF16", "1")
    resolved, autocasts = [], []
    real_resolve, real_autocast = ttraining.resolve_precision, ttraining.autocast

    def resolve(precision):
        resolved.append(real_resolve(precision))
        return resolved[-1]

    def autocast(precision, device=None):
        autocasts.append(precision)
        return real_autocast(precision, device)

    monkeypatch.setattr(ttraining, "resolve_precision", resolve)
    monkeypatch.setattr(ttraining, "autocast", autocast)
    driver, kind, extra = DRIVERS[name]
    argv = [*(_npz(tmp_path, kind) if kind else []), *extra, "train.batch_size=8",
            "train.epochs=1", "train.mesh=none", f"train.ckpt_dir={tmp_path / 'ck'}",
            f"train.log_dir={tmp_path / 'logs'}"]
    state, losses = driver.main(argv, device="cpu")
    assert resolved == ["bf16"] and autocasts and set(autocasts) == {"bf16"}
    assert len(autocasts) == state.step
    assert np.isfinite(losses).all()
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(t.dtype == torch.float32 for s in state.optimizer.state.values()
               for t in s.values() if torch.is_tensor(t) and t.dim() > 0)


def _small_model():
    kw = dict(SMALL, dropout=0.1)
    return init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                       torch.Generator().manual_seed(0))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_remat_off_equals_remat_on(monkeypatch, precision):
    """VAESNE_REMAT=0 builds stacks without rematerialisation; an m-IWAE
    step at dropout 0.1 over a 300-bin spectrum (its self-attention on the
    fused attention's path) gives the loss and every gradient of remat on,
    bitwise on the CPU, in fp32 and under bf16 autocast."""
    batch = make_batch(B=3, lp=12, ns=300, seed=4)
    grads = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("VAESNE_REMAT", flag)
        model = _small_model().train()
        stacks = [m for m in model.modules() if hasattr(m, "remat")]
        assert stacks and all(m.remat == (flag == "1") for m in stacks)
        x = ttraining.to_device(batch, torch.device("cpu"))
        with ttraining.autocast(precision, "cpu"):
            loss = -tobj.m_iwae(model, x, 2, seed=11)
        loss.backward()
        grads[flag] = [loss.detach()] + [p.grad.clone() for p in model.parameters()
                                         if p.grad is not None]
    assert len(grads["1"]) == len(grads["0"]) > 1
    for a, b in zip(grads["1"], grads["0"]):
        assert torch.equal(a, b)


def test_server_precision_follows_the_environment(monkeypatch, fixed_noise):
    """InferenceServer(precision=None) under VAESNE_BF16=1 serves what
    precision="bf16" serves, bitwise, and what the JAX server serves under
    the same environment within BF16_RTOL (embed, and crossmodal at K = 2 on
    pinned draws)."""
    monkeypatch.setenv("VAESNE_BF16", "1")
    batch = make_batch(B=4, lp=12, ns=40, seed=3)
    jm, variables, tm = make_pair(SMALL, batch)
    env = InferenceServer(tm, buckets=(4,), device="cpu")
    pinned = InferenceServer(tm, buckets=(4,), device="cpu", precision="bf16")
    fp32 = InferenceServer(tm, buckets=(4,), device="cpu", precision="fp32")
    jserver = JInferenceServer(jm, variables, buckets=(4,))
    for m, x in enumerate(batch):
        got = env.embed(x, modality=m)
        assert torch.equal(got, pinned.embed(x, modality=m))
        assert not torch.equal(got, fp32.embed(x, modality=m))
        want = np.asarray(jserver.embed(x, modality=m)).astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(want).max())
    got = env.crossmodal(*batch, K=2)
    assert torch.equal(got, pinned.crossmodal(*batch, K=2))
    want = np.asarray(jserver.crossmodal(*batch, K=2, key=jax.random.PRNGKey(0)))
    want = want.astype(np.float32)
    # the cross-modal decode is a small output (max 0.09) made of larger
    # terms: bf16 alone moves the JAX server's 5.1% and the port's 7.3% of
    # max |out| from their fp32 runs, which agree to 2.2e-6; the two bf16
    # runs are 9.5% apart, held at 15%
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=CROSSMODAL_ATOL * np.abs(want).max())


def test_harness_runs_in_bf16_under_the_environment(monkeypatch, fixed_noise):
    """The reconstruction suite and the masking sweep under VAESNE_BF16=1
    against the JAX package's on pinned draws, within BF16_RTOL. The JAX
    harness hands the metrics bfloat16 arrays for the posterior means, the
    normalised cells and the sweep, and float32 for the denormalised cells
    (a bf16 array times a Python float); the port hands float32 throughout,
    holding the bf16 values exactly (numpy has no bfloat16 without ml_dtypes),
    and these are not the fp32 run's."""
    monkeypatch.setenv("VAESNE_BF16", "1")
    batch = make_batch(B=5, lp=12, ns=40, seed=8)
    jm, variables, tm = make_pair(SMALL, batch)
    norm = {"flux_mean": 1.0, "flux_std": 2.0, "photoflux_mean": 0.5, "photoflux_std": 3.0}
    want = jeval.mmvae_reconstruction_suite(jm, variables, jx(batch), K=2,
                                            chunk_size=2, key=jax.random.PRNGKey(0), norm=norm)
    got = teval.mmvae_reconstruction_suite(tm, batch, K=2, chunk_size=2, seed=0, norm=norm,
                                           device="cpu")
    monkeypatch.setenv("VAESNE_BF16", "0")
    fp32 = teval.mmvae_reconstruction_suite(tm, batch, K=2, chunk_size=2, seed=0, norm=norm,
                                            device="cpu")
    monkeypatch.setenv("VAESNE_BF16", "1")
    assert {k: str(v.dtype) for k, v in want.items()} == {
        "LC2LC": "float32", "LC2spec": "float32", "spec2LC": "float32",
        "spec2spec": "float32", "LCencode": "bfloat16", "specencode": "bfloat16"}
    assert got.keys() == want.keys()
    for key, value in got.items():
        ref = want[key].astype(np.float32)
        assert value.dtype == np.float32 and value.shape == ref.shape, key
        np.testing.assert_allclose(value, ref, rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(ref).max(), err_msg=key)
        assert not np.array_equal(value, fp32[key]), key
    bf16 = torch.from_numpy(got["LCencode"]).bfloat16().float().numpy()
    np.testing.assert_array_equal(got["LCencode"], bf16)
    jsweep = jeval.masking_sweep(jm, variables, jx(batch), missing_portions=(0.5,),
                                 K=2, chunk_size=2, key=jax.random.PRNGKey(1))
    tsweep = teval.masking_sweep(tm, batch, missing_portions=(0.5,), K=2, chunk_size=2, seed=1,
                                 device="cpu")
    assert str(jsweep[0.5].dtype) == "bfloat16" and tsweep[0.5].dtype == np.float32
    assert tsweep[0.5].shape == jsweep[0.5].shape
