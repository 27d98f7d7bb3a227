"""The port's contrastive two-tower network and its objectives against the
JAX package on the CPU: ``ContraPhotSpec`` (its forward, ``photo_enc`` and
``spectra_enc``, with and without the context self-attention), the
deliberate flux/wavelength swap of the spectra tower, ``neg_info_nce`` and
``mse`` with their gradients, and the bridged shipped contrastive
checkpoint. Dropout is off wherever the packages are compared (they draw
different masks)."""

import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.models as jmodels
from vaesne_tpu import objectives as jobj
from vaesne_tpu_torch import InferenceServer, init_params
from vaesne_tpu_torch import objectives as tobj
from vaesne_tpu_torch.data import multimodal_tuple
from vaesne_tpu_torch.experiments import train_contrastive
from vaesne_tpu_torch.experiments.common import resolve_dataset
from vaesne_tpu_torch.experiments.eval_goldstein import _config_for, _restore
from vaesne_tpu_torch.models import ContraPhotSpec
from vaesne_tpu_torch.utils import to_jax_params
from vaesne_tpu_torch.utils.config import ContrastiveConfig

from torch_parity import (
    INFO_NCE_BATCH,
    PROJECTIONS_FILE,
    export_port_checkpoint,
    jax_params_from,
    jx,
    make_batch,
    tx,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = os.path.join(REPO, "artifacts", "ckpt", "goldstein_contrastive_4-4_proj8")
BRIDGED = os.path.join(REPO, "artifacts", "ckpt_torch", "goldstein_contrastive_4-4_proj8")
TOWER = dict(latent_len=2, latent_dim=2, proj_dim=3, photo_model_dim=16, photo_num_heads=2,
             photo_ff_dim=16, photo_num_layers=2, spec_model_dim=16, spec_num_heads=2,
             spec_ff_dim=16, spec_num_layers=2)


def pair(selfattn=False, dropout=0.0, batch=None, seed=0):
    """(JAX ContraPhotSpec, its flax params, the port's twin in eval mode)
    with the same weights, from a seeded port initialisation."""
    kw = dict(TOWER, selfattn=selfattn, photo_dropout=dropout, spec_dropout=dropout)
    tm = init_params(ContraPhotSpec(**kw), torch.Generator().manual_seed(seed))
    jm = jmodels.ContraPhotSpec(**kw)
    return jm, jax_params_from(tm, jm, jx(batch or make_batch())), tm.eval()


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("selfattn", [False, True])
def test_towers_match_jax(selfattn):
    """The projections and both towers' embeddings within 1e-5 of the
    largest JAX value (fp32 sums in another order), with and without the
    context self-attention, 40 spectral bins and 12 light-curve points."""
    batch = make_batch(B=3, lp=12, ns=40, seed=1)
    jm, variables, tm = pair(selfattn, batch=batch)
    z1_j, z2_j = jm.apply(variables, jx(batch), True)
    with torch.no_grad():
        z1_t, z2_t = tm(tx(batch))
        h1_t, h2_t = tm.photo_enc(tx(batch)[0]), tm.spectra_enc(tx(batch)[1])
    h1_j = jm.apply(variables, jx(batch)[0], method="photo_enc")
    h2_j = jm.apply(variables, jx(batch)[1], method="spectra_enc")
    assert z1_t.shape == (3, TOWER["proj_dim"]) and h2_t.shape == (3, 2, 2)
    for got, want in ((z1_t, z1_j), (z2_t, z2_j), (h1_t, h1_j), (h2_t, h2_j)):
        assert _rel(got.numpy(), want) <= 1e-5


def test_selfattn_spectra_tower_on_the_kernel_path_matches_jax(monkeypatch):
    """A 300-bin spectrum with the context self-attention: its 301x301 grid
    (90,601 points) routes to the fused attention in both packages (the
    port's plain version on the CPU, the JAX Pallas kernel in interpret
    mode); the spectra embedding within 1e-5 of the largest JAX value."""
    monkeypatch.setenv("VAESNE_PALLAS", "1")
    monkeypatch.setenv("VAESNE_PALLAS_INTERPRET", "1")
    batch = make_batch(B=2, lp=12, ns=300, seed=2)
    jm, variables, tm = pair(True, batch=batch)
    with torch.no_grad():
        got = tm.spectra_enc(tx(batch)[1])
    want = jm.apply(variables, jx(batch)[1], method="spectra_enc")
    assert _rel(got.numpy(), want) <= 1e-5


def test_spectra_tower_swaps_flux_and_wavelength():
    """The spectra tower takes (wavelength, flux) in the encoder's (flux,
    wavelength) slots, as the JAX package does on purpose. A port that fed
    them in their named order would give the JAX output of the spectrum
    with the two exchanged, which differs from the JAX output by far more
    than the 1e-5 parity tolerance: so test_towers_match_jax catches it."""
    batch = make_batch(B=3, lp=12, ns=40, seed=3)
    jm, variables, tm = pair(batch=batch)
    flux, wl, phase, mask = batch[1]
    exchanged = (wl, flux, phase, mask)
    want = jm.apply(variables, jx(batch)[1], method="spectra_enc")
    want_exchanged = jm.apply(variables, jx((batch[0], exchanged))[1], method="spectra_enc")
    with torch.no_grad():
        got = tm.spectra_enc(tx(batch)[1])
        got_exchanged = tm.spectra_enc(tx((batch[0], exchanged))[1])
    assert _rel(got.numpy(), want) <= 1e-5
    assert _rel(got_exchanged.numpy(), want_exchanged) <= 1e-5
    # at least 100x the parity tolerance (measured: ~5e-3 at these random weights)
    assert _rel(want_exchanged, want) > 1e-3
    assert _rel(got_exchanged.numpy(), want) > 1e-3


def _grads_close(model, grads_j, scale=1e-4):
    """Every port gradient within ``scale`` of the largest |JAX gradient|
    over all parameters (sums over the batch and the keys in another
    order)."""
    got = dict(jax.tree_util.tree_flatten_with_path(to_jax_params(
        model, {n: p.grad for n, p in model.named_parameters()})["params"])[0])
    want = dict(jax.tree_util.tree_flatten_with_path(grads_j)[0])
    assert got.keys() == want.keys()
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for path, w in want.items():
        np.testing.assert_allclose(got[path], np.asarray(w), rtol=0, atol=scale * top)


class JaxTwoLinear(flax.linen.Module):
    """A two-tower stand-in: a Dense over each modality's flux."""

    @flax.linen.compact
    def __call__(self, x, deterministic=True):
        return (flax.linen.Dense(4, name="photo")(x[0][0]),
                flax.linen.Dense(4, name="spec")(x[1][0]))


class TorchTwoLinear(torch.nn.Module):
    def __init__(self, lp, ns):
        super().__init__()
        self.photo, self.spec = torch.nn.Linear(lp, 4), torch.nn.Linear(ns, 4)

    def forward(self, x, seed=None):
        return self.photo(x[0][0]), self.spec(x[1][0])


@pytest.mark.parametrize("temperature", [0.07, 0.1])
def test_neg_info_nce_and_its_gradient_match_jax(temperature):
    """neg_info_nce in train mode (a seed is still required, as the JAX
    package requires a key): on ContraPhotSpec at dropout 0 the value within
    1e-6 relative; on a two-tower stand-in whose projections differ from
    event to event the value within 1e-6 relative and the gradients within
    1e-4 of the largest |JAX gradient|. (At random weights ContraPhotSpec's
    projections barely depend on the event, the loss sits at ln B, and its
    gradient is the small difference of O(1) terms: fp32 round-off alone
    puts it 3e-4 of its largest entry apart.)"""
    batch = make_batch(B=5, lp=12, ns=40, seed=4)
    jm, variables, tm = pair(batch=batch)
    want = jobj.neg_info_nce(jm, variables, jx(batch), temperature, key=jax.random.PRNGKey(0))
    got = tobj.neg_info_nce(tm.train(), tx(batch), temperature, seed=0)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)

    tm = init_params(TorchTwoLinear(12, 40), torch.Generator().manual_seed(2)).train()
    variables = jax_params_from(tm, JaxTwoLinear(), jx(batch))
    want, grads = jax.value_and_grad(lambda p: jobj.neg_info_nce(
        JaxTwoLinear(), {"params": p}, jx(batch), temperature, key=jax.random.PRNGKey(0)))(
        variables["params"])
    got = tobj.neg_info_nce(tm, tx(batch), temperature, seed=0)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert abs(float(want) + np.log(5)) > 0.1  # away from chance
    _grads_close(tm, grads)


def test_neg_info_nce_defaults_and_seed_rule():
    """The function's default temperature is 0.07 (the drivers pass 0.1);
    train mode without a seed raises, as JAX's does without a key; eval
    mode needs none."""
    batch = make_batch(B=4, seed=5)
    _, _, tm = pair(batch=batch)
    x = tx(batch)
    with torch.no_grad():
        assert tobj.neg_info_nce(tm, x).item() == tobj.neg_info_nce(tm, x, 0.07).item()
        assert tobj.neg_info_nce(tm, x).item() != tobj.neg_info_nce(tm, x, 0.1).item()
        tm.train()
        with pytest.raises(ValueError, match="seed"):
            tobj.neg_info_nce(tm, x)


def test_mse_and_its_gradient_match_jax():
    """mse of an end-to-end head in train mode at dropout 0: the value
    within 1e-6 relative, the gradients within 1e-4 of the largest |JAX
    gradient|."""
    from vaesne_tpu_torch.models import PhotoEnd2EndRegression

    kw = dict(outdim=4, latent_len=2, latent_dim=2, model_dim=16, num_heads=2, ff_dim=16,
              num_layers=2, dropout=0.0, mlp_hidden=(8, 8))
    batch = make_batch(B=5, lp=12, ns=40, seed=6)
    y = np.random.default_rng(6).normal(size=(5, 4)).astype(np.float32)
    tm = init_params(PhotoEnd2EndRegression(**kw), torch.Generator().manual_seed(1)).train()
    jm = jmodels.PhotoEnd2EndRegression(**kw)
    variables = jax_params_from(tm, jm, jx(batch)[0])
    want, grads = jax.value_and_grad(lambda p: jobj.mse(
        jm, {"params": p}, jx(batch)[0], jnp.asarray(y), key=jax.random.PRNGKey(0)))(
        variables["params"])
    got = tobj.mse(tm, tx(batch)[0], torch.from_numpy(y), seed=0)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    _grads_close(tm, grads)
    with pytest.raises(ValueError, match="seed"):
        tobj.mse(tm, tx(batch)[0], torch.from_numpy(y))


def test_the_committed_bridge_is_the_orbax_checkpoint(tmp_path):
    """artifacts/ckpt_torch/goldstein_contrastive_4-4_proj8 is
    export_port_checkpoint of the shipped Orbax checkpoint: the same config
    and the parameters bitwise; the reference projections and InfoNCE
    within 1e-6 of their largest value (XLA on another CPU may sum in
    another order)."""
    export_port_checkpoint(ORBAX, str(tmp_path), "ContrastiveConfig")
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(BRIDGED))
    with open(tmp_path / "config.json") as f, open(os.path.join(BRIDGED, "config.json")) as g:
        assert f.read() == g.read()
    fresh = torch.load(tmp_path / "state.pt", weights_only=True)["model"]
    committed = torch.load(os.path.join(BRIDGED, "state.pt"), weights_only=True)["model"]
    assert fresh.keys() == committed.keys()
    for k in fresh:
        assert torch.equal(fresh[k], committed[k]), k
    new, old = np.load(tmp_path / PROJECTIONS_FILE), np.load(os.path.join(BRIDGED,
                                                                          PROJECTIONS_FILE))
    for k in ("z1", "z2", "info_nce"):
        np.testing.assert_allclose(new[k], old[k], rtol=0, atol=1e-6 * np.abs(old[k]).max())


def test_the_bridged_checkpoint_reproduces_the_jax_projections():
    """The port on the CPU, dropout off, on the 103 test events of the
    default synthetic data: z1 and z2 within 1e-5 of max |z| of the JAX
    package's (jax_projections.npz), and the InfoNCE over batches of 32
    within 1e-5 relative."""
    cfg = _config_for(BRIDGED, ContrastiveConfig)
    model = _restore(BRIDGED, train_contrastive.build_model(cfg)).eval()
    data = resolve_dataset(None, "goldstein")
    x = multimodal_tuple(data, idx=np.asarray(data["testing_idx"]), device="cpu")
    ref = np.load(os.path.join(BRIDGED, PROJECTIONS_FILE))
    with torch.no_grad():
        z1, z2 = model(x)
        ce = [-tobj.neg_info_nce(model, tuple(tuple(t[s:s + INFO_NCE_BATCH] for t in m)
                                              for m in x), cfg.temperature).item()
              for s in range(0, 103 - INFO_NCE_BATCH + 1, INFO_NCE_BATCH)]
    assert z1.shape == (103, cfg.proj_dim) == ref["z1"].shape
    assert _rel(z1.numpy(), ref["z1"]) <= 1e-5 and _rel(z2.numpy(), ref["z2"]) <= 1e-5
    np.testing.assert_allclose(ce, ref["info_nce"], rtol=1e-5)


def test_from_checkpoint_refuses_the_contrastive_checkpoint():
    """InferenceServer serves VAEs: the bridged ContrastiveConfig
    checkpoint is refused with its message, as the JAX package's
    restore_config refuses a mismatched tag."""
    with pytest.raises(ValueError, match="trained as ContrastiveConfig.*no serving"):
        InferenceServer.from_checkpoint(BRIDGED, device="cpu")
