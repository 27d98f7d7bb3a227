"""The port's five regression heads against the JAX package on the CPU:
their outputs on the same weights, the frozen backbone's missing gradient,
the weight bridge of each head's whole parameter tree (backbone included),
and the profiling helpers. Dropout is off wherever the packages are
compared."""

import jax
import numpy as np
import pytest
import torch

import vaesne_tpu.models as jmodels
from vaesne_tpu.utils import profiling as jprof
from vaesne_tpu_torch import init_params, load_jax_params, to_jax_params
from vaesne_tpu_torch import models as tmodels
from vaesne_tpu_torch.utils import profiling as tprof

from torch_parity import jax_params_from, jx, make_batch, tx

SMALL = dict(latent_len=2, latent_dim=2, model_dim=16, ff_dim=16, num_layers=2, num_heads=2)
TOWER = dict(latent_len=2, latent_dim=2, proj_dim=3, photo_model_dim=16, photo_num_heads=2,
             photo_ff_dim=16, photo_num_layers=2, spec_model_dim=16, spec_num_heads=2,
             spec_ff_dim=16, spec_num_layers=2)
HIDDEN = (8, 8)
HEADS = ["vae_photometry", "vae_spec", "contra_photometry", "contra_spec", "end2end_photometry",
         "end2end_spec"]


def build(pkg, case, dropout=0.0, selfattn=False):
    """The regression head of ``case`` in ``pkg`` (the JAX or the port's
    models module) at SMALL widths, outdim 4."""
    backbone, modality = case.split("_")
    m = int(modality == "spec")
    if backbone == "vae":
        vae = ((pkg.PhotometricVAE(num_bands=6, dropout=dropout, selfattn=selfattn, **SMALL),
                pkg.SpectraVAE(dropout=dropout, selfattn=selfattn, **SMALL))[m])
        return pkg.VAERegressionHead(vae=vae, outdim=4, mlp_hidden=HIDDEN)
    if backbone == "contra":
        net = pkg.ContraPhotSpec(**TOWER, photo_dropout=dropout, spec_dropout=dropout,
                                 selfattn=selfattn)
        cls = (pkg.ContraPhotoRegressionHead, pkg.ContraSpecRegressionHead)[m]
        return cls(contrastnet=net, outdim=4, mlp_hidden=HIDDEN)
    kw = dict(SMALL, dropout=dropout, selfattn=selfattn, mlp_hidden=HIDDEN)
    if m == 0:
        return pkg.PhotoEnd2EndRegression(outdim=4, num_bands=6, **kw)
    return pkg.SpecEnd2EndRegression(outdim=4, **kw)


def head_pair(case, batch, seed=0, **kw):
    """(JAX head, its flax params, the port's twin in eval mode) with the
    same weights, from a seeded port initialisation. The flax tree is the
    one the head's forward initialises (the VAE head's holds no decoder)."""
    tm = init_params(build(tmodels, case, **kw), torch.Generator().manual_seed(seed))
    jm = build(jmodels, case, **kw)
    x = jx(batch)[int(case.endswith("spec"))]
    return jm, jax_params_from(tm, jm, x), tm.eval(), x


@pytest.mark.parametrize("selfattn", [False, True])
@pytest.mark.parametrize("case", HEADS)
def test_heads_match_jax(case, selfattn):
    """Each head's prediction [B, 4] within 1e-5 of the largest JAX value
    (fp32 sums in another order), with and without the context
    self-attention, 40 spectral bins and 12 light-curve points."""
    batch = make_batch(B=3, lp=12, ns=40, seed=7)
    jm, variables, tm, x = head_pair(case, batch, selfattn=selfattn)
    want = np.asarray(jm.apply(variables, x, True))
    with torch.no_grad():
        got = tm(tx(batch)[int(case.endswith("spec"))]).numpy()
    assert got.shape == (3, 4)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_spec_end2end_swaps_flux_and_wavelength():
    """SpecEnd2EndRegression carries the spectra tower's deliberate swap:
    exchanging flux and wavelength in the port's input gives the JAX
    prediction of the exchanged input, and moves the prediction by more than
    ten times the parity tolerance."""
    batch = make_batch(B=3, lp=12, ns=40, seed=8)
    jm, variables, tm, x = head_pair("end2end_spec", batch)
    flux, wl, phase, mask = batch[1]
    exchanged = tx((batch[0], (wl, flux, phase, mask)))[1]
    want = np.asarray(jm.apply(variables, jx((batch[0], (wl, flux, phase, mask)))[1], True))
    with torch.no_grad():
        got, plain = tm(exchanged).numpy(), tm(tx(batch)[1]).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # measured: 7e-4 of the largest value at these random weights
    assert np.abs(got - plain).max() > 10 * 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("case", HEADS[:4])
def test_a_frozen_backbone_takes_no_gradient(case):
    """In train mode with dropout on (the backbone's embedding is computed
    deterministic all the same), the loss's backward reaches every head
    parameter and no backbone parameter, as stop_gradient does in JAX."""
    batch = make_batch(B=3, lp=12, ns=40, seed=9)
    head = init_params(build(tmodels, case, dropout=0.1),
                       torch.Generator().manual_seed(0)).train()
    pred = head(tx(batch)[int(case.endswith("spec"))], seed=3)
    pred.square().sum().backward()
    backbone = "vae" if case.startswith("vae") else "contrastnet"
    for name, p in head.named_parameters():
        if name.startswith(backbone):
            assert p.grad is None, name
        else:
            assert p.grad is not None and p.grad.abs().sum() > 0, name


@pytest.mark.parametrize("case", HEADS[4:])
def test_end2end_heads_train_their_encoder_with_dropout(case):
    """The end-to-end heads train their encoder: every parameter takes a
    gradient, train mode needs a seed, and two seeds give two dropout
    masks."""
    batch = make_batch(B=3, lp=12, ns=40, seed=10)
    head = init_params(build(tmodels, case, dropout=0.1),
                       torch.Generator().manual_seed(0)).train()
    x = tx(batch)[int(case.endswith("spec"))]
    with pytest.raises(ValueError, match="seed"):
        head(x)
    assert not torch.equal(head(x, seed=1), head(x, seed=2))
    head(x, seed=1).square().sum().backward()
    assert all(p.grad is not None for p in head.parameters())


def _whole_tree(case, jm, variables, tm):
    """The JAX head's parameter tree as its train and eval drivers hold it:
    a head's forward initialises the part of the backbone it calls (the
    VAE's encoder, one contrastive tower), and the drivers merge the whole
    backbone (the VAE's decoder, both towers and their projections)."""
    params = dict(variables["params"])
    for backbone in ("vae", "contrastnet"):
        if backbone in params:
            params[backbone] = to_jax_params(getattr(tm, backbone))["params"]
    return {"params": params}


@pytest.mark.parametrize("case", HEADS)
def test_the_weight_bridge_round_trips_each_head(case):
    """to_jax_params of each head has the JAX head's whole tree (backbone
    included), and load_jax_params of that tree into a differently seeded
    head gives back the weights bitwise, the VAE's decoder too."""
    batch = make_batch(B=2, lp=12, ns=40, seed=11)
    jm, variables, tm, _ = head_pair(case, batch)
    tree = to_jax_params(tm)
    want = _whole_tree(case, jm, variables, tm)
    assert (jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    other = init_params(build(tmodels, case), torch.Generator().manual_seed(1))
    load_jax_params(other, tree)
    for (n, a), (_, b) in zip(tm.state_dict().items(), other.state_dict().items()):
        assert torch.equal(a, b), n
    if case.startswith("vae"):
        assert any(n.startswith("vae.dec.") for n in other.state_dict())


@pytest.mark.parametrize("times,skip,items", [
    ([0.5, 0.1, 0.2, 0.3], 1, 32), ([0.5], 1, 8), ([], 1, None), ([0.4, 0.2, 0.2], 2, 16),
    ([0.3, 0.1], 0, 0)])
def test_step_timer_summary_equals_jax(times, skip, items):
    """StepTimer.summary on given times equals the JAX package's, the
    skipped warm-up steps and the fallback to all steps included."""
    got, want = tprof.StepTimer(skip=skip), jprof.StepTimer(skip=skip)
    got.times, want.times = list(times), list(times)
    assert got.steady == want.steady
    assert got.summary(items) == want.summary(items)


def test_timed_steps_and_honest_sync():
    """timed_steps times each step up to the read of its loss: one time
    and one float loss per batch, and the state threads through."""
    def step(state, batch):
        return state + 1, (batch * 2.0, torch.zeros(1))

    state, losses, timer = tprof.timed_steps(step, 0, [torch.tensor([1.5]),
                                                       torch.tensor([[3.0]])])
    assert state == 2 and losses == [3.0, 6.0]
    assert len(timer.times) == 2 and all(t >= 0 for t in timer.times)
    assert tprof.honest_sync([(torch.tensor([[7.0, 1.0]]),)]) == 7.0
    with tprof.StepTimer() as t:
        pass
    assert len(t.times) == 1


def test_trace_writes_a_profiler_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.ones(4).sum()
    assert any(p.name.endswith(".json") for p in tmp_path.iterdir())
