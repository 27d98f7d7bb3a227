"""The port's training loop against the JAX package on the CPU: AdamW with
the global-norm clip, the train step, gradient accumulation, remat and the
epoch loop. Sampling is pinned (``fixed_noise``) and dropout is 0 where
the two packages are compared; the spectra grid has 130 bins, so the
likelihood takes the masked Laplace kernel path in both (the JAX kernel in
interpret mode)."""

import jax
import numpy as np
import optax
import pytest
import torch

import vaesne_tpu_torch.distributions as tdist
from vaesne_tpu import objectives as jobj
from vaesne_tpu import training as jtr
from vaesne_tpu_torch import PhotometricVAE, PhotoSpecMMVAE, SpectraVAE, init_params
from vaesne_tpu_torch import objectives as tobj
from vaesne_tpu_torch import training as ttr
from vaesne_tpu_torch.nn import TransformerStack
from vaesne_tpu_torch.utils import to_jax_params

from torch_parity import SMALL, fixed_noise, jx, make_batch, make_pair, tx  # noqa: F401

K = 2


def _m_iwae(model, batch, seed):
    return tobj.m_iwae(model, batch, K, seed=seed)


def _model(seed=0, **overrides):
    kw = dict(SMALL, **overrides)
    return init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                       torch.Generator().manual_seed(seed))


def test_three_adamw_steps_track_jax(monkeypatch, fixed_noise):
    """Three steps of m-IWAE + AdamW(1e-3) + clip 10 from the same weights:
    losses within rtol 1e-5, and the parameters within 2% of the distance
    they travelled (measured: 0.5%). Adam moves every entry by O(lr)
    whatever its gradient's size, so an entry whose gradient is ~0 (the
    attention key biases, to which softmax is blind) moves by amounts set
    by round-off, differently in any two implementations: an entrywise
    bound would test round-off. ``test_adamw_step_matches_optax`` holds
    the update itself entrywise."""
    monkeypatch.setenv("VAESNE_PALLAS", "1")
    monkeypatch.setenv("VAESNE_PALLAS_INTERPRET", "1")
    batch = make_batch(B=3, lp=12, ns=130, seed=6)
    jm, variables, tm = make_pair(dict(SMALL, dropout=0.0), batch)
    start = {p: np.asarray(a).copy()
             for p, a in jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
    opt_j = jtr.adamw(1e-3)
    state_j = jtr.TrainState.create(variables["params"], opt_j, jax.random.PRNGKey(0))
    step_j = jtr.make_train_step(jm, opt_j, lambda m, v, b, k: jobj.m_iwae(
        m, v, b, K, key=k, deterministic=False))
    opt_t = ttr.adamw(1e-3)
    state_t = ttr.TrainState.create(tm, opt_t, seed=0, device="cpu")
    step_t = ttr.make_train_step(tm, opt_t, _m_iwae, device="cpu")
    norms = []
    for _ in range(3):
        grads = jax.grad(lambda p: -jobj.m_iwae(jm, {"params": p}, jx(batch), K,
                                                key=jax.random.PRNGKey(0)))(state_j.params)
        norms.append(float(optax.global_norm(grads)))
        state_j, loss_j = step_j(state_j, jx(batch))
        state_t, loss_t = step_t(state_t, batch)
        np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    assert max(norms) > 10.0  # the clip engaged
    assert state_t.step == 3
    got = dict(jax.tree_util.tree_flatten_with_path(to_jax_params(tm)["params"])[0])
    want = dict(jax.tree_util.tree_flatten_with_path(state_j.params)[0])
    assert got.keys() == want.keys()
    err = sum(float(((got[p] - np.asarray(want[p])) ** 2).sum()) for p in want)
    travelled = sum(float(((start[p] - np.asarray(want[p])) ** 2).sum()) for p in want)
    assert err ** 0.5 <= 2e-2 * travelled ** 0.5, (err, travelled)


def test_adamw_step_matches_optax():
    """The train step's update on a loss with known gradients (−data, for
    the objective w·data) against optax's clip + AdamW chain, three steps,
    entrywise within 1e-6 of the weights: the clip engages on the last."""
    rng = np.random.default_rng(11)
    w0 = rng.normal(size=(3, 4)).astype(np.float32)
    data = [rng.normal(size=(3, 4)).astype(np.float32) * s for s in (0.5, 2.0, 9.0)]
    model = torch.nn.Linear(4, 3, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0))
    opt_t = ttr.adamw(1e-2, grad_clip=5.0)
    state = ttr.TrainState.create(model, opt_t, device="cpu")
    step = ttr.make_train_step(model, opt_t, lambda m, b, s: (m.weight * b).sum(), device="cpu")
    opt_j = jtr.adamw(1e-2, grad_clip=5.0)
    w, opt_state = w0, opt_j.init(w0)
    for d in data:
        state, _ = step(state, torch.from_numpy(d))
        updates, opt_state = opt_j.update(-d, opt_state, w)
        w = optax.apply_updates(w, updates)
        np.testing.assert_allclose(model.weight.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("scale", [0.1, 1.0, 30.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(7)
    grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(10.0).update([np.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = ttr.clip_by_global_norm(got, 10.0)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def _grads(model):
    return [p.grad.clone() for p in model.parameters()]


def test_remat_gradients_equal_no_remat_at_dropout():
    """Dropout 0.1 in train mode, the 300-bin decoder self-attention on the
    kernel path: gradients with every block rematerialised equal those
    without, so the re-run drew the same masks."""
    model = _model(num_layers=2, dropout=0.1).train()
    batch = tx(make_batch(B=2, lp=12, ns=300, seed=8))
    stacks = [m for m in model.modules() if isinstance(m, TransformerStack)]
    assert stacks and all(s.remat for s in stacks)
    grads = {}
    for remat, seed in ((True, 3), (False, 3), (True, 4)):
        for s in stacks:
            s.remat = remat
        model.zero_grad(set_to_none=True)
        (-_m_iwae(model, batch, seed)).backward()
        grads[remat, seed] = _grads(model)
    for a, b in zip(grads[True, 3], grads[False, 3]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert any(not torch.allclose(a, b) for a, b in zip(grads[True, 3], grads[True, 4]))


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_accumulate_gradients_matches_whole_batch(monkeypatch, reduction):
    """Two microbatches against one whole batch, posterior draws pinned to
    their means: m-IWAE sums over the batch ("sum"), the ELBO averages
    ("mean")."""
    def no_noise(self, generator=None, sample_shape=()):
        return self.loc.expand(tdist._as_shape(sample_shape) + tuple(self.batch_shape))

    monkeypatch.setattr(tdist.Laplace, "sample", no_noise)
    mmvae = _model(dropout=0.0).train()
    if reduction == "sum":
        model, batch, fn = mmvae, tx(make_batch(B=4, seed=9)), _m_iwae
    else:
        model, batch = mmvae.vaes[1], tx(make_batch(B=4, seed=9))[1]
        fn = lambda m, b, s: tobj.elbo(m, b, K, seed=s)  # noqa: E731

    def neg(m, b, s):
        return -fn(m, b, s)

    model.zero_grad(set_to_none=True)
    whole = neg(model, batch, 0)
    whole.backward()
    want = _grads(model)
    model.zero_grad(set_to_none=True)
    loss = ttr.accumulate_gradients(neg, model, batch, 0, 2, reduction)
    torch.testing.assert_close(loss, whole.detach(), rtol=1e-5, atol=1e-5)
    for a, b in zip(_grads(model), want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        ttr.accumulate_gradients(neg, model, batch, 0, 3, reduction)


def test_fit_is_reproducible_from_its_seeds():
    """Two epochs of two steps; the same seeds give the same losses."""
    data = make_batch(B=9, seed=10)  # 9 samples, batch 4: the remainder is dropped
    runs = []
    for _ in range(2):
        model = _model(dropout=0.1)
        opt = ttr.adamw(1e-3)
        state = ttr.TrainState.create(model, opt, seed=1, device="cpu")
        step = ttr.make_train_step(model, opt, _m_iwae, device="cpu")
        seen = []
        state, losses = ttr.fit(state, step, data, 4, 2, torch.Generator().manual_seed(2),
                                callback=lambda e, s, l: seen.append((e, s.step)))
        assert seen == [(0, 2), (1, 4)] and np.isfinite(losses).all()
        runs.append(losses)
    assert runs[0] == runs[1]


def test_entry_points_need_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, opt = _model(), ttr.adamw(1e-3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.TrainState.create(model, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.make_train_step(model, opt, _m_iwae)
    assert ttr.TrainState.create(model, opt, device="cpu").model.training
    with pytest.raises(ValueError, match="precision"):
        ttr.make_train_step(model, opt, _m_iwae, device="cpu", precision="fp16")
