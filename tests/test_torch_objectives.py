"""The port's objectives against the JAX package on the CPU, on pinned
posterior noise (``fixed_noise``) and bridged weights, dropout off (eval
mode against ``deterministic=True``). The spectra grid has 130 bins, so the
spectra likelihood takes the masked Laplace kernel path in both packages
(the JAX kernel in interpret mode, the port's wrapper its plain version).
Values within rtol 1e-5; gradients within 1e-4 of the largest gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaesne_tpu import objectives as jobj
from vaesne_tpu_torch import objectives as tobj
from vaesne_tpu_torch.utils import to_jax_params

from torch_parity import SMALL, fixed_noise, jx, make_batch, make_pair, tx  # noqa: F401

K = 2


@pytest.fixture(scope="module")
def pair():
    batch = make_batch(B=3, lp=12, ns=130, seed=5)
    jm, variables, tm = make_pair(SMALL, batch)
    return jm, variables, tm, batch


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("VAESNE_PALLAS", "1")
    monkeypatch.setenv("VAESNE_PALLAS_INTERPRET", "1")


def _close(t, j, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def test_grid_loglik_and_m_iwae_terms_match(pair, fixed_noise, pallas):
    jm, variables, tm, batch = pair
    key = {"sample": jax.random.PRNGKey(0)}
    qz_j, px_j, zs_j = jax.jit(lambda v, x: jm.apply(v, x, K, True, rngs=key))(
        variables, jx(batch))
    qz_t, px_t, zs_t = tm(tx(batch), K)
    for e in range(2):
        for d in range(2):
            data = batch[d][0]
            _close(tobj.grid_loglik(px_t[e][d], torch.from_numpy(data)),
                   jobj.grid_loglik(px_j[e][d], jnp.asarray(data)))
    want = jobj.m_iwae_terms(qz_j, px_j, zs_j, jx(batch), jm.llik_scalings, jm.pz())
    _close(tobj.m_iwae_terms(qz_t, px_t, zs_t, tx(batch), tm.llik_scalings, tm.pz()), want)


@pytest.mark.parametrize("name", ["m_iwae", "m_elbo", "elbo_photometry", "elbo_spectra"])
def test_objectives_match(pair, fixed_noise, pallas, name):
    jm, variables, tm, batch = pair
    key = jax.random.PRNGKey(1)
    if name.startswith("elbo"):
        m = 0 if name.endswith("photometry") else 1
        params = {"params": variables["params"][f"vaes_{m}"]}
        want = jax.jit(lambda v, x: jobj.elbo(jm.vaes[m], v, x, K, key=key,
                                              deterministic=True))(params, jx(batch)[m])
        got = tobj.elbo(tm.vaes[m], tx(batch)[m], K, seed=1)
    else:
        fn_j, fn_t = getattr(jobj, name), getattr(tobj, name)
        want = jax.jit(lambda v, x: fn_j(jm, v, x, K, key=key, deterministic=True))(
            variables, jx(batch))
        got = fn_t(tm, tx(batch), K, seed=1)
    assert got.dim() == 0 and torch.isfinite(got)
    _close(got, want)


def test_m_iwae_gradients_match_jax(pair, fixed_noise, pallas):
    """One m-IWAE step's gradients (of −m_iwae, what the train step
    minimises), every parameter, against ``jax.grad`` of the same step."""
    jm, variables, tm, batch = pair
    key = jax.random.PRNGKey(2)
    grads_j = jax.jit(jax.grad(lambda p, x: -jobj.m_iwae(
        jm, {"params": p}, x, K, key=key, deterministic=True)))(variables["params"], jx(batch))
    tm.zero_grad(set_to_none=True)
    (-tobj.m_iwae(tm, tx(batch), K, seed=2)).backward()
    grads_t = to_jax_params(tm, {n: p.grad for n, p in tm.named_parameters()})["params"]
    tm.zero_grad(set_to_none=True)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(grads_j)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(grads_t)[0])
    assert flat_j.keys() == flat_t.keys()
    scale = max(float(np.abs(g).max()) for g in flat_j.values())
    for path, want in flat_j.items():
        np.testing.assert_allclose(flat_t[path], np.asarray(want), rtol=0, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))
