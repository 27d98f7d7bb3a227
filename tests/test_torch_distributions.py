"""``kl_divergence`` of the port against the JAX package: closed forms
where they exist, and without one the same refusal to sample from a source
of randomness the caller did not pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.distributions as jdist
import vaesne_tpu_torch.distributions as tdist


def _pair(mod, lib):
    loc, scale = lib.zeros((3, 4)), lib.ones((3, 4))
    return mod.Laplace(loc, scale), mod.Normal(loc + 1.0, 2.0 * scale)


def test_kl_without_a_closed_form_needs_a_source_of_draws_in_both_packages():
    """Laplace‖Normal has no closed form: the JAX package raises without a
    key, and so does the port without a generator (it drew from torch's
    global generator before)."""
    with pytest.raises(ValueError, match="No closed-form KL for this pair"):
        jdist.kl_divergence(*_pair(jdist, jnp))
    state = torch.random.get_rng_state()
    with pytest.raises(ValueError, match="No closed-form KL for this pair"):
        tdist.kl_divergence(*_pair(tdist, torch))
    assert torch.equal(torch.random.get_rng_state(), state)  # nothing was drawn


def test_kl_monte_carlo_with_a_source_of_draws():
    """With a generator (a key in JAX) both estimate the same KL over 20,000
    draws; their draws differ, so they agree to the estimate's spread."""
    got = tdist.kl_divergence(*_pair(tdist, torch), generator=torch.Generator().manual_seed(0),
                              K=20000)
    want = jdist.kl_divergence(*_pair(jdist, jnp), key=jax.random.PRNGKey(0), K=20000)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.05)


@pytest.mark.parametrize("cls", ["Laplace", "Normal"])
def test_kl_closed_forms_match(cls):
    a = [np.random.default_rng(s).uniform(0.5, 2.0, (3, 4)).astype(np.float32) for s in range(4)]
    got = tdist.kl_divergence(getattr(tdist, cls)(torch.tensor(a[0]), torch.tensor(a[1])),
                              getattr(tdist, cls)(torch.tensor(a[2]), torch.tensor(a[3])))
    want = jdist.kl_divergence(getattr(jdist, cls)(jnp.asarray(a[0]), jnp.asarray(a[1])),
                               getattr(jdist, cls)(jnp.asarray(a[2]), jnp.asarray(a[3])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cls", ["Laplace", "Normal", "MaskedGridLaplace"])
def test_variance_and_rsample_match_jax(cls):
    """``variance`` as the JAX classes compute it (exactly), and ``rsample``
    the same function as ``sample``, as in the JAX package."""
    rng = np.random.default_rng(3)
    loc = rng.normal(size=(2, 3, 5)).astype(np.float32)
    if cls == "MaskedGridLaplace":
        mask = rng.uniform(size=(3, 5)) < 0.4
        jd = jdist.MaskedGridLaplace(jnp.asarray(loc), jnp.asarray(mask), 7.0)
        td = tdist.MaskedGridLaplace(torch.from_numpy(loc), torch.from_numpy(mask), 7.0)
    else:
        scale = rng.uniform(0.5, 2.0, (3, 5)).astype(np.float32)
        jd = getattr(jdist, cls)(jnp.asarray(loc), jnp.asarray(scale))
        td = getattr(tdist, cls)(torch.from_numpy(loc), torch.from_numpy(scale))
    np.testing.assert_array_equal(td.variance.numpy(), np.asarray(jd.variance))
    assert type(td).rsample is type(td).sample and type(jd).rsample is type(jd).sample


def test_get_mean_and_log_mean_exp_take_the_jax_arguments():
    """``get_mean(d, key, K)``: the closed-form mean where there is one, else
    the mean of K draws from the seed ``key`` (the port's stand-in for a PRNG
    key), and without a key the JAX package's error; ``log_mean_exp`` with
    JAX's ``axis``/``keepdims`` keywords, within rtol 1e-6 of JAX's."""

    class MeanFree:  # a distribution with no closed-form mean
        def __init__(self, d):
            self.d, self.loc = d, d.loc

        def sample(self, generator=None, sample_shape=()):
            return self.d.sample(generator, sample_shape)

    d = tdist.Laplace(torch.full((4,), 2.0), torch.ones(4))
    assert torch.equal(tdist.get_mean(d), d.mean)
    mc = tdist.get_mean(MeanFree(d), key=5, K=20000)
    torch.testing.assert_close(mc, torch.full((4,), 2.0), atol=0.05, rtol=0)
    assert torch.equal(mc, tdist.get_mean(MeanFree(d), key=5, K=20000))
    with pytest.raises(ValueError, match="no closed-form mean"):
        tdist.get_mean(MeanFree(d))
    with pytest.raises(ValueError, match="no closed-form mean"):
        jdist.get_mean(type("MeanFreeJax", (), {"mean": None})())
    x = np.random.default_rng(4).normal(size=(3, 5, 2)).astype(np.float32) * 30
    for axis in (0, 1, -1):
        for keepdims in (False, True):
            got = tdist.log_mean_exp(torch.from_numpy(x), axis=axis, keepdims=keepdims)
            want = jdist.log_mean_exp(jnp.asarray(x), axis=axis, keepdims=keepdims)
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
