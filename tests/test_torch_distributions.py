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
