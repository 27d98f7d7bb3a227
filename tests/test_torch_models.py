"""Model parity of the PyTorch port against the JAX package on the CPU.

The two frameworks draw different random numbers, so sampling is pinned:
the Laplace sampler of both packages is replaced by one that adds the same
numpy noise (a function of the draw's shape) to loc, and decoders are fed
the same numpy latents."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.distributions as jdist
import vaesne_tpu.models as jmodels
import vaesne_tpu_torch.distributions as tdist
import vaesne_tpu_torch.models as tmodels

from torch_parity import FLAGSHIP, SMALL, fixed_noise, jx as _jx, make_batch as _batch  # noqa: F401
from torch_parity import make_pair as _pair, tx as _tx


def _japply(module, variables, *args, **kwargs):
    """``module.apply`` compiled as one program (eager flax dispatches op by
    op, which is slower on the CPU than one compile)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args)


@pytest.fixture(scope="module")
def small():
    batch = _batch()
    return (*_pair(SMALL, batch), batch)


def _close(t, j, rtol=0.0, atol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("m", [0, 1])
def test_encoder_posterior_matches(small, m):
    jm, variables, tm, batch = small
    q_j = _japply(jm.vaes[m], {"params": variables["params"][f"vaes_{m}"]},
                  _jx(batch)[m], mean=False, method="encode")
    q_t = tm.vaes[m].encode(_tx(batch)[m], mean=False)
    _close(q_t.loc, q_j.loc)
    _close(q_t.scale, q_j.scale)
    _close(tm.vaes[m].encode(_tx(batch)[m]), q_j.loc)


@pytest.mark.parametrize("m", [0, 1])
def test_decode_matches_on_fixed_latents(small, m):
    jm, variables, tm, batch = small
    zs = np.random.default_rng(3).normal(size=(3, 3, 2, 2)).astype(np.float32)
    px_j = _japply(jm.vaes[m], {"params": variables["params"][f"vaes_{m}"]},
                   jnp.asarray(zs), _jx(batch)[m], method="decode")
    px_t = tm.vaes[m].decode(torch.from_numpy(zs), _tx(batch)[m])
    assert isinstance(px_t, tdist.MaskedGridLaplace) and px_t.big == px_j.big
    assert px_t.loc.shape == (3, 3, batch[m][0].shape[1])
    _close(px_t.loc, px_j.loc)
    np.testing.assert_array_equal(px_t.mask.numpy(), np.asarray(px_j.mask))
    _close(px_t.scale, px_j.scale, rtol=1e-6)


def _check_forward(jm, variables, tm, batch, K, rtol=0.0, atol=1e-5):
    key = jax.random.PRNGKey(1)
    qz_j, px_j, zs_j = _japply(jm, variables, _jx(batch), K=K, rngs={"sample": key})
    qz_t, px_t, zs_t = tm(_tx(batch), K)
    for m in range(2):
        _close(qz_t[m].loc, qz_j[m].loc, rtol, atol)
        _close(zs_t[m], zs_j[m], rtol, atol)
        for d in range(2):
            assert px_t[m][d].loc.shape[0] == K
            _close(px_t[m][d].loc, px_j[m][d].loc, rtol, atol)


def test_mmvae_forward_matches_on_fixed_latents(small, fixed_noise):
    _check_forward(*small, K=2)


@pytest.mark.parametrize("predictive", [False, True])
def test_mmvae_reconstruct_matches_on_fixed_latents(small, fixed_noise, predictive):
    jm, variables, tm, batch = small
    rec_j = _japply(jm, variables, _jx(batch), K=2, predictive=predictive,
                    method="reconstruct", rngs={"sample": jax.random.PRNGKey(2)})
    rec_t = tm.reconstruct(_tx(batch), 2, predictive=predictive)
    for e in range(2):
        for d in range(2):
            _close(rec_t[e][d], rec_j[e][d])


@pytest.mark.parametrize("direction", [(0, 1), (1, 0)])
def test_crossmodgen_matches_on_fixed_latents(small, fixed_noise, direction):
    jm, variables, tm, batch = small
    e, d = direction
    out_j = _japply(jm, variables, _jx(batch)[e], _jx(batch)[d], direction=direction,
                    K=3, method="crossmodgen", rngs={"sample": jax.random.PRNGKey(3)})
    out_t = tm.crossmodgen(_tx(batch)[e], _tx(batch)[d], direction=direction, K=3)
    _close(out_t, out_j)


@pytest.mark.parametrize("m", [0, 1])
def test_unimodal_forward_reconstruct_generate_match(small, fixed_noise, m):
    jm, variables, tm, batch = small
    jvae, tvae = jm.vaes[m], tm.vaes[m]
    params = {"params": variables["params"][f"vaes_{m}"]}
    key = {"sample": jax.random.PRNGKey(4)}
    x_j, x_t = _jx(batch)[m], _tx(batch)[m]
    qz_j, px_j, zs_j = _japply(jvae, params, x_j, K=2, rngs=key)
    qz_t, px_t, zs_t = tvae(x_t, 2)
    _close(qz_t.scale, qz_j.scale)
    _close(zs_t, zs_j)
    _close(px_t.loc, px_j.loc)
    _close(tvae.reconstruct(x_t, 2, predictive=True),
           _japply(jvae, params, x_j, K=2, predictive=True, method="reconstruct", rngs=key))
    _close(tvae.generate(3, x_t),
           _japply(jvae, params, x_j, method=lambda mdl, x: mdl.generate(3, x), rngs=key))


def test_mmvae_generate_matches_on_fixed_latents(small, fixed_noise):
    jm, variables, tm, batch = small
    gen_j = _japply(jm, variables, _jx(batch), method=lambda mdl, x: mdl.generate(3, x),
                    rngs={"sample": jax.random.PRNGKey(5)})
    for out_t, out_j in zip(tm.generate(3, _tx(batch)), gen_j):
        assert out_t.shape[0] == 3
        _close(out_t, out_j)


def test_flagship_width_matches(fixed_noise):
    """Flagship widths (model_dim 32, 4 layers, 4 heads, latent 4x4, 60-point
    light curves) with the spectra grid cut to 96 bins."""
    batch = _batch(B=2, lp=60, ns=96, seed=4)
    _check_forward(*_pair(FLAGSHIP, batch), batch, K=2, rtol=1e-4, atol=1e-6)


def test_bright_variants_match(fixed_noise):
    """BrightPhotometricVAE and BrightSpectraVAE: the decoded mean
    recentred to a brightness head read from latent token 0 (and the phase
    for spectra); the head's parameters bridge as ``brightnessfc``."""
    batch = _batch(seed=11)
    jm, variables, tm = _pair(SMALL, batch, bright=True)
    assert all(hasattr(v, "brightnessfc") for v in tm.vaes)
    _check_forward(jm, variables, tm, batch, K=2)
    with pytest.raises(ValueError, match="brightness"):
        tmodels.BrightSpectraVAE(latent_len=1)


def test_scalings_and_tile_leading_match(small):
    jm, _, tm, _ = small
    assert tm.llik_scalings == pytest.approx(jm.llik_scalings)
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(tmodels.tile_leading(torch.from_numpy(a), 5).numpy(),
                                  np.asarray(jmodels.tile_leading(jnp.asarray(a), 5)))


def test_laplace_sample_bounds_and_observed():
    """u ~ U(eps-1, 1) never reaches -1, so every draw is finite; observed
    is Laplace(loc, 1)."""
    loc = torch.zeros(4, 5)
    d = tdist.MaskedGridLaplace(loc, torch.rand(4, 5) < 0.5, 1e10)
    draws = d.observed.sample(torch.Generator().manual_seed(0), (1000,))
    assert torch.isfinite(draws).all() and draws.shape == (1000, 4, 5)
    torch.testing.assert_close(d.observed.scale, torch.ones(4, 5))
    kl = tdist.kl_divergence(tdist.Laplace(loc, torch.ones(4, 5)),
                             tdist.Laplace(loc + 1, 2 * torch.ones(4, 5)))
    kl_j = jdist.kl_divergence(jdist.Laplace(jnp.zeros((4, 5)), jnp.ones((4, 5))),
                               jdist.Laplace(jnp.ones((4, 5)), 2 * jnp.ones((4, 5))))
    _close(kl, kl_j, rtol=1e-6)
