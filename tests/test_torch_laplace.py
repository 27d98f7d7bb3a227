"""The port's masked Laplace likelihood (K3, K4) and ``grid_loglik`` against
the JAX package on the CPU: the JAX Pallas kernels run in interpret mode,
the port's wrappers take their plain versions. fp32; row sums of ~N terms
within rtol 1e-5, elementwise gradients within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.distributions as jdist
import vaesne_tpu_torch.distributions as tdist
import vaesne_tpu_torch.ops.laplace as port_laplace
from vaesne_tpu.ops.laplace import masked_laplace_loglik as jax_loglik
from vaesne_tpu_torch.ops import laplace_routes_to_kernel, masked_laplace_loglik


def _inputs(seed, R, N, x_rows=None):
    rng = np.random.default_rng(seed)
    loc = rng.normal(size=(R, N)).astype(np.float32)
    x = rng.normal(size=(x_rows or R, N)).astype(np.float32)
    x[0, :4] = loc[0, :4]  # sign(0) = 0
    mask = rng.uniform(size=(R, N)) < 0.2
    return loc, x, mask


@pytest.mark.parametrize("R,N,big", [(6, 982, 1e10), (9, 130, 1e8), (1, 200, 1e10)])
def test_loglik_and_grad_match_jax_kernels(R, N, big):
    loc, x, mask = _inputs(0, R, N)
    g = np.random.default_rng(1).normal(size=(R,)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda l: jax_loglik(l, jnp.asarray(x), jnp.asarray(mask), big, True),
                         jnp.asarray(loc))
    (dloc_j,) = vjp(jnp.asarray(g))
    tloc = torch.from_numpy(loc).requires_grad_()
    before = (port_laplace.launches, port_laplace.bwd_launches)
    out = masked_laplace_loglik(tloc, torch.from_numpy(x), torch.from_numpy(mask), big)
    out.backward(torch.from_numpy(g))
    assert (port_laplace.launches, port_laplace.bwd_launches) == before  # CPU: plain
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-5)
    np.testing.assert_allclose(tloc.grad.numpy(), np.asarray(dloc_j), rtol=1e-6, atol=0)
    assert (tloc.grad[0, :4] == 0).all()
    # the wrappers' CPU paths and the plain versions agree
    t = [torch.from_numpy(a) for a in (loc, x, mask)]
    torch.testing.assert_close(port_laplace.masked_laplace_loglik_fwd(*t, big), out.detach())
    torch.testing.assert_close(port_laplace.masked_laplace_loglik_bwd(*t, big,
                                                                      torch.from_numpy(g)),
                               tloc.grad)


def test_unexpanded_rows_equal_the_expanded_operands():
    """x with R/K rows reads row r // K: the same as the K-fold batch-major
    broadcast. The mask has all R rows."""
    loc, x, mask = _inputs(2, 8, 150, x_rows=4)
    t = torch.from_numpy
    got = masked_laplace_loglik(t(loc), t(x), t(mask), 1e10)
    want = masked_laplace_loglik(t(loc), t(np.repeat(x, 2, 0)), t(mask), 1e10)
    torch.testing.assert_close(got, want)
    with pytest.raises(ValueError, match="dividing"):
        masked_laplace_loglik(t(loc), t(x[:3]), t(mask), 1e10)
    with pytest.raises(ValueError, match=r"must be \[R, N\]"):
        masked_laplace_loglik(t(loc), t(x), t(mask[::2]), 1e10)
    with pytest.raises(TypeError, match="bool"):
        masked_laplace_loglik(t(loc), t(x), t(mask).float(), 1e10)


def test_laplace_routing_matches_jax(monkeypatch):
    """Grids of 128 points or more take the kernel in both packages
    (checked on the traced jaxpr of the JAX ``grid_loglik``)."""
    monkeypatch.setenv("VAESNE_PALLAS", "1")
    for n in (60, 127, 128, 982):
        d = jdist.MaskedGridLaplace(jnp.zeros((2, 3, n)), jnp.zeros((2, 3, n), bool), 1e10)
        jaxpr = str(jax.make_jaxpr(d.grid_loglik)(jnp.zeros((3, n))))
        assert laplace_routes_to_kernel(n) == ("pallas_call" in jaxpr), n


@pytest.mark.parametrize("N", [60, 130])
def test_grid_loglik_matches_jax(monkeypatch, N):
    """[K, B] from a [K, B, N] likelihood and [B, N] data, batch-major, on
    the plain path (N = 60) and the kernel path (N = 130, the JAX kernel in
    interpret mode)."""
    monkeypatch.setenv("VAESNE_PALLAS", "1")
    monkeypatch.setenv("VAESNE_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(3)
    K, B = 2, 3
    loc = rng.normal(size=(K, B, N)).astype(np.float32)
    mask = np.broadcast_to(rng.uniform(size=(B, N)) < 0.2, (K, B, N))
    x = rng.normal(size=(B, N)).astype(np.float32)
    want = jdist.MaskedGridLaplace(jnp.asarray(loc), jnp.asarray(mask), 1e10).grid_loglik(
        jnp.asarray(x))
    d = tdist.MaskedGridLaplace(torch.from_numpy(loc), torch.from_numpy(mask.copy()), 1e10)
    got = d.grid_loglik(torch.from_numpy(x))
    assert got.shape == (K, B) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # data already broadcast to [K, B, N] gives the same; bf16 loc is cast to fp32
    torch.testing.assert_close(d.grid_loglik(torch.from_numpy(x).expand(K, B, N)), got)
    d16 = tdist.MaskedGridLaplace(torch.from_numpy(loc).bfloat16(), d.mask, 1e10)
    torch.testing.assert_close(d16.grid_loglik(torch.from_numpy(x)),
                               tdist.MaskedGridLaplace(d16.loc.float(), d.mask,
                                                       1e10).grid_loglik(torch.from_numpy(x)))
