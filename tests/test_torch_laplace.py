"""The port's masked Laplace likelihood (K3, K4) and ``grid_loglik`` against
the JAX package on the CPU: the JAX Pallas kernels run in interpret mode,
the port's wrappers take their plain versions. fp32; row sums of ~N terms
within rtol 1e-5, elementwise gradients within 1e-6. The grid form
([K, B, N] views, the decoder's own layout) against the flat form [R, N]
on the same rows: the same fp32 operations, so within fp32 round-off of
the row sums (assert_close's default for fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.distributions as jdist
import vaesne_tpu_torch.distributions as tdist
import vaesne_tpu_torch.ops.laplace as port_laplace
from vaesne_tpu.ops.laplace import masked_laplace_loglik as jax_loglik
from vaesne_tpu_torch import PhotometricVAE, PhotoSpecMMVAE, SpectraVAE, init_params
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


def _stack(a, M, e):
    """A contiguous [B, M·K, N] stack holding a [K, B, N] in expert e's K
    rows (zeros elsewhere): the decoder's output before its exit
    transpose."""
    K, B, N = a.shape
    stack = a.new_zeros(B, M * K, N)
    stack[:, e * K:(e + 1) * K] = a.transpose(0, 1)
    return stack


def _expert(stack, K, e):
    """Expert e's [K, B, N] slice of a stack, as ``MMVAE.forward`` takes it:
    strides N and M·K·N."""
    return stack.transpose(0, 1)[e * K:(e + 1) * K]


@pytest.mark.parametrize("N", [60, 130, 982])
def test_grid_loglik_matches_jax(monkeypatch, N):
    """[K, B] from a [K, B, N] likelihood and [B, N] data, batch-major, on
    the plain path (N = 60) and the kernel path (N = 130 and the spectra's
    982, the JAX kernel in interpret mode); the port's loc and mask are an
    expert's slice of a stacked decode (M = 2), and the gradient with
    respect to the whole stack lands in that expert's rows only."""
    monkeypatch.setenv("VAESNE_PALLAS", "1")
    monkeypatch.setenv("VAESNE_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(3)
    M, K, B, e = 2, 2, 3, 1
    loc = rng.normal(size=(K, B, N)).astype(np.float32)
    mask = np.broadcast_to(rng.uniform(size=(B, N)) < 0.2, (K, B, N))
    x = rng.normal(size=(B, N)).astype(np.float32)
    gout = rng.normal(size=(K, B)).astype(np.float32)
    want, vjp = jax.vjp(lambda l: jdist.MaskedGridLaplace(l, jnp.asarray(mask), 1e10)
                        .grid_loglik(jnp.asarray(x)), jnp.asarray(loc))
    (dloc_want,) = vjp(jnp.asarray(gout))
    stack = _stack(torch.from_numpy(loc), M, e).requires_grad_()
    tmask = _expert(_stack(torch.from_numpy(mask.copy()), M, e), K, e)
    d = tdist.MaskedGridLaplace(_expert(stack, K, e), tmask, 1e10)
    assert d.loc.stride() == tmask.stride() == (N, M * K * N, 1)
    got = d.grid_loglik(torch.from_numpy(x))
    assert got.shape == (K, B) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    got.backward(torch.from_numpy(gout))
    grad = stack.grad.transpose(0, 1)
    np.testing.assert_allclose(grad[e * K:(e + 1) * K].numpy(), np.asarray(dloc_want),
                               rtol=1e-6, atol=0)
    assert (grad[:e * K] == 0).all() and (grad[(e + 1) * K:] == 0).all()
    got = got.detach()
    d = tdist.MaskedGridLaplace(torch.from_numpy(loc), torch.from_numpy(mask.copy()), 1e10)
    # data already broadcast to [K, B, N] gives the same; bf16 loc is cast to fp32
    torch.testing.assert_close(d.grid_loglik(torch.from_numpy(x).expand(K, B, N)), got)
    d16 = tdist.MaskedGridLaplace(torch.from_numpy(loc).bfloat16(), d.mask, 1e10)
    torch.testing.assert_close(d16.grid_loglik(torch.from_numpy(x)),
                               tdist.MaskedGridLaplace(d16.loc.float(), d.mask,
                                                       1e10).grid_loglik(torch.from_numpy(x)))


def _flatten(a):
    """[K, B, N] → the flat form's [B·K, N] rows, batch-major (row b·K + k)."""
    K, B = a.shape[:2]
    return a.transpose(0, 1).reshape(B * K, -1)


def _decoded(N, seed=0):
    """The spectra likelihood of a small flagship-shaped MMVAE's forward
    (M = 2, K = 2, B = 3, N points): expert 0's slice of the stacked
    decode, and the data."""
    kw = dict(latent_len=2, latent_dim=2, model_dim=8, ff_dim=8, num_layers=1, num_heads=2)
    model = init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                        torch.Generator().manual_seed(seed)).eval()
    rng = np.random.default_rng(seed)
    B, lp = 3, 12
    photo = (torch.randn(B, lp), torch.sort(torch.rand(B, lp)).values,
             torch.from_numpy(rng.integers(0, 6, (B, lp))), torch.rand(B, lp) < 0.2)
    spec = (torch.randn(B, N), torch.linspace(-1, 1, N).repeat(B, 1), torch.randn(B),
            torch.rand(B, N) < 0.2)
    _, px_zs, _ = model((photo, spec), K=2, generator=torch.Generator().manual_seed(seed))
    return px_zs[0][1], spec[0]


@pytest.mark.parametrize("case", ["decoder_slice", "broadcast_mask", "bf16_loc"])
def test_grid_form_equals_flat_form(case):
    """The plain versions (the CPU path and the kernels' oracle) in the grid
    form on the decoder's own layout against the flat form on the same rows,
    forward and gradient: an expert's slice of an MMVAE decode (strides N and
    M·K·N, built through ``MMVAE.forward``); a mask [B, N] broadcast over K
    (stride 0); bf16 loc against its fp32 widening."""
    big = 1e10
    if case == "decoder_slice":
        px, x = _decoded(130)
        loc, mask = px.loc.detach(), px.mask
        K, B, N = loc.shape
        assert loc.stride() == mask.stride() == (N, 2 * K * N, 1)
    else:
        rng = np.random.default_rng(5)
        K, B, N = 3, 4, 150
        loc = torch.from_numpy(rng.normal(size=(K, B, N)).astype(np.float32))
        x = torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32))
        mask = torch.from_numpy(rng.uniform(size=(B, N)) < 0.2).expand(K, B, N)
        assert mask.stride()[0] == 0
        if case == "bf16_loc":
            mask = mask.contiguous()
            loc = loc.bfloat16()
    g = torch.from_numpy(np.random.default_rng(6).normal(size=(K, B)).astype(np.float32))
    wide = loc.float()
    got = port_laplace.masked_laplace_loglik_reference(loc, x, mask, big)
    want = port_laplace.masked_laplace_loglik_reference(_flatten(wide), x, _flatten(mask), big)
    assert got.shape == (K, B) and got.dtype == torch.float32
    torch.testing.assert_close(got, want.reshape(B, K).T)
    leaf = loc.clone().requires_grad_()
    masked_laplace_loglik(leaf, x, mask, big).backward(g)
    assert leaf.grad.dtype == loc.dtype
    want_grad = port_laplace.masked_laplace_grad_reference(_flatten(wide), x, _flatten(mask),
                                                           big, g.T.reshape(-1))
    torch.testing.assert_close(leaf.grad.float(), want_grad.reshape(B, K, N).transpose(0, 1)
                               .to(loc.dtype).float(), rtol=0, atol=0)
    torch.testing.assert_close(port_laplace.masked_laplace_loglik_bwd(loc, x, mask, big, g),
                               leaf.grad, rtol=0, atol=0)
    torch.testing.assert_close(port_laplace.masked_laplace_loglik_fwd(loc, x, mask, big), got)


@pytest.mark.parametrize("form", ["flat", "grid", "grid_broadcast"])
def test_kernel_layout_addresses_every_row(form):
    """What the kernels are handed (each operand as base, stride over k,
    stride over b, unit stride over N) names the same rows as the plain
    version reads: rebuilt with ``as_strided`` on the CPU, each operand and
    the output strides give the logical [K, B, N] operands, for the flat
    form, an expert's slice of an MMVAE decode, and the same with a mask
    [B, N] and data [1, B, N] broadcast over K. Pairs of points are used
    where every row starts on a pair boundary."""
    px, x = _decoded(982 if form != "flat" else 130)
    loc, mask = px.loc.detach(), px.mask
    K, B, N = loc.shape
    if form == "flat":
        loc, mask = _flatten(loc), _flatten(mask)
    elif form == "grid_broadcast":
        mask, x = mask[0], x[None]
    layout_k, layout_b, operands, strides = port_laplace._layout(loc, x, mask)
    assert (layout_k, layout_b) == (K, B)
    if form == "flat":
        logical = [t.reshape(B, K, N).transpose(0, 1)
                   for t in (loc, x[:, None].expand(B, K, N), mask)]
    else:
        logical = [t.expand(K, B, N) for t in (loc, x, mask)]
    for (t, sk, sb), want in zip(operands, logical):
        assert t.stride(-1) == 1
        assert torch.equal(torch.as_strided(t, (K, B, N), (sk, sb, 1)), want)
    out = torch.arange(K * B, dtype=torch.float32).reshape(loc.shape[:-1])
    rows = torch.as_strided(out, (K, B), strides(out))
    assert torch.equal(rows, out.reshape(B, K).T if form == "flat" else out)
    assert strides(torch.zeros(()).expand(loc.shape[:-1])) == (0, 0)  # autograd's g of a sum
    assert port_laplace._pairs(N, operands)
    assert not port_laplace._pairs(N - 1, operands)
    odd = torch.empty(loc.numel() + 1)[1:].view_as(loc)
    assert not port_laplace._pairs(N, port_laplace._layout(odd, x, mask)[2])
