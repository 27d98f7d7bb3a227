"""The port's kernels and its card-only behaviour. These tests need an
NVIDIA card with nvcc (the kernels have no CPU mode) and skip elsewhere;
on the card run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the suite's conftest imports JAX, which the card's machine
need not have.)

Tolerances: a forward in fp32 max-abs 1e-5 (sums in another order); a
gradient in fp32 1e-4 of max |plain| (a sum over ~1000 keys or queries of
products that cancel); anything in bf16 2e-2 of max |plain| against the
plain version on fp32 inputs (bf16 keeps 8 bits).
"""

import numpy as np
import pytest
import torch

import vaesne_tpu_torch.ops.attention as attention
import vaesne_tpu_torch.ops.laplace as laplace
from vaesne_tpu_torch import (
    InferenceServer,
    PhotometricVAE,
    PhotoSpecMMVAE,
    SpectraVAE,
    TrainState,
    adamw,
    init_params,
    make_train_step,
    objectives,
)
from vaesne_tpu_torch.nn import MultiHeadAttention

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, R, H, Dh, Lq, Lk, masked, seed=0):
    g = torch.Generator(device).manual_seed(seed)
    q = torch.randn(R, Lq, H * Dh, device=device, generator=g)
    k = torch.randn(R, Lk, H * Dh, device=device, generator=g)
    v = torch.randn(R, Lk, H * Dh, device=device, generator=g)
    mask = None
    if masked:
        mask = torch.rand(R, Lk, device=device, generator=g) < 0.3
        mask[0] = True
    return q, k, v, mask


def _randn_like(t, seed):
    """Standard normal draws of ``t``'s shape on its device from their own
    generator: the inputs of a test do not depend on the tests before it."""
    g = torch.Generator(t.device).manual_seed(seed)
    return torch.randn(t.shape, device=t.device, dtype=t.dtype, generator=g)


def _rel(got, want, floor=1e-6):
    """max |got − want| over max |want|, or over ``floor`` where that is
    larger."""
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(floor)).item()


GRIDS = [
    (3, 4, 8, 1, 1, False), (2, 4, 8, 31, 127, True), (2, 2, 4, 129, 257, True),
    (2, 1, 16, 200, 33, True), (2, 1, 32, 130, 129, False), (4, 4, 8, 982, 982, True),
    (3, 4, 8, 1100, 70, True),
]
# Either side of the kernels' tiles: 16 rows a warp, 64 keys or queries a
# shared-memory chunk, 128 rows a block; and the dispatch's 982x5 and 60x4
# grids, where Lk is below any tile. Every supported head dim.
GRIDS += [
    (2, 4 if dh == 8 else 2, dh, lq, lk, (lq + lk + dh) % 2 == 1)
    for dh in attention.HEAD_DIMS
    for lq, lk in ((15, 17), (16, 16), (17, 15), (63, 65), (64, 64), (65, 63), (127, 129),
                   (128, 128), (129, 127), (982, 5), (60, 4))
]


@pytest.mark.parametrize("R,H,Dh,Lq,Lk,masked", GRIDS)
def test_kernel_matches_plain_version(cuda, R, H, Dh, Lq, Lk, masked):
    """K1 at rate 0."""
    q, k, v, mask = _inputs(cuda, R, H, Dh, Lq, Lk, masked)
    ref = attention.attention_reference(q, k, v, mask, H)
    before = attention.launches
    out = attention.fused_attention(q, k, v, mask, H)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert (out - ref).abs().max().item() <= 1e-5
    out16 = attention.fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, H)
    torch.cuda.synchronize()
    assert out16.dtype == torch.bfloat16
    assert _rel(out16, ref) <= 2e-2


@pytest.mark.parametrize("R,H,Dh,Lq,Lk,masked", GRIDS)
def test_dropout_forward_matches_plain_version(cuda, R, H, Dh, Lq, Lk, masked):
    """K1 at rate 0.1 against the plain version with the same seed: the
    masks agree bit for bit, or the outputs would differ by ~p·v."""
    q, k, v, mask = _inputs(cuda, R, H, Dh, Lq, Lk, masked, seed=1)
    for seed in (7, 2**32 - 5):
        ref = attention.attention_reference(q, k, v, mask, H, 0.1, seed)
        before = attention.dropout_launches
        out = attention.fused_attention(q, k, v, mask, H, 0.1, seed)
        torch.cuda.synchronize()
        assert attention.dropout_launches == before + 1
        assert (out - ref).abs().max().item() <= 1e-5
        out16 = attention.fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, H,
                                          0.1, seed)
        assert _rel(out16, ref) <= 2e-2


@pytest.mark.parametrize("R,H,Dh,Lq,Lk,masked", GRIDS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_matches_autograd_of_plain_version(cuda, R, H, Dh, Lq, Lk, masked, rate):
    """K2 (dq, dk, dv) and K1's statistics against the plain versions."""
    q, k, v, mask = _inputs(cuda, R, H, Dh, Lq, Lk, masked, seed=2)
    dout = _randn_like(q, seed=12)
    seed = 11 if rate > 0 else None
    want = attention.attention_backward_reference(q, k, v, mask, dout, H, rate, seed)
    m_ref, l_ref = attention.attention_stats_reference(q, k, mask, H)
    # With one key the softmax passes no gradient: autograd gives dq = dk =
    # 0 exactly, as (g − g)·1, while the kernel takes dp − Σ do·o from two
    # sums of O(1) terms in another order (with o rounded to bf16 in bf16),
    # so there the tolerance is held in absolute terms.
    floor = 1.0 if Lk == 1 else 1e-6
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        qd, kd, vd = (t.detach().to(dtype).requires_grad_() for t in (q, k, v))
        before = attention.bwd_launches
        out = attention.fused_attention(qd, kd, vd, mask, H, rate, seed)
        out.backward(dout.to(dtype))
        torch.cuda.synchronize()
        assert attention.bwd_launches == before + 1
        for got, ref in zip((qd.grad, kd.grad, vd.grad), want):
            assert got.dtype == dtype
            assert _rel(got, ref, floor) <= tol, (dtype, _rel(got, ref, floor))
    _, m, l = attention.fused_attention_fwd(q, k, v, mask, H, rate, seed)
    torch.testing.assert_close(m, m_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_ref, rtol=1e-5, atol=1e-5)
    if masked:  # a fully masked row: every weight 1/Lk, so l = Lk
        torch.testing.assert_close(l[0], torch.full_like(l[0], float(Lk)), rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_are_deterministic(cuda, dtype):
    """K1 (with its statistics) and K2 twice on the same inputs at rate
    0.1: bitwise-equal outputs, statistics and gradients (no atomics; every
    sum in a fixed order)."""
    q, k, v, mask = (t if t is None or t.dtype == torch.bool else t.to(dtype)
                     for t in _inputs(cuda, 4, 4, 8, 982, 982, True, seed=4))
    dout = _randn_like(q, seed=14)
    runs = []
    for _ in range(2):
        out, m, l = attention.fused_attention_fwd(q, k, v, mask, 4, 0.1, 21)
        grads = attention.fused_attention_bwd(q, k, v, mask, out, m, l, dout, 4, 0.1, 21)
        runs.append((out, m, l, *grads))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_misaligned_views_match_aligned_inputs(cuda):
    """A view whose data starts 4 bytes past a 16-byte boundary gives the
    kernels' results on the aligned tensor, bit for bit."""
    q, k, v, mask = _inputs(cuda, 2, 4, 8, 70, 90, True, seed=5)
    dout = _randn_like(q, seed=15)

    def shifted(t):
        view = torch.empty(t.numel() + 1, device=cuda, dtype=t.dtype)[1:].view_as(t)
        return view.copy_(t)

    qs, ks, vs = (shifted(t) for t in (q, k, v))
    assert qs.data_ptr() % 16 != 0
    out, m, l = attention.fused_attention_fwd(q, k, v, mask, 4, 0.1, 3)
    got = attention.fused_attention_fwd(qs, ks, vs, mask, 4, 0.1, 3)
    grads = attention.fused_attention_bwd(q, k, v, mask, out, m, l, dout, 4, 0.1, 3)
    got += attention.fused_attention_bwd(qs, ks, vs, mask, shifted(out), m, l, shifted(dout),
                                         4, 0.1, 3)
    torch.cuda.synchronize()
    for a, b in zip((out, m, l, *grads), got):
        assert torch.equal(a, b)


def test_dropout_keep_rate(cuda):
    """With q = 0 every weight is 1/Lk and with v = 1 each output is
    #kept/Lk/(1 − rate): the kernel's keep rate is 230/256 within 4σ over
    31M draws."""
    R, H, L = 8, 4, 982
    q = torch.zeros(R, L, H * 8, device=cuda)
    v = torch.ones_like(q)
    out = attention.fused_attention(q, q, v, None, H, 0.1, 12345)
    keep = out.double().mean().item() * 0.9
    n = R * H * L * L
    p = 230 / 256
    assert abs(keep - p) <= 4 * (p * (1 - p) / n) ** 0.5, keep


def _bf16_close(got, want):
    """Within one bf16 ulp of the fp32 plain value: |got − want| ≤
    2⁻⁸·|want| (round to nearest gives at most half an ulp)."""
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N,x_rows", [(384, 982, 192), (384, 982, 384), (1, 982, 1),
                                        (6, 130, 3), (4, 2000, 1), (6, 981, 3)])
def test_laplace_kernels_match_plain_versions(cuda, R, N, x_rows, dtype):
    """K3 and K4 in the flat form, [R, N] rows over [Rx, N] data: K3 (row
    sums, rtol 1e-5, atol 1e-3: sums of ~N terms in another order) and K4
    (elementwise, the same operations: fp32 rtol 1e-6; bf16 loc within one
    bf16 ulp), against the plain versions on the same loc (bf16 widened)."""
    g = torch.Generator(cuda).manual_seed(3)
    loc = torch.randn(R, N, device=cuda, generator=g).to(dtype).requires_grad_()
    x = torch.randn(x_rows, N, device=cuda, generator=g)
    x[0, :5] = loc[0, :5].detach().float()  # sign(0) = 0
    mask = torch.rand(R, N, device=cuda, generator=g) < 0.2
    ref = laplace.masked_laplace_loglik_reference(loc, x, mask, 1e10)
    before = (laplace.launches, laplace.bwd_launches)
    out = laplace.masked_laplace_loglik(loc, x, mask, 1e10)
    gout = torch.randn(R, device=cuda, generator=g)
    out.backward(gout)
    torch.cuda.synchronize()
    assert (laplace.launches, laplace.bwd_launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)
    want = laplace.masked_laplace_grad_reference(loc.detach(), x, mask, 1e10, gout)
    assert loc.grad.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(loc.grad, want, rtol=1e-6, atol=0)
    else:
        _bf16_close(loc.grad, want)
    assert (loc.grad[0, :5] == 0).all()


# (M, K, B, N): an expert's [K, B, N] slice of a stacked [M·K, B, N] decode;
# the B = 192 step and the B = 16 drivers (M = 2, K = 2), the ZTF MMVAE
# driver (K = 8, B = 32), a single expert, a row past one 1024-point chunk,
# and odd rows that take single points
GRID_CASES = [(2, 2, 192, 982), (2, 2, 16, 982), (2, 8, 32, 982), (1, 1, 32, 982),
              (1, 3, 5, 2000), (2, 2, 7, 129), (2, 2, 7, 981)]


def _grid_inputs(device, M, K, B, N, dtype, seed=0):
    """loc, the mask and g as the MMVAE hands them over (expert 1's slice
    of the transposed [B, M·K, N] decode), the data x [B, N], and the whole
    stack as a leaf. Row (0, 0) is fully masked; x = loc at its first
    points (sign(0) = 0)."""
    g = torch.Generator(device).manual_seed(seed)
    e = M - 1
    stack = torch.randn(B, M * K, N, device=device, generator=g).to(dtype).requires_grad_()
    loc = stack.transpose(0, 1)[e * K:(e + 1) * K]
    mask_stack = torch.rand(B, M * K, N, device=device, generator=g) < 0.2
    mask = mask_stack.transpose(0, 1)[e * K:(e + 1) * K]
    mask[0, 0] = True
    x = torch.randn(B, N, device=device, generator=g)
    x[0, :5] = loc[0, 0, :5].detach().float()
    gout = torch.randn(K, B, device=device, generator=g)
    return stack, loc, x, mask, gout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,B,N", GRID_CASES)
def test_laplace_grid_kernels_match_plain_versions(cuda, M, K, B, N, dtype):
    """K3 and K4 in the grid form on the decoder's own layout, with the
    tolerances of the flat form; the gradient reaches the stack in the
    expert's rows only, in loc's dtype."""
    stack, loc, x, mask, gout = _grid_inputs(cuda, M, K, B, N, dtype)
    assert M * K == 1 or not loc.is_contiguous()
    ref = laplace.masked_laplace_loglik_reference(loc, x, mask, 1e10)
    before = (laplace.launches, laplace.bwd_launches)
    out = laplace.masked_laplace_loglik(loc, x, mask, 1e10)
    out.backward(gout)
    torch.cuda.synchronize()
    assert (laplace.launches, laplace.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert out.shape == (K, B) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)
    want = laplace.masked_laplace_grad_reference(loc.detach(), x, mask, 1e10, gout)
    grad = stack.grad.transpose(0, 1)
    e = M - 1
    assert grad.dtype == dtype and (grad[:e * K] == 0).all()
    if dtype == torch.float32:
        torch.testing.assert_close(grad[e * K:], want, rtol=1e-6, atol=0)
    else:
        _bf16_close(grad[e * K:], want)
    assert (grad[e * K, 0, :5] == 0).all()
    # the mask broadcast over K (stride 0) and the data expanded to [K, B, N]
    bmask = mask[0].expand(K, B, N)
    torch.testing.assert_close(laplace.masked_laplace_loglik_fwd(loc, x.expand(K, B, N), bmask,
                                                                 1e10),
                               laplace.masked_laplace_loglik_reference(loc, x, bmask, 1e10),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_laplace_kernels_are_deterministic(cuda, dtype):
    """K3 and K4 twice on the same inputs give equal bits (every sum in a
    fixed order, no atomics), at the step's and the drivers' shapes."""
    for M, K, B, N in GRID_CASES[:3]:
        _, loc, x, mask, gout = _grid_inputs(cuda, M, K, B, N, dtype, seed=1)
        runs = [(laplace.masked_laplace_loglik_fwd(loc, x, mask, 1e10),
                 laplace.masked_laplace_loglik_bwd(loc, x, mask, 1e10, gout)) for _ in range(2)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_loglik_launches_one_kernel(cuda, dtype):
    """One ``grid_loglik`` forward on an expert's slice of a stacked decode
    runs exactly one kernel on the card, K3: no copy of loc or the mask
    and no cast of bf16 loc before it."""
    from torch.profiler import ProfilerActivity, profile

    from vaesne_tpu_torch.distributions import MaskedGridLaplace

    _, loc, x, mask, _ = _grid_inputs(cuda, 2, 2, 16, 982, dtype)
    d = MaskedGridLaplace(loc.detach(), mask, 1e10)
    d.grid_loglik(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        d.grid_loglik(x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "laplace_fwd_kernel" in kernels[0].name, \
        [e.name for e in kernels]


def test_cuda_tensors_never_take_the_plain_path(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    for name in ("attention_reference", "attention_stats_reference",
                 "attention_backward_reference"):
        monkeypatch.setattr(attention, name, refuse)
    for name in ("masked_laplace_loglik_reference", "masked_laplace_grad_reference"):
        monkeypatch.setattr(laplace, name, refuse)
    q, k, v, mask = _inputs(cuda, 2, 4, 8, 40, 50, True)
    for t in (q, k, v):
        t.requires_grad_()
    attention.fused_attention(q, k, v, mask, 4, 0.1, 3).sum().backward()
    g = torch.Generator(cuda).manual_seed(6)
    loc = torch.randn(4, 200, device=cuda, generator=g).requires_grad_()
    laplace.masked_laplace_loglik(loc, torch.randn(2, 200, device=cuda, generator=g),
                                  torch.zeros(4, 200, dtype=torch.bool, device=cuda),
                                  1e10).sum().backward()
    torch.cuda.synchronize()
    assert q.grad is not None and loc.grad is not None


def test_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v, mask = _inputs(cuda, 2, 2, 8, 5, 7, True)
    with pytest.raises(TypeError):
        attention.fused_attention(q.half(), k.half(), v.half(), mask, 2)
    with pytest.raises(ValueError, match="one device"):
        attention.fused_attention(q, k, v, mask.cpu(), 2)
    with pytest.raises(ValueError, match="seed"):
        attention.fused_attention(q, k, v, mask, 2, 0.1)
    with pytest.raises(TypeError, match="bool"):
        laplace.masked_laplace_loglik(q[:, 0], q[:, 0], q[:, 0], 1e10)


def test_routed_dropout_launches_the_kernel(cuda):
    mha = MultiHeadAttention(32, 4, dropout=0.1).to(cuda).train()
    x = torch.randn(1, 256, 32, device=cuda, generator=torch.Generator(cuda).manual_seed(8))
    with pytest.raises(ValueError, match="seed"):
        mha(x, x, x)
    before = attention.dropout_launches
    a = mha(x, x, x, seed=5)
    assert attention.dropout_launches == before + 1
    torch.testing.assert_close(a, mha(x, x, x, seed=5))
    assert not torch.allclose(a, mha(x, x, x, seed=6))
    mha.eval()
    before = attention.launches
    assert torch.isfinite(mha(x, x, x)).all()
    assert attention.launches == before + 1


def _batch(B, lp, ns, seed=0):
    rng = np.random.default_rng(seed)
    photo = (rng.normal(size=(B, lp)).astype(np.float32),
             np.sort(rng.uniform(-1, 1, (B, lp)), axis=1).astype(np.float32),
             rng.integers(0, 6, (B, lp)), rng.uniform(size=(B, lp)) < 0.2)
    spec = (rng.normal(size=(B, ns)).astype(np.float32),
            np.linspace(-1, 1, ns, dtype=np.float32)[None].repeat(B, 0),
            rng.normal(size=(B,)).astype(np.float32), rng.uniform(size=(B, ns)) < 0.2)
    return photo, spec


def test_server_runs_on_the_card_by_default(cuda):
    kw = dict(latent_len=2, latent_dim=2, model_dim=16, ff_dim=16, num_layers=1, num_heads=2)
    model = init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                        torch.Generator().manual_seed(0))
    server = InferenceServer(model, buckets=(4,))
    assert server.device.type == "cuda"
    photo, spec = _batch(3, 12, 300)
    before = attention.launches
    out = server.crossmodal(photo, spec, K=2)
    assert out.is_cuda and out.shape == (2, 3, 300) and torch.isfinite(out).all()
    assert attention.launches == before + 1  # one layer's 300x300 self-attention


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_flagship_train_step_on_the_card(cuda, precision):
    """Two m-IWAE steps of the flagship model (B = 8, K = 2, dropout 0.1,
    remat on) on the card: finite losses and per step 8 K1 launches (4
    layers, forward and re-run), 4 K2 (one per backward), 2 K3 and 2 K4."""
    model = init_params(PhotoSpecMMVAE([
        PhotometricVAE(num_bands=6, latent_len=4, latent_dim=4, model_dim=32, ff_dim=32),
        SpectraVAE(latent_len=4, latent_dim=4, model_dim=32, ff_dim=32)]),
        torch.Generator().manual_seed(0))
    opt = adamw(1e-4)
    state = TrainState.create(model, opt, seed=0)
    step = make_train_step(model, opt, lambda m, b, s: objectives.m_iwae(m, b, K=2, seed=s),
                           precision=precision)
    batch = _batch(8, 60, 982)
    losses = []
    for _ in range(2):
        counts = (attention.dropout_launches, attention.bwd_launches, laplace.launches,
                  laplace.bwd_launches)
        state, loss = step(state, batch)
        losses.append(loss.item())
        now = (attention.dropout_launches, attention.bwd_launches, laplace.launches,
               laplace.bwd_launches)
        assert tuple(b - a for a, b in zip(counts, now)) == (8, 4, 2, 2)
    assert np.isfinite(losses).all() and losses[0] != losses[1]
    assert next(model.parameters()).is_cuda and state.step == 2


def test_train_step_gradients_repeat_bitwise(cuda):
    """Two backward passes of the flagship objective on one batch give the
    same bits in every gradient, the light-curve decoder's band embedding
    (64 × 60 indices, past the 3072 where nn.Embedding's backward adds
    rows in a varying order) included: what a bitwise resume rests on."""
    kw = dict(latent_len=4, latent_dim=4, model_dim=32, ff_dim=32, num_layers=2, num_heads=4)
    model = init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                        torch.Generator().manual_seed(0)).to(cuda).train()
    rng = np.random.default_rng(0)
    g = torch.Generator().manual_seed(9)
    photo = (torch.randn(16, 60, generator=g), torch.rand(16, 60, generator=g),
             torch.from_numpy(rng.integers(0, 6, (16, 60))),
             torch.rand(16, 60, generator=g) < 0.2)
    spec = (torch.randn(16, 982, generator=g), torch.linspace(-1, 1, 982).repeat(16, 1),
            torch.randn(16, generator=g), torch.rand(16, 982, generator=g) < 0.2)
    batch = tuple(tuple(t.to(cuda) for t in m) for m in (photo, spec))
    grads = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        (-objectives.m_iwae(model, batch, 2, seed=7)).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    differ = [n for n in grads[0] if not torch.equal(grads[0][n], grads[1][n])]
    assert not differ, differ


def _graph_model():
    kw = dict(latent_len=2, latent_dim=2, model_dim=16, ff_dim=16, num_layers=1, num_heads=2)
    return init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                       torch.Generator().manual_seed(0))


def _counts():
    return (attention.launches, attention.dropout_launches, attention.bwd_launches,
            laplace.launches, laplace.bwd_launches)


def test_graph_replays_are_the_eager_steps(cuda):
    """make_scan_epoch's CUDA graph of a small m-IWAE step (dropout 0.1;
    the 300-bin spectrum's decoder self-attention on K1/K2, its likelihood
    on K3/K4), over five one-step epochs: a warm-up step, the capture and
    its replay, then three more replays. Parameters and losses are bitwise
    those of five eager steps of the step loop, and the launch counters
    rise by the eager step's launches at every replay."""
    from vaesne_tpu_torch.training import make_scan_epoch, train_epoch

    batch = tuple(tuple(torch.from_numpy(a).to(cuda) for a in m) for m in _batch(4, 60, 300))

    def loss_fn(m, b, s):
        return objectives.m_iwae(m, b, K=2, seed=s)

    runs = []
    for graph in (True, False):
        model = _graph_model()
        opt = adamw(1e-3)
        state = TrainState.create(model, opt, seed=0)
        if graph:
            epoch = make_scan_epoch(model, opt, loss_fn)
        else:
            step = make_train_step(model, opt, loss_fn)
            epoch = lambda st, d, g, bs: train_epoch(st, step, d, bs, g)  # noqa: E731
        losses, launches = [], []
        for i in range(5):
            before = _counts()
            state, loss = epoch(state, batch, torch.Generator().manual_seed(i), 4)
            losses.append(loss)
            launches.append(tuple(b - a for a, b in zip(before, _counts())))
        runs.append((losses, launches, [p.detach().clone() for p in model.parameters()]))
    (g_losses, g_launches, g_params), (e_losses, e_launches, e_params) = runs
    assert g_losses == e_losses and len(set(e_losses)) == 5
    assert all(torch.equal(a, b) for a, b in zip(g_params, e_params))
    assert e_launches[0][1] > 0 and e_launches[0][2] > 0 and e_launches[0][3] > 0
    assert g_launches == e_launches and len(set(e_launches)) == 1


def test_graph_epoch_counts_one_capture_and_its_spans_lie_on_the_device_clock(cuda, tmp_path):
    """Three one-step epochs of make_scan_epoch (the warm-up step, the
    capture and its replay, a replay) add one to ``counters.captures``, at
    the capture alone; a fourth, profiled, records a replayed step's spans,
    and every device operation of it lies inside its ``train.epoch``
    annotation of the Chrome trace, whose loss read waits for them."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from vaesne_tpu_torch.ops import counters
    from vaesne_tpu_torch.training import make_scan_epoch
    from vaesne_tpu_torch.utils import profiling

    batch = tuple(tuple(torch.from_numpy(a).to(cuda) for a in m) for m in _batch(4, 60, 300))
    model = _graph_model()
    opt = adamw(1e-3)
    state = TrainState.create(model, opt, seed=0)
    epoch = make_scan_epoch(model, opt, lambda m, b, s: objectives.m_iwae(m, b, K=2, seed=s))
    captured = []
    for i in range(3):
        before = counters.captures
        state, _ = epoch(state, batch, torch.Generator().manual_seed(i), 4)
        captured.append(counters.captures - before)
    assert captured == [0, 1, 0]
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        epoch(state, batch, torch.Generator().manual_seed(3), 4)
    records = profiling.spans()
    profiling.clear_spans()
    assert sorted(r.name for r in records) == sorted(
        ["train.epoch", "train.order", "train.step", "train.gather", "train.reseed",
         "train.replay", "train.loss_read"])
    (step,) = [r for r in records if r.name == "train.step"]
    assert step.attrs == {"kind": "replay"}
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (ep,) = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "train.epoch"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert device
    for e in device:
        assert ep["ts"] <= e["ts"] and e["ts"] + e["dur"] <= ep["ts"] + ep["dur"], e["name"]


def test_graph_of_a_world1_dp_step_is_the_ddp_step_loop(cuda):
    """make_scan_epoch under a world-1 NCCL mesh (a spawned rank on this
    card): the step as two CUDA graphs, the gradients and the update, with
    the gradient all-reduce eager between their replays, over three
    two-step epochs (a warm-up step, the capture and its replay, then
    replays), against the DDP step loop: losses, parameters, AdamW moments,
    step and generator bitwise equal; the 300-bin decoder's attention on
    K1/K2 at dropout 0.1 with the rank's shard seed."""
    import torch_dp_workers
    from vaesne_tpu_torch.parallel import launch, make_mesh

    mesh = make_mesh(["cuda:0"])
    assert mesh.backend == "nccl"
    out = launch(torch_dp_workers.scan_epochs, mesh, _graph_model(), _batch(8, 60, 300), 3, 4,
                 2, "sum", 1, False, False, "cuda")
    (g_losses, g_state, _, reason), (e_losses, e_state, _, _) = out[True], out[False]
    assert reason is None and g_losses == e_losses and len(set(g_losses)) == 3
    assert g_state["step"] == e_state["step"] == 6
    assert torch.equal(g_state["generator"], e_state["generator"])
    assert all(torch.equal(g_state["model"][k], e_state["model"][k]) for k in g_state["model"])
    for a, b in zip(g_state["optimizer"]["state"].values(),
                    e_state["optimizer"]["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_graph_capture_refuses_a_debug_print(cuda):
    """elbo(debug=True) prints, a host sync no graph can capture: under a
    capture it raises."""
    vae = init_params(SpectraVAE(latent_len=2, latent_dim=2, model_dim=16, ff_dim=16,
                                 num_layers=1, num_heads=2),
                      torch.Generator().manual_seed(0)).to(cuda).eval()
    spec = tuple(torch.from_numpy(a).to(cuda) for a in _batch(2, 60, 300)[1])
    objectives.elbo(vae, spec, seed=1)  # warm
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="scan_epoch=false"):
        with torch.cuda.graph(graph):
            objectives.elbo(vae, spec, seed=1, debug=True)


def test_a_cpu_checkpoint_resumes_on_the_card(cuda):
    """A state saved on the CPU (AdamW not capturable, its step count on the
    CPU) loads into the card's capturable AdamW, whose step count then
    lives on the card, and trains on."""
    opt = adamw(1e-3)
    batch = _batch(4, 60, 300)
    loss_fn = lambda m, b, s: objectives.m_iwae(m, b, K=2, seed=s)  # noqa: E731
    cpu = TrainState.create(_graph_model(), opt, seed=0, device="cpu")
    cpu, _ = make_train_step(cpu.model, opt, loss_fn, device="cpu")(cpu, batch)
    card_model = _graph_model()
    card = TrainState.create(card_model, opt, seed=0)
    card.load_state_dict(cpu.state_dict())
    assert card.version == 1 and card.optimizer.param_groups[0]["capturable"]
    assert all(s["step"].is_cuda for s in card.optimizer.state.values())
    card, loss = make_train_step(card_model, opt, loss_fn)(card, batch)
    assert torch.isfinite(loss) and card.step == 2
