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

import torch.nn.functional as F

import vaesne_tpu_torch.ops.attention as attention
import vaesne_tpu_torch.ops.laplace as laplace
import vaesne_tpu_torch.ops.layer_norm as layer_norm
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
from vaesne_tpu_torch.nn import MultiHeadAttention, TransformerStack

pytestmark = pytest.mark.cuda

PIPE_MAX_KEYS = 1664  # 208 tiles of 8 keys: csrc/attention_fwd.cu PIPE_MAX_TILES
PIPE_MAX_QUERIES = 1024  # csrc/attention_bwd.cu: the queries K2's pipelined kernel stages


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
# The cells' own fp32 grids (the flagship spectra decoder's R = 64 of
# 982x982 masked; the image decoder's R = 32 of 900x900 unmasked), and
# either side of the most keys the pipelined fp32 kernel stages (the fewest,
# one chunk of 64, lies among the tile grids above).
GRIDS += [(64, 4, 8, 982, 982, True), (32, 4, 8, 900, 900, False),
          (2, 4, 8, 20, PIPE_MAX_KEYS, True), (2, 4, 8, 20, PIPE_MAX_KEYS + 1, True)]
# Either side of the most queries K2's pipelined fp32 kernel stages (its
# fewest keys, one slab of 64, lie among the tile grids above; 982 and 900
# queries are its ragged last chunks).
GRIDS += [(2, 4, 8, PIPE_MAX_QUERIES, 70, True), (2, 4, 8, PIPE_MAX_QUERIES + 1, 70, True)]


def _pipelined(dtype, Dh, Lk):
    """The C dispatch's rule for K1's pipelined kernel, as the tests hold it:
    fp32, head dim 8, from 64 keys up to what its shared memory holds."""
    want = dtype == torch.float32 and Dh == 8 and 64 <= Lk <= PIPE_MAX_KEYS
    assert attention.routes_pipelined(dtype, Dh, Lk) == want
    return int(want)


def _bwd_pipelined(dtype, Dh, Lq, Lk):
    """The C dispatch's rule for K2's pipelined kernel, as the tests hold
    it: fp32, head dim 8, up to the queries its shared memory holds, from
    one slab of 64 keys."""
    want = dtype == torch.float32 and Dh == 8 and 1 <= Lq <= PIPE_MAX_QUERIES and Lk >= 64
    assert attention.routes_bwd_pipelined(dtype, Dh, Lq, Lk) == want
    return int(want)


@pytest.mark.parametrize("R,H,Dh,Lq,Lk,masked", GRIDS)
def test_kernel_matches_plain_version(cuda, R, H, Dh, Lq, Lk, masked):
    """K1 at rate 0."""
    q, k, v, mask = _inputs(cuda, R, H, Dh, Lq, Lk, masked)
    ref = attention.attention_reference(q, k, v, mask, H)
    before, piped = attention.launches, attention.pipelined_launches
    out = attention.fused_attention(q, k, v, mask, H)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert attention.pipelined_launches == piped + _pipelined(torch.float32, Dh, Lk)
    assert (out - ref).abs().max().item() <= 1e-5
    piped = attention.pipelined_launches
    out16 = attention.fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, H)
    torch.cuda.synchronize()
    assert attention.pipelined_launches == piped + _pipelined(torch.bfloat16, Dh, Lk)
    assert out16.dtype == torch.bfloat16
    assert _rel(out16, ref) <= 2e-2


@pytest.mark.parametrize("R,H,Dh,Lq,Lk,masked", GRIDS)
def test_dropout_forward_matches_plain_version(cuda, R, H, Dh, Lq, Lk, masked):
    """K1 at rate 0.1 against the plain version with the same seed: the
    masks agree bit for bit, or the outputs would differ by ~p·v."""
    q, k, v, mask = _inputs(cuda, R, H, Dh, Lq, Lk, masked, seed=1)
    for seed in (7, 2**32 - 5):
        ref = attention.attention_reference(q, k, v, mask, H, 0.1, seed)
        before, piped = attention.dropout_launches, attention.pipelined_launches
        out = attention.fused_attention(q, k, v, mask, H, 0.1, seed)
        torch.cuda.synchronize()
        assert attention.dropout_launches == before + 1
        assert attention.pipelined_launches == piped + _pipelined(torch.float32, Dh, Lk)
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
        before, piped = attention.bwd_launches, attention.bwd_pipelined_launches
        out = attention.fused_attention(qd, kd, vd, mask, H, rate, seed)
        out.backward(dout.to(dtype))
        torch.cuda.synchronize()
        assert attention.bwd_launches == before + 1
        assert attention.bwd_pipelined_launches == piped + _bwd_pipelined(dtype, Dh, Lq, Lk)
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
    sum in a fixed order). In fp32 K2 runs its pipelined kernel, whose dq
    sums meet in shared memory across warpgroups."""
    for L, masked in ((982, True), (900, False)):
        q, k, v, mask = (t if t is None or t.dtype == torch.bool else t.to(dtype)
                         for t in _inputs(cuda, 4, 4, 8, L, L, masked, seed=4))
        dout = _randn_like(q, seed=14)
        runs = []
        piped = attention.bwd_pipelined_launches
        for _ in range(2):
            out, m, l = attention.fused_attention_fwd(q, k, v, mask, 4, 0.1, 21)
            grads = attention.fused_attention_bwd(q, k, v, mask, out, m, l, dout, 4, 0.1, 21)
            runs.append((out, m, l, *grads))
        torch.cuda.synchronize()
        assert attention.bwd_pipelined_launches == piped + 2 * (dtype == torch.float32)
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


def test_attention_graph_replay_is_the_eager_call(cuda):
    """K1 (with its statistics, at rate 0.1, its seed read from the seed
    word) and K2 captured in a CUDA graph on 982x982 fp32, the pipelined
    kernel's grid: a replay gives the eager calls' bits, also after new
    values in the static input and the seed word; the capture counts one
    launch of each, K1 pipelined and K2 pipelined among them."""
    q, k, v, mask = _inputs(cuda, 4, 4, 8, 982, 982, True, seed=6)
    q2 = _randn_like(q, seed=16)
    dout = _randn_like(q, seed=17)
    word = attention.seed_word(31, cuda)
    qs = q.clone()

    def call():
        out, m, l = attention.fused_attention_fwd(qs, k, v, mask, 4, 0.1, word)
        return (out, m, l, *attention.fused_attention_bwd(qs, k, v, mask, out, m, l, dout, 4,
                                                           0.1, word))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (attention.launches, attention.pipelined_launches, attention.bwd_launches,
              attention.bwd_pipelined_launches)
    with torch.cuda.graph(graph):
        got = call()
    assert (attention.launches, attention.pipelined_launches, attention.bwd_launches,
            attention.bwd_pipelined_launches) == tuple(n + 1 for n in before)
    for values, seed in ((q, 31), (q2, 32)):
        with torch.no_grad():
            qs.copy_(values)
            word.copy_(attention.seed_word(seed, cuda))
        graph.replay()
        torch.cuda.synchronize()
        out, m, l = attention.fused_attention_fwd(values, k, v, mask, 4, 0.1, seed)
        want = (out, m, l, *attention.fused_attention_bwd(values, k, v, mask, out, m, l, dout,
                                                           4, 0.1, seed))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


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


def _graph_model(model_dim=16, num_heads=2):
    kw = dict(latent_len=2, latent_dim=2, model_dim=model_dim, ff_dim=model_dim, num_layers=1,
              num_heads=num_heads)
    return init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                       torch.Generator().manual_seed(0))


def _counts():
    return (attention.launches, attention.dropout_launches, attention.bwd_launches,
            laplace.launches, laplace.bwd_launches, layer_norm.launches,
            layer_norm.bwd_launches, layer_norm.plain_calls)


def test_graph_replays_are_the_eager_steps(cuda):
    """make_scan_epoch's CUDA graph of a small m-IWAE step (dropout 0.1;
    the 300-bin spectrum's decoder self-attention on K1/K2, its likelihood
    on K3/K4), over five one-step epochs: a warm-up step, the capture and
    its replay, then three more replays. Parameters and losses are bitwise
    those of five eager steps of the step loop, and the launch counters
    rise by the eager step's launches at every replay, the LayerNorm
    kernels' among them (none computed by F.layer_norm: the towers' width
    32, at 4 heads the flagship's head size 8)."""
    from vaesne_tpu_torch.training import make_scan_epoch, train_epoch

    batch = tuple(tuple(torch.from_numpy(a).to(cuda) for a in m) for m in _batch(4, 60, 300))

    def loss_fn(m, b, s):
        return objectives.m_iwae(m, b, K=2, seed=s)

    runs = []
    for graph in (True, False):
        model = _graph_model(32, 4)
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
    assert e_launches[0][5] > 0 and e_launches[0][6] > 0 and e_launches[0][7] == 0
    assert g_launches == e_launches and len(set(e_launches)) == 1


def test_graph_replays_add_the_captured_convolutions(cuda):
    """make_scan_epoch's CUDA graph of a small hybrid image VAE step (32x32
    images, patch 2: the decoder's 256x256 self-attention on K1/K2, three
    cuDNN convolutions a forward), over four one-step epochs: the warm-up
    step, the capture and its replay, then two replays. Every step adds the
    same launches to the counters, three to ``conv``, none to ``LN plain``."""
    from vaesne_tpu_torch import HostImgVAE
    from vaesne_tpu_torch.data import image_tuple, make_images
    from vaesne_tpu_torch.ops import counters
    from vaesne_tpu_torch.training import make_scan_epoch

    model = init_params(HostImgVAE(img_size=32, latent_len=2, latent_dim=2, patch_size=2,
                                   model_dim=32, num_heads=4, ff_dim=32, num_layers=1),
                        torch.Generator().manual_seed(0))
    opt = adamw(1e-3)
    state = TrainState.create(model, opt, seed=0)
    epoch = make_scan_epoch(model, opt, lambda m, b, s: objectives.elbo(m, b, 1, seed=s))
    batch = image_tuple(make_images(n=4, img_size=32, seed=1), cuda)
    launches = []
    for i in range(4):
        before = counters.launch_counts()
        state, loss = epoch(state, batch, torch.Generator().manual_seed(i), 4)
        after = counters.launch_counts()
        launches.append({k: after[k] - before[k] for k in after if k != "captures"})
        assert np.isfinite(float(loss))
    assert launches[0]["conv"] == 3 and launches[0]["LN plain"] == 0 and launches[0]["K2"] > 0
    assert all(step == launches[0] for step in launches), launches


def test_graph_replays_add_the_captured_context_attentions(cuda):
    """make_scan_epoch's CUDA graph of a small two-tower step with the
    context self-attention (256 spectral bins: the spectra context's
    257x257 self-attention on K1/K2), over four one-step epochs: the warm-up
    step, the capture and its replay, then two replays. Every step adds the
    same launches to the counters: 2 towers x 2 blocks x 2 (the forward and
    remat's re-run) to ``ctx attn``, none to ``LN plain``."""
    from vaesne_tpu_torch.data import make_goldstein_like, multimodal_tuple
    from vaesne_tpu_torch.models import ContraPhotSpec
    from vaesne_tpu_torch.ops import counters
    from vaesne_tpu_torch.training import make_scan_epoch

    model = init_params(ContraPhotSpec(latent_len=2, latent_dim=2, proj_dim=3, photo_num_layers=2,
                                       spec_num_layers=2, selfattn=True),
                        torch.Generator().manual_seed(0))
    opt = adamw(1e-3)
    state = TrainState.create(model, opt, seed=0)
    epoch = make_scan_epoch(model, opt, objectives.as_loss(objectives.neg_info_nce,
                                                           temperature=0.1))
    raw = make_goldstein_like(n=4, seed=1, spectrum_bins=256, photometry_length=12)
    batch = multimodal_tuple(raw, device=cuda)
    launches = []
    for i in range(4):
        before = counters.launch_counts()
        state, loss = epoch(state, batch, torch.Generator().manual_seed(i), 4)
        after = counters.launch_counts()
        launches.append({k: after[k] - before[k] for k in after if k != "captures"})
        assert np.isfinite(float(loss))
    assert launches[0]["ctx attn"] == 8 and launches[0]["LN plain"] == 0
    assert launches[0]["K1"] == 4 and launches[0]["K2"] == 2
    assert all(step == launches[0] for step in launches), launches


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
    replays), against the DDP step loop (``torch_dp_workers.ddp_epoch``:
    torch's DistributedDataParallel): losses, parameters, AdamW moments,
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


# LayerNorm (ops/layer_norm.py, csrc/layer_norm.cu): the kernels against
# F.layer_norm and against the plain formula (benchmark/reference's
# layer_norm) in fp32, forward max-abs 1e-5; gradients against autograd of
# the formula in fp64, 1e-4 of max |fp64| (dγ and dβ are sums over every
# row)

LN_ROWS = [1, 1000, 1001, 502_784]  # one row; a last tile part filled; the ZTF decoder's


def _ln_inputs(device, rows, n, seed):
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(rows, n, device=device, generator=g) * 2.0 + 0.5
    w = 1.0 + 0.1 * torch.randn(n, device=device, generator=g)
    b = 0.1 * torch.randn(n, device=device, generator=g)
    dy = torch.randn(rows, n, device=device, generator=g)
    return x, w, b, dy


def _ln_formula(x, w, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def _ln_run(fn, x, w, b, dy):
    """(y, dx, dγ, dβ) of ``fn(x, w, b)`` with output gradient dy."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    y = fn(*leaves)
    y.backward(dy)
    return (y.detach(), *(t.grad for t in leaves))


def _ln_kernel(x, w, b):
    return layer_norm.layer_norm(x, (x.shape[-1],), w, b, 1e-5)


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("rows", LN_ROWS)
def test_layer_norm_kernels_match_torch_and_the_formula(cuda, rows, n):
    x, w, b, dy = _ln_inputs(cuda, rows, n, rows + n)
    before = (layer_norm.launches, layer_norm.bwd_launches, layer_norm.plain_calls)
    got = _ln_run(_ln_kernel, x, w, b, dy)
    torch.cuda.synchronize()
    assert (layer_norm.launches, layer_norm.bwd_launches, layer_norm.plain_calls) == (
        before[0] + 1, before[1] + 1, before[2])
    with torch.inference_mode():  # no graph to record: the forward kernel alone
        assert torch.equal(_ln_kernel(x, w, b), got[0])
    assert layer_norm.launches == before[0] + 2
    torch_ = _ln_run(lambda x, w, b: F.layer_norm(x, (n,), w, b, 1e-5), x, w, b, dy)
    assert (got[0] - torch_[0]).abs().max().item() <= 1e-5
    assert (got[0] - _ln_formula(x, w, b)).abs().max().item() <= 1e-5
    exact = _ln_run(_ln_formula, x.double(), w.double(), b.double(), dy.double())
    for name, mine, want in zip(("dx", "dgamma", "dbeta"), got[1:], exact[1:]):
        assert _rel(mine, want) <= 1e-4, name


@pytest.mark.parametrize("n", [16, 128])
def test_layer_norm_other_widths_take_f_layer_norm(cuda, n):
    """A width with no instantiation (no tower runs at 16 or 128) is
    F.layer_norm itself, forward and gradients, and counts as plain."""
    x, w, b, dy = _ln_inputs(cuda, 3001, n, n)
    before = _counts()
    got = _ln_run(_ln_kernel, x, w, b, dy)
    assert tuple(c - a for a, c in zip(before, _counts()))[5:] == (0, 0, 1)
    want = _ln_run(lambda x, w, b: F.layer_norm(x, (n,), w, b, 1e-5), x, w, b, dy)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_layer_norm_copies_strided_and_misaligned_inputs(cuda):
    """A non-contiguous input, one 4 bytes off a 16-byte boundary and a
    transposed output gradient are copied first: the same bits as the
    contiguous call."""
    x, w, b, dy = _ln_inputs(cuda, 777, 32, 5)
    want = _ln_run(_ln_kernel, x, w, b, dy)
    wide = torch.zeros(777, 64, device=cuda)
    wide[:, 16:48] = x
    flat = torch.zeros(777 * 32 + 1, device=cuda)
    flat[1:] = x.reshape(-1)
    for base, view_of in ((wide, lambda t: t[:, 16:48]),
                          (flat, lambda t: t[1:].view(777, 32))):
        leaves = [t.detach().clone().requires_grad_() for t in (base, w, b)]
        view = view_of(leaves[0])
        assert not view.is_contiguous() or view.data_ptr() % 16
        y = layer_norm.layer_norm(view, (32,), leaves[1], leaves[2], 1e-5)
        grads = torch.autograd.grad(y, leaves, dy.t().contiguous().t())
        got = (y, view_of(grads[0]), grads[1], grads[2])
        assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_layer_norm_kernels_are_deterministic(cuda):
    """Two runs at the ZTF decoder's 502,784 rows: y, dx, dγ and dβ
    bitwise equal (the γ/β partials are added in a fixed order, no
    atomics)."""
    x, w, b, dy = _ln_inputs(cuda, 502_784, 32, 11)
    first, second = (_ln_run(_ln_kernel, x, w, b, dy) for _ in range(2))
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def test_layer_norm_graph_replay_is_the_eager_call(cuda):
    """The forward and backward captured in a CUDA graph: a replay gives
    the eager call's bits, also after new values in the static input; the
    capture counts no launch."""
    x, w, b, dy = _ln_inputs(cuda, 62_848, 32, 12)
    x2 = _ln_inputs(cuda, 62_848, 32, 13)[0]
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))

    def call():
        y = _ln_kernel(xs, ws, bs)
        return (y, *torch.autograd.grad(y, (xs, ws, bs), dy))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _counts()
    with torch.cuda.graph(graph):
        out = call()
    assert _counts()[5:] == (before[5] + 1, before[6] + 1, before[7])
    for values in (x, x2):
        with torch.no_grad():
            xs.copy_(values)
        graph.replay()
        torch.cuda.synchronize()
        want = _ln_run(_ln_kernel, values, w, b, dy)
        assert all(torch.equal(a, c) for a, c in zip(out, want))


def test_layer_norm_under_bf16_autocast_is_the_fp32_path(cuda):
    """Under bf16 autocast the kernels take the input cast to fp32 and give
    fp32, as autocast's F.layer_norm does: an fp32 input gives the fp32
    call's bits, forward and gradients; a bf16 input those of its fp32
    cast."""
    x, w, b, dy = _ln_inputs(cuda, 4096, 32, 14)
    want = _ln_run(_ln_kernel, x, w, b, dy)
    want16 = _ln_run(_ln_kernel, x.bfloat16().float(), w, b, dy)
    before = _counts()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        got = _ln_run(_ln_kernel, x, w, b, dy)
        y16 = _ln_kernel(x.bfloat16(), w, b)
    assert got[0].dtype == torch.float32 and y16.dtype == torch.float32
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    assert torch.equal(y16, want16[0])
    assert _counts()[5:] == (before[5] + 2, before[6] + 1, before[7])


def test_layer_norm_counters_and_the_plain_calls(cuda):
    """A TransformerStack of two blocks with a context, remat on: 6
    LayerNorm forwards, 6 more in remat's re-run and 6 backwards, all on
    the kernels; a width without an instantiation, a float64 input and a
    LayerNorm over two axes compute F.layer_norm and count as plain; a CPU
    call counts nowhere."""
    stack = init_params(TransformerStack(32, 4, 32, 2, dropout=0.0, remat=True),
                        torch.Generator().manual_seed(0)).to(cuda).train()
    g = torch.Generator(cuda).manual_seed(15)
    x = torch.randn(8, 60, 32, device=cuda, generator=g, requires_grad=True)
    ctx = torch.randn(8, 5, 32, device=cuda, generator=g)
    before = _counts()
    stack(x, ctx).square().sum().backward()
    torch.cuda.synchronize()
    assert tuple(b - a for a, b in zip(before, _counts()))[5:] == (12, 6, 0)
    before = _counts()
    for args in ((torch.randn(4, 48, device=cuda), (48,), torch.ones(48, device=cuda),
                  torch.zeros(48, device=cuda)),
                 (torch.randn(4, 32, device=cuda, dtype=torch.float64), (32,),
                  torch.ones(32, device=cuda, dtype=torch.float64),
                  torch.zeros(32, device=cuda, dtype=torch.float64)),
                 (torch.randn(4, 2, 16, device=cuda), (2, 16), torch.ones(2, 16, device=cuda),
                  torch.zeros(2, 16, device=cuda))):
        torch.testing.assert_close(layer_norm.layer_norm(*args, 1e-5),
                                   F.layer_norm(*args, 1e-5), rtol=0, atol=0)
    layer_norm.layer_norm(torch.randn(4, 32), (32,), torch.ones(32), torch.zeros(32))
    assert tuple(b - a for a, b in zip(before, _counts()))[5:] == (0, 0, 3)
