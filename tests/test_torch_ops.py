"""The PyTorch port's fused attention op (forward, dropout, backward) and
dispatch rule against the JAX package, on the CPU: the JAX Pallas kernels
run in interpret mode, the port's wrappers take their plain versions (CPU
tensors launch nothing). At rate 0.1 both use the JAX package's counter
hash, so they agree mask for mask. The suite's "highest" matmul precision
caps JAX's fp32 query tile at 512, so the grids keep Lq <= 512, where the
port's tile (up to 1024) seeds the same stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaesne_tpu.ops import fused_attention as jax_fused_attention
from vaesne_tpu.ops.attention import _hash_bits
from vaesne_tpu.ops.dispatch import env_flag as jax_env_flag
import vaesne_tpu_torch.ops.attention as port_attention
from vaesne_tpu_torch.ops import counters
from vaesne_tpu_torch.ops import (
    attention_backward_reference,
    attention_reference,
    env_flag,
    fused_attention,
    fused_attention_bwd,
    fused_attention_fwd,
    routes_to_kernel,
)


def _inputs(seed, R, H, Lq, Lk, Dh=8, masked=True, full_row=False):
    rng = np.random.default_rng(seed)
    E = H * Dh
    q = rng.normal(size=(R, Lq, E)).astype(np.float32)
    k = rng.normal(size=(R, Lk, E)).astype(np.float32)
    v = rng.normal(size=(R, Lk, E)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(R, Lk)) < 0.2
        if full_row:
            mask[0] = True
    return q, k, v, mask


def _jax_bias(mask, R, Lk):
    return jnp.asarray(np.zeros((R, Lk), np.float32) if mask is None
                       else np.where(mask, -1e9, 0.0).astype(np.float32))


def _packed(a):  # [R, L, E] <-> the JAX kernel's packed [R, E, L]
    return jnp.asarray(a).transpose(0, 2, 1)


def _jax_kernel(q, k, v, mask, H):
    """The JAX package's Pallas forward in interpret mode, as
    tests/test_ops.py runs it, on [R, L, E] inputs."""
    R, Lk = k.shape[:2]
    out = jax_fused_attention(_packed(q), _packed(k), _packed(v), _jax_bias(mask, R, Lk), H,
                              0.0, True)
    return np.asarray(out).transpose(0, 2, 1)


def _port(q, k, v, mask, H):
    m = None if mask is None else torch.from_numpy(mask)
    return fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), m, H)


@pytest.mark.parametrize("R,H,Lq,Lk,masked,full_row", [
    (2, 4, 200, 200, True, False),   # masked square grid
    (2, 4, 12, 5, False, False),     # decoder-like cross grid, no mask
    (2, 2, 6, 9, True, True),        # row 0 fully masked
])
def test_fused_attention_matches_jax_kernel(R, H, Lq, Lk, masked, full_row):
    q, k, v, mask = _inputs(0, R, H, Lq, Lk, masked=masked, full_row=full_row)
    before = port_attention.launches
    out = _port(q, k, v, mask, H)
    assert port_attention.launches == before  # CPU tensors launch no kernel
    assert out.dtype == torch.float32 and out.shape == (R, Lq, H * 8)
    np.testing.assert_allclose(out.numpy(), _jax_kernel(q, k, v, mask, H), atol=1e-5)
    m = None if mask is None else torch.from_numpy(mask)
    ref = attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), m, H)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_fully_masked_row_is_uniform_average():
    q, k, v, mask = _inputs(1, 2, 2, 6, 9, full_row=True)
    out = _port(q, k, v, mask, 2).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[0], np.broadcast_to(v[0].mean(0), out[0].shape),
                               atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, mask = _inputs(2, 2, 2, 4, 5)
    t = torch.from_numpy
    assert fused_attention(t(q), t(k), t(v), None, 4).shape == q.shape  # Dh 4
    with pytest.raises(ValueError, match="head dim"):  # Dh 6
        fused_attention(t(q[..., :12].copy()), t(k[..., :12].copy()),
                        t(v[..., :12].copy()), None, 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_attention(t(q).double(), t(k).double(), t(v).double(), None, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(t(q).transpose(0, 1).contiguous().transpose(0, 1),
                        t(k), t(v), None, 2)
    with pytest.raises(ValueError, match=r"\[R, Lk\]"):
        fused_attention(t(q), t(k), t(v), t(mask[:, :3]), 2)
    with pytest.raises(TypeError, match="bool"):
        fused_attention(t(q), t(k), t(v), t(mask).float(), 2)


# (rows, heads, Lq, Lk): the flagship grids at and around each threshold
ROUTING_CASES = [
    (1, 4, 982, 982), (800, 4, 982, 982),
    (1, 4, 256, 256), (1, 4, 255, 256),
    (3417, 4, 982, 5), (3416, 4, 982, 5),
    (4661, 4, 60, 60), (4660, 4, 60, 60),
    (69906, 4, 60, 4), (69905, 4, 60, 4),
    (12800, 4, 8, 983), (512, 4, 8, 61),
]


def test_routes_to_kernel_matches_jax_layer(monkeypatch):
    """The port routes exactly the grids for which the JAX layer lowers to
    its Pallas kernel (checked on the traced jaxpr, no compute)."""
    from vaesne_tpu.nn.layers import MultiHeadAttention

    key = jax.random.PRNGKey(0)
    mha = MultiHeadAttention(num_heads=4)
    monkeypatch.setenv("VAESNE_PALLAS", "0")
    variables = mha.init(key, jnp.zeros((1, 2, 32)), jnp.zeros((1, 3, 32)),
                         jnp.zeros((1, 3, 32)))
    monkeypatch.setenv("VAESNE_PALLAS", "1")
    for rows, heads, lq, lk in ROUTING_CASES:
        q = jax.ShapeDtypeStruct((rows, lq, 32), jnp.float32)
        kv = jax.ShapeDtypeStruct((rows, lk, 32), jnp.float32)
        jaxpr = str(jax.make_jaxpr(
            lambda p, q, kv: mha.apply(p, q, kv, kv))(variables, q, kv))
        assert routes_to_kernel(rows, heads, lq, lk) == ("pallas_call" in jaxpr), \
            (rows, heads, lq, lk)


@pytest.mark.parametrize("value", [None, "0", "false", "False", "1", "yes", ""])
def test_env_flag_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("VAESNE_TEST_FLAG", raising=False)
    else:
        monkeypatch.setenv("VAESNE_TEST_FLAG", value)
    for default in (True, False):
        assert env_flag("VAESNE_TEST_FLAG", default) == jax_env_flag("VAESNE_TEST_FLAG", default)


DROPOUT_CASES = [
    (2, 4, 200, 200, True, True),   # masked square grid, row 0 fully masked
    (2, 4, 12, 5, False, False),    # decoder-like cross grid, no mask
]


@pytest.mark.parametrize("R,H,Lq,Lk,masked,full_row", DROPOUT_CASES)
def test_dropout_attention_and_grads_match_jax_kernels(R, H, Lq, Lk, masked, full_row):
    """K1 at rate 0.1 and K2 (its gradients) against the JAX Pallas forward
    and backward kernels in interpret mode, mask for mask: outputs and
    dq/dk/dv within 1e-5."""
    q, k, v, mask = _inputs(3, R, H, Lq, Lk, masked=masked, full_row=full_row)
    dout = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    seed = 7
    out_j, vjp = jax.vjp(
        lambda q, k, v: jax_fused_attention(q, k, v, _jax_bias(mask, R, Lk), H, 0.1, True,
                                            jnp.int32(seed)),
        _packed(q), _packed(k), _packed(v))
    grads_j = [np.asarray(g).transpose(0, 2, 1) for g in vjp(_packed(dout))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    m = None if mask is None else torch.from_numpy(mask)
    before = (port_attention.launches, port_attention.bwd_launches)
    out = fused_attention(tq, tk, tv, m, H, 0.1, seed)
    out.backward(torch.from_numpy(dout))
    assert (port_attention.launches, port_attention.bwd_launches) == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j).transpose(0, 2, 1),
                               atol=1e-5)
    assert not np.allclose(out.detach().numpy(), _jax_kernel(q, k, v, mask, H), atol=1e-3)
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the wrappers' CPU paths are the plain versions of the same function
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for got, want in zip(fused_attention_bwd(*t, m, None, None, None, torch.from_numpy(dout),
                                             H, 0.1, seed),
                         attention_backward_reference(*t, m, torch.from_numpy(dout), H,
                                                      0.1, seed)):
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("seed,rows,heads,lq,lk", [(7, 2, 3, 300, 20), (2**31 - 9, 1, 2, 5, 9),
                                                    (-3, 3, 1, 130, 7)])
def test_dropout_keep_is_the_jax_hash(seed, rows, heads, lq, lk):
    """The plain keep mask against ``_hash_bits`` at the JAX kernel's seeding:
    block seed = seed + (r·H + h)·1024 + tile·(qt/128) in uint32 (seeds wrap
    as JAX's int32 does), 8-bit draw against round(256·rate)."""
    keep = port_attention.dropout_keep(seed, rows, heads, lq, lk, 0.1).numpy()
    qt = port_attention.hash_tile(lq)
    for r in range(rows):
        for h in range(heads):
            for t in range(-(-lq // qt)):
                block_seed = (seed + (r * heads + h) * 1024 + t * (qt // 128)) & 0xFFFFFFFF
                bits = np.asarray(_hash_bits(jnp.uint32(block_seed), (qt, lk))) >> 24
                want = bits >= 26
                got = keep[r, h, t * qt:(t + 1) * qt]
                np.testing.assert_array_equal(got, want[:got.shape[0]])


def test_dropout_keep_rate_and_threshold():
    """Keep probability 230/256 at rate 0.1 within 4σ over 2.6M draws; the
    threshold is JAX's round(256·rate), capped at 255."""
    assert [port_attention.drop_threshold(r) for r in (0.0, 0.1, 0.5, 0.999)] == \
        [0, 26, 128, 255]
    keep = port_attention.dropout_keep(123, 4, 4, 400, 410, 0.1)
    p, n = 230 / 256, keep.numel()
    assert abs(keep.double().mean().item() - p) <= 4 * (p * (1 - p) / n) ** 0.5


def test_forward_statistics_plain_version():
    """K1's saved row max and row sum (exp2 domain) on the CPU: m + log2(l)
    is the log2-sum-exp of the logits; a fully masked row has l = Lk."""
    q, k, v, mask = _inputs(5, 2, 2, 7, 9, full_row=True)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out, m, l = fused_attention_fwd(*t, torch.from_numpy(mask), 2, 0.0)
    torch.testing.assert_close(out, attention_reference(*t, torch.from_numpy(mask), 2))
    assert m.shape == l.shape == (2, 2, 7)
    torch.testing.assert_close(l[0], torch.full((2, 7), 9.0))
    logits = np.einsum("rqhd,rkhd->rhqk", q.reshape(2, 7, 2, 8), k.reshape(2, 9, 2, 8))
    logits = logits / np.sqrt(8) + np.where(mask, -1e9, 0.0)[:, None, None, :]
    lse2 = np.log2(np.exp(logits[1] - logits[1].max(-1, keepdims=True)).sum(-1)) \
        + logits[1].max(-1) * np.log2(np.e)
    np.testing.assert_allclose((m[1] + torch.log2(l[1])).numpy(), lse2, rtol=1e-5)


def test_dropout_needs_a_seed_and_a_rate_below_one():
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 1, 2, 4, 4, masked=False)[:3])
    mask = None
    with pytest.raises(ValueError, match="seed"):
        fused_attention(q, k, v, mask, 2, 0.1)
    with pytest.raises(ValueError, match="dropout_rate"):
        fused_attention(q, k, v, mask, 2, 1.0, 3)
    torch.testing.assert_close(fused_attention(q, k, v, mask, 2, 0.5, 3),
                               fused_attention(q, k, v, mask, 2, 0.5, 3))
    assert not torch.allclose(fused_attention(q, k, v, mask, 2, 0.5, 3),
                              fused_attention(q, k, v, mask, 2, 0.5, 4))


def test_misaligned_views_are_copied_for_the_kernels():
    """The kernels stage rows with 16-byte copies: a view whose data does
    not start on 16 bytes reaches them as an aligned copy, equal in value;
    an aligned tensor passes through as it is."""
    buf = torch.arange(65, dtype=torch.float32)
    view = buf[1:].view(2, 4, 8)
    assert view.data_ptr() % 16 != 0
    copy = port_attention._aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)
    aligned = torch.zeros(2, 4, 8)
    assert port_attention._aligned(aligned) is aligned


def test_pipelined_counter_moves_with_the_others_and_the_plain_path_leaves_it():
    """``K1 pipelined`` is one of the port's counters: read, set and added
    to (a graph replay's launches) with the others; CPU tensors take the
    plain version and count no launch."""
    counts = counters.launch_counts()
    assert counts["K1 pipelined"] == port_attention.pipelined_launches
    try:
        counters.set_launch_counts({"K1": 5, "K1 pipelined": 3})
        assert (port_attention.launches, port_attention.pipelined_launches) == (5, 3)
        counters.add_launch_counts({"K1": 8, "K1 rate>0": 0, "K1 pipelined": 8})
        after = counters.launch_counts()
        assert (after["K1"], after["K1 pipelined"]) == (13, 11)
        assert after["K2"] == counts["K2"] and after["K1 rate>0"] == counts["K1 rate>0"]
    finally:
        counters.set_launch_counts({k: counts[k] for k in ("K1", "K1 pipelined")})
    assert counters.launch_counts() == counts
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(4, 2, 4, 70, 982))
    for rate in (0.0, 0.1):
        fused_attention_fwd(q, k, v, mask, 4, rate, 3)
    assert counters.launch_counts() == counts


def test_bwd_pipelined_counter_moves_with_the_others_and_the_plain_path_leaves_it():
    """``K2 pipelined`` is one of the port's counters: read, set and added
    to (a graph replay's launches) with the others; CPU tensors take the
    plain backward and count no launch."""
    counts = counters.launch_counts()
    assert counts["K2 pipelined"] == port_attention.bwd_pipelined_launches
    try:
        counters.set_launch_counts({"K2": 5, "K2 pipelined": 3})
        assert (port_attention.bwd_launches, port_attention.bwd_pipelined_launches) == (5, 3)
        counters.add_launch_counts({"K2": 4, "K1": 0, "K2 pipelined": 4})
        after = counters.launch_counts()
        assert (after["K2"], after["K2 pipelined"]) == (9, 7)
        assert after["K1"] == counts["K1"] and after["K1 pipelined"] == counts["K1 pipelined"]
    finally:
        counters.set_launch_counts({k: counts[k] for k in ("K2", "K2 pipelined")})
    assert counters.launch_counts() == counts
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(4, 2, 4, 70, 982))
    dout = torch.ones_like(q)
    for rate in (0.0, 0.1):
        out, m, l = fused_attention_fwd(q, k, v, mask, 4, rate, 3)
        fused_attention_bwd(q, k, v, mask, out, m, l, dout, 4, rate, 3)
    assert counters.launch_counts() == counts
