"""The PyTorch port's fused attention op and dispatch rule against the JAX
package, on the CPU: the JAX Pallas kernel runs in interpret mode, the
port's wrapper takes its plain version (CPU tensors launch nothing)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaesne_tpu.ops import fused_attention as jax_fused_attention
from vaesne_tpu.ops.dispatch import env_flag as jax_env_flag
import vaesne_tpu_torch.ops.attention as port_attention
from vaesne_tpu_torch.ops import attention_reference, env_flag, fused_attention, routes_to_kernel


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


def _jax_kernel(q, k, v, mask, H):
    """The JAX package's Pallas forward in interpret mode, as
    tests/test_ops.py runs it, on [R, L, E] inputs."""
    R, Lk = k.shape[:2]
    bias = (np.zeros((R, Lk), np.float32) if mask is None
            else np.where(mask, -1e9, 0.0).astype(np.float32))
    t = lambda a: jnp.asarray(a).transpose(0, 2, 1)  # noqa: E731
    out = jax_fused_attention(t(q), t(k), t(v), jnp.asarray(bias), H, 0.0, True)
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
