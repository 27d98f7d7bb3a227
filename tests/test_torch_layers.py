"""Layer parity of the PyTorch port against the JAX package on the CPU: the
same numpy inputs and the same (bridged) weights through both, fp32,
atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaesne_tpu import nn as jnn
from vaesne_tpu_torch import nn as tnn
from vaesne_tpu_torch.utils import load_jax_params

ATOL = 1e-5


def _bridge(jax_module, torch_module, *init_args, **init_kwargs):
    """Init the flax module, copy its params into the torch module."""
    variables = jax_module.init(jax.random.PRNGKey(0), *init_args, **init_kwargs)
    params = jax.tree_util.tree_map(np.asarray, variables)
    load_jax_params(torch_module, params)
    return variables, torch_module.eval()


def _close(torch_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out), atol=atol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_sinusoidal_embeddings_match():
    rng = np.random.default_rng(0)
    x = rng.uniform(-3, 3, (2, 7)).astype(np.float32)
    _close(tnn.SinusoidalEmbedding(16)(_t(x)),
           jnn.SinusoidalEmbedding(16).apply({}, jnp.asarray(x)))
    jm, tm = jnn.SinusoidalMLPEmbedding(16), tnn.SinusoidalMLPEmbedding(16)
    variables, tm = _bridge(jm, tm, jnp.asarray(x))
    _close(tm(_t(x)), jm.apply(variables, jnp.asarray(x)))


def test_mlps_match():
    x = np.random.default_rng(1).normal(size=(3, 5, 12)).astype(np.float32)
    jm, tm = jnn.MLP(7, (16, 9)), tnn.MLP(12, 7, (16, 9))
    variables, tm = _bridge(jm, tm, jnp.asarray(x))
    _close(tm(_t(x)), jm.apply(variables, jnp.asarray(x)))
    jm, tm = jnn.SingleLayerMLP(3), tnn.SingleLayerMLP(12, 3)
    variables, tm = _bridge(jm, tm, jnp.asarray(x))
    _close(tm(_t(x)), jm.apply(variables, jnp.asarray(x)))


def _attn_case(seed, B=2, Lq=6, Lk=9, E=32, mask_kind="partial"):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, E)).astype(np.float32)
    kv = rng.normal(size=(B, Lk, E)).astype(np.float32)
    mask = None
    if mask_kind != "none":
        mask = rng.uniform(size=(B, Lk)) < 0.3
        if mask_kind == "full":
            mask[0] = True
    return q, kv, mask


@pytest.mark.parametrize("mask_kind", ["none", "partial", "full"])
def test_multihead_attention_matches(mask_kind):
    q, kv, mask = _attn_case(2, mask_kind=mask_kind)
    jm, tm = jnn.MultiHeadAttention(num_heads=4), tnn.MultiHeadAttention(32, 4)
    jmask = None if mask is None else jnp.asarray(mask)
    variables, tm = _bridge(jm, tm, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                            key_padding_mask=jmask)
    want = jm.apply(variables, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                    key_padding_mask=jmask)
    got = tm(_t(q), _t(kv), _t(kv), None if mask is None else _t(mask))
    assert np.isfinite(got.detach().numpy()).all()
    _close(got, want)


def test_multihead_attention_kernel_grid_matches_pallas(monkeypatch):
    """A 256x256 grid crosses 2^16: the JAX layer lowers to its Pallas
    kernel (interpret mode), the port routes to fused_attention (its plain
    version on the CPU)."""
    import vaesne_tpu_torch.ops.attention as port_attention
    from vaesne_tpu_torch.ops import routes_to_kernel

    monkeypatch.setenv("VAESNE_PALLAS", "1")
    monkeypatch.setenv("VAESNE_PALLAS_INTERPRET", "1")
    q, kv, mask = _attn_case(3, B=1, Lq=256, Lk=256)
    assert routes_to_kernel(1, 4, 256, 256)
    jm, tm = jnn.MultiHeadAttention(num_heads=4), tnn.MultiHeadAttention(32, 4)
    args = (jnp.asarray(q), jnp.asarray(q), jnp.asarray(q))
    variables, tm = _bridge(jm, tm, *args, key_padding_mask=jnp.asarray(mask))
    jaxpr = str(jax.make_jaxpr(lambda v: jm.apply(
        v, *args, key_padding_mask=jnp.asarray(mask)))(variables))
    assert "pallas_call" in jaxpr
    want = jm.apply(variables, *args, key_padding_mask=jnp.asarray(mask))
    before = port_attention.launches
    got = tm(_t(q), _t(q), _t(q), _t(mask))
    assert port_attention.launches == before
    _close(got, want)


@pytest.mark.parametrize("context_self_attn", [False, True])
def test_transformer_block_matches(context_self_attn):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    ctx = rng.normal(size=(2, 5, 16)).astype(np.float32)
    mask = rng.uniform(size=(2, 7)) < 0.3
    cmask = rng.uniform(size=(2, 5)) < 0.3
    jm = jnn.TransformerBlock(16, 2, 24, dropout=0.1, context_self_attn=context_self_attn)
    tm = tnn.TransformerBlock(16, 2, 24, dropout=0.1, context_self_attn=context_self_attn)
    jargs = (jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(mask), jnp.asarray(cmask))
    variables, tm = _bridge(jm, tm, *jargs)
    _close(tm(_t(x), _t(ctx), _t(mask), _t(cmask)), jm.apply(variables, *jargs))


def test_transformer_stack_matches():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 10, 32)).astype(np.float32)
    ctx = rng.normal(size=(3, 4, 32)).astype(np.float32)
    mask = rng.uniform(size=(3, 10)) < 0.3
    jm, tm = jnn.TransformerStack(32, 4, 32, 3), tnn.TransformerStack(32, 4, 32, 3)
    jargs = (jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(mask))
    variables, tm = _bridge(jm, tm, *jargs)
    _close(tm(_t(x), _t(ctx), _t(mask)), jm.apply(variables, *jargs))


def test_dropout_only_in_train_mode():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 6, 16)).astype(np.float32))
    ctx = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(np.float32))
    m = tnn.TransformerBlock(16, 2, 16, dropout=0.5).eval()
    torch.testing.assert_close(m(x, ctx), m(x, ctx))
    m.train()
    torch.manual_seed(1)
    a = m(x, ctx)
    torch.manual_seed(2)
    assert not torch.allclose(a, m(x, ctx))
