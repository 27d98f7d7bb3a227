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
    """Eval mode needs no seed and drops nothing; train mode draws every
    mask from the seed it is given (the same seed, the same output) and
    refuses to run without one."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 6, 16)).astype(np.float32))
    ctx = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(np.float32))
    m = tnn.TransformerBlock(16, 2, 16, dropout=0.5).eval()
    torch.testing.assert_close(m(x, ctx), m(x, ctx))
    torch.testing.assert_close(m(x, ctx, seed=1), m(x, ctx))
    m.train()
    a = m(x, ctx, seed=1)
    torch.testing.assert_close(a, m(x, ctx, seed=1))
    assert not torch.allclose(a, m(x, ctx, seed=2))
    with pytest.raises(ValueError, match="needs a seed"):
        m(x, ctx)


@pytest.mark.parametrize("lq,lk", [(6, 9), (256, 256)])
def test_attention_dropout_is_the_kernel_mask(lq, lk):
    """Train-mode attention dropout on a grid routed to the kernels drops
    exactly the weights the kernels' hash drops: the layer equals its
    projections around ``attention_reference`` with the same seed. A grid
    on the plain path drops the softmax weights with the seeded
    ``dropout`` helper instead; both are functions of the seed alone."""
    from vaesne_tpu_torch.ops import (attend, attention_reference, attention_weights,
                                      routes_to_kernel)
    from vaesne_tpu_torch.nn.layers import dropout

    q, kv, mask = _attn_case(8, B=1, Lq=lq, Lk=lk)
    mha = tnn.MultiHeadAttention(32, 4, dropout=0.3).train()
    t = [_t(a) for a in (q, kv, mask)]
    qp, kp, vp = mha.q_proj(t[0]), mha.k_proj(t[1]), mha.v_proj(t[1])
    if routes_to_kernel(1, 4, lq, lk):
        inner = attention_reference(qp, kp, vp, t[2], 4, 0.3, 9)
    else:
        inner = attend(dropout(attention_weights(qp, kp, t[2], 4), 0.3, 9), vp, 4)
        assert not torch.allclose(inner, attention_reference(qp, kp, vp, t[2], 4, 0.3, 9))
    got = mha(t[0], t[1], t[1], t[2], seed=9)
    torch.testing.assert_close(got, mha.out_proj(inner))
    torch.testing.assert_close(got, mha(t[0], t[1], t[1], t[2], seed=9))


def test_remat_keeps_outputs_and_gradients():
    """A stack rematerialised in the backward gives the outputs and
    gradients of one that is not, in train mode at dropout 0.1."""
    rng = np.random.default_rng(9)
    x = _t(rng.normal(size=(2, 7, 16)).astype(np.float32))
    ctx = _t(rng.normal(size=(2, 3, 16)).astype(np.float32))
    stack = tnn.TransformerStack(16, 2, 16, 2, dropout=0.1).train()
    results = []
    for remat in (True, False):
        stack.remat = remat
        stack.zero_grad(set_to_none=True)
        out = stack(x, ctx, seed=4)
        out.square().sum().backward()
        results.append((out.detach(), [p.grad.clone() for p in stack.parameters()]))
    torch.testing.assert_close(results[0][0], results[1][0])
    for a, b in zip(results[0][1], results[1][1]):
        torch.testing.assert_close(a, b)


def test_embed_matches_nn_embedding_and_its_gradient():
    """``embed`` looks rows up as nn.Embedding does; its weight gradient (a
    one-hot product, the same bits in every run on the card) equals
    nn.Embedding's, here past the 3072 indices where that changes path."""
    from vaesne_tpu_torch.nn.layers import embed

    table = torch.nn.Embedding(6, 16)
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 6, (64, 60)))
    grad = torch.randn(64, 60, 16, generator=torch.Generator().manual_seed(1))
    out = embed(table, idx)
    torch.testing.assert_close(out, table(idx), rtol=0, atol=0)
    (got,) = torch.autograd.grad(out, table.weight, grad)
    (want,) = torch.autograd.grad(table(idx), table.weight, grad)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
