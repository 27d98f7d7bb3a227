"""The port's auxiliary blocks (``vaesne_tpu_torch/nn/extras.py``) against
the JAX package's on the CPU, on numpy-seeded inputs and weights bridged
from the flax tree (``load_jax_params``): ``flatten``/``reshape``,
``LearnableFourierEncoding`` (its ``freq`` has no bias),
``RelativePosition``, ``RelativeMultiHeadAttention`` (masked where the mask
is 0, at −1e10; a fully masked row), ``GumbelSoftmax`` on the same uniform
draw (soft, hard, and the straight-through gradient) and
``TransformerModel`` on the fused-attention path (the JAX Pallas kernel in
interpret mode) and off it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.nn.extras as jextras
import vaesne_tpu_torch.nn.layers as layers
from vaesne_tpu_torch.nn import (
    GumbelSoftmax,
    LearnableFourierEncoding,
    RelativeMultiHeadAttention,
    RelativePosition,
    TransformerModel,
    flatten,
    reshape,
)
from vaesne_tpu_torch.utils import init_params, load_jax_params, to_jax_params

TOL = 1e-5


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-6))


def _bridged(jm, tm, *example, rngs=None):
    """Initialise ``jm`` (flax) on ``example`` and load its tree into the
    port's ``tm``; returns the flax variables."""
    keys = {"params": jax.random.PRNGKey(0), **(rngs or {})}
    variables = jax.tree_util.tree_map(np.asarray, jm.init(keys, *example))
    load_jax_params(tm, variables)
    return variables


def test_flatten_and_reshape_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 4)).astype(np.float32)
    flat = flatten(torch.from_numpy(x))
    np.testing.assert_array_equal(flat.numpy(), jextras.flatten(jnp.asarray(x)))
    np.testing.assert_array_equal(reshape(flat, (3, 4)).numpy(),
                                  jextras.reshape(jnp.asarray(flat.numpy()), (3, 4)))


def test_learnable_fourier_encoding_matches_jax():
    """``freq`` is a Dense without bias on both sides: the bridge fills
    its weight alone (a bias would leave a port key unfilled, or a flax
    leaf unused, and raise), and the output is fc2(relu(fc1([sin, cos])))."""
    x = np.random.default_rng(1).uniform(-1, 1, size=(3, 10)).astype(np.float32)
    tm = LearnableFourierEncoding(dim=8)
    variables = _bridged(jextras.LearnableFourierEncoding(dim=8), tm, jnp.asarray(x))
    assert set(variables["params"]["freq"]) == {"kernel"} and tm.freq.bias is None
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want = jextras.LearnableFourierEncoding(dim=8).apply(variables, jnp.asarray(x))
    assert got.shape == (3, 10, 8)
    assert _rel(got, want) <= TOL
    back = to_jax_params(tm)["params"]
    np.testing.assert_array_equal(back["freq"]["kernel"], variables["params"]["freq"]["kernel"])


@pytest.mark.parametrize("lq,lk", [(5, 5), (3, 7)])
def test_relative_position_matches_jax(lq, lk):
    tm = RelativePosition(num_units=4, max_relative_position=2)
    init_params(tm, torch.Generator().manual_seed(0))
    table = tm.embeddings_table.detach().numpy()
    got = tm(lq, lk)
    want = jextras.RelativePosition(4, 2).apply(
        {"params": {"embeddings_table": jnp.asarray(table)}}, lq, lk)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert tm.index(lq, lk) is tm.index(lq, lk)  # built once per (Lq, Lk)
    np.testing.assert_array_equal(got[0, lk - 1].detach().numpy(), table[min(lk - 1, 2) + 2])


def _relative_pair(rng, B=3, LQ=7, LK=9, E=16, H=4):
    tm = RelativeMultiHeadAttention(E, H, dropout=0.0).eval()
    jm = jextras.RelativeMultiHeadAttention(num_heads=H, dropout=0.0)
    q = rng.normal(size=(B, LQ, E)).astype(np.float32)
    kv = rng.normal(size=(B, LK, E)).astype(np.float32)
    variables = _bridged(jm, tm, *(jnp.asarray(a) for a in (q, kv, kv)))
    return tm, jm, variables, q, kv


@pytest.mark.parametrize("case", ["none", "keys", "queries", "full_row"])
def test_relative_attention_matches_jax(case):
    """Without a mask, with key masks [B, 1, 1, Lk], with per-query masks
    [B, 1, Lq, Lk], and with every key of one event masked (its rows
    average v uniformly on both sides). The mask is 0 where masked."""
    rng = np.random.default_rng(2)
    tm, jm, variables, q, kv = _relative_pair(rng)
    B, LQ, LK = q.shape[0], q.shape[1], kv.shape[1]
    mask = None
    if case == "keys":
        mask = rng.uniform(size=(B, 1, 1, LK)) > 0.3
        mask[..., 0] = True
    elif case == "queries":
        mask = rng.uniform(size=(B, 1, LQ, LK)) > 0.3
        mask[..., 0] = True
    elif case == "full_row":
        mask = rng.uniform(size=(B, 1, 1, LK)) > 0.3
        mask[0] = False
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (q, kv, kv)),
                 mask=None if mask is None else torch.from_numpy(mask))
    want = jm.apply(variables, *(jnp.asarray(a) for a in (q, kv, kv)),
                    mask=None if mask is None else jnp.asarray(mask))
    assert got.shape == (B, LQ, q.shape[2])
    assert _rel(got, want) <= TOL
    if mask is not None:  # the sense is the reverse of a key-padding mask
        with torch.no_grad():
            flipped = tm(*(torch.from_numpy(a) for a in (q, kv, kv)),
                         mask=torch.from_numpy(~mask))
        assert _rel(flipped, want) > 1e-2


def test_relative_attention_masks_at_minus_1e10():
    """Unmasked logits of −3e9 (equal for every key): a −1e9 fill would
    put all the weight on the masked keys; −1e10 leaves the weights
    uniform over the unmasked ones, in the port as in JAX."""
    rng = np.random.default_rng(3)
    tm, jm, variables, q, kv = _relative_pair(rng, B=2, LQ=3, LK=6, E=4, H=1)
    params = variables["params"]
    for name, bias in (("fc_q", [3e4, 0, 0, 0]), ("fc_k", [-2e5, 0, 0, 0])):
        params[name]["kernel"] = np.zeros_like(params[name]["kernel"])
        params[name]["bias"] = np.asarray(bias, np.float32)
    for name in ("relative_position_k", "relative_position_v"):
        params[name]["embeddings_table"] = np.zeros_like(params[name]["embeddings_table"])
    load_jax_params(tm, variables)
    mask = np.ones((2, 1, 1, 6), bool)
    mask[..., 3:] = False
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (q, kv, kv)), mask=torch.from_numpy(mask))
        want_port = tm.fc_o(tm.fc_v(torch.from_numpy(kv))[:, :3].mean(1, keepdim=True))
    want = jm.apply(variables, *(jnp.asarray(a) for a in (q, kv, kv)), mask=jnp.asarray(mask))
    assert _rel(got, want) <= TOL
    assert _rel(got, want_port.expand_as(got)) <= TOL


def test_relative_attention_dropout_and_heads():
    """In train mode the weights drop with a mask drawn from ``seed`` (the
    same seed, the same output; none raises); eval mode drops nothing; an
    embedding that the heads do not divide raises the JAX message."""
    with pytest.raises(ValueError, match="embed dim 10 not divisible by 4 heads"):
        RelativeMultiHeadAttention(10, 4)
    tm = init_params(RelativeMultiHeadAttention(8, 2, dropout=0.5),
                     torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(1))
    a, b, c = tm(x, x, x, seed=3), tm(x, x, x, seed=3), tm(x, x, x, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="seed"):
        tm(x, x, x)
    tm.eval()
    assert torch.equal(tm(x, x, x), tm(x, x, x, seed=3))


class TestGumbelSoftmax:
    """The port against ``vaesne_tpu.nn.extras.GumbelSoftmax`` on the same
    uniform draw: the JAX module's draw is recorded and handed to the port
    as ``u``."""

    def setup_method(self):
        self.x = np.random.default_rng(0).normal(size=(4, 7)).astype(np.float32)
        self.jm = jextras.GumbelSoftmax(c_dim=5)
        self.tm = GumbelSoftmax(7, 5)
        self.variables = _bridged(self.jm, self.tm, jnp.asarray(self.x),
                                  rngs={"gumbel": jax.random.PRNGKey(1)})

    def _jax(self, params, hard, temperature=1.0, draws=None):
        original = jax.random.uniform

        def recording(*args, **kwargs):
            u = original(*args, **kwargs)
            if draws is not None:
                draws.append(np.asarray(u))
            return u
        jax.random.uniform = recording
        try:
            return self.jm.apply(params, jnp.asarray(self.x), temperature, hard,
                                 rngs={"gumbel": jax.random.PRNGKey(7)})
        finally:
            jax.random.uniform = original

    def _draw(self):
        draws = []
        self._jax(self.variables, False, draws=draws)
        return torch.from_numpy(np.array(draws[0]))

    @pytest.mark.parametrize("hard", [False, True])
    def test_values_match_jax(self, hard):
        u = self._draw()
        logits, probs, y = self.tm(torch.from_numpy(self.x), 0.5, hard, u=u)
        want = self._jax(self.variables, hard, 0.5)
        for got, w in zip((logits, probs, y), want):
            assert got.shape == (4, 5) and _rel(got.detach(), w) <= TOL
        if hard:
            assert torch.equal(y.detach().sort(-1).values[:, :-1], torch.zeros(4, 4))
            torch.testing.assert_close(y.detach().max(-1).values, torch.ones(4), rtol=0,
                                       atol=1e-6)

    def test_straight_through_gradient(self):
        """The hard sample's gradient is the soft sample's, in the port and
        in JAX, and the two packages agree."""
        u = self._draw()
        w = np.random.default_rng(1).normal(size=(4, 5)).astype(np.float32)

        def port_grads(hard):
            self.tm.zero_grad()
            *_, y = self.tm(torch.from_numpy(self.x), 1.0, hard, u=u)
            (y * torch.from_numpy(w)).sum().backward()
            return {n: p.grad.clone() for n, p in self.tm.named_parameters()}

        soft, hard = port_grads(False), port_grads(True)
        for name in soft:
            assert _rel(hard[name], soft[name]) <= TOL
        jgrads = jax.grad(lambda p: (self._jax(p, True)[2] * w).sum())(self.variables)
        bridged = to_jax_params(self.tm, hard)["params"]["logits"]
        for leaf in ("kernel", "bias"):
            assert _rel(bridged[leaf], jgrads["params"]["logits"][leaf]) <= TOL

    def test_draws_from_an_explicit_generator(self):
        x = torch.from_numpy(self.x)
        a = self.tm(x, generator=torch.Generator().manual_seed(5))[2]
        b = self.tm(x, generator=torch.Generator().manual_seed(5))[2]
        assert torch.equal(a, b)
        with pytest.raises(ValueError, match="generator"):
            self.tm(x)


@pytest.mark.parametrize("length,routed", [(12, False), (256, True)])
@pytest.mark.parametrize("selfattn", [True, False])
def test_transformer_model_matches_jax(monkeypatch, length, routed, selfattn):
    """Two blocks over [2, L, 16] with a key-padding mask and a 5-token
    context. At L = 256 the self-attention grid (65,536 points) routes to
    the fused attention in both packages (the port's plain version on the
    CPU, the JAX Pallas kernel in interpret mode); at L = 12 neither
    routes. Within 1e-5 of the largest JAX value."""
    monkeypatch.setenv("VAESNE_PALLAS", "1")
    monkeypatch.setenv("VAESNE_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, length, 16)).astype(np.float32)
    ctx = rng.normal(size=(2, 5, 16)).astype(np.float32)
    mask = rng.uniform(size=(2, length)) < 0.2
    cmask = np.zeros((2, 5), bool)
    cmask[1, -1] = True
    kw = dict(embed_dim=16, num_heads=2, ff_dim=16, num_layers=2, dropout=0.1,
              selfattn=selfattn)
    jm, tm = jextras.TransformerModel(**kw), TransformerModel(**kw).eval()
    args = [jnp.asarray(a) for a in (x, ctx, mask, cmask)]
    variables = _bridged(jm, tm, *args)
    assert set(variables["params"]) == {"layers"}
    routes = []
    real = layers.fused_attention
    monkeypatch.setattr(layers, "fused_attention",
                        lambda q, *a: routes.append(q.shape[1]) or real(q, *a))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (x, ctx, mask, cmask)))
    want = jm.apply(variables, *args)
    assert got.shape == x.shape
    assert routes == ([length] * 2 if routed else [])
    assert _rel(got, want) <= TOL


def test_transformer_model_trains_with_a_seed():
    """In train mode at a routed shape the stack's seed fixes every
    dropout mask (the kernel path's hash and the generator sites): the
    same seed gives the same output and gradients."""
    tm = init_params(TransformerModel(16, 2, 16, 2), torch.Generator().manual_seed(0))
    x = torch.randn(1, 256, 16, generator=torch.Generator().manual_seed(1))
    ctx = torch.randn(1, 5, 16, generator=torch.Generator().manual_seed(2))

    def run(seed):
        tm.zero_grad()
        out = tm(x, ctx, seed=seed)
        out.square().sum().backward()
        return out.detach(), [p.grad.clone() for p in tm.parameters()]

    (a, ga), (b, gb), (c, _) = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert all(torch.equal(g, h) for g, h in zip(ga, gb))
    with pytest.raises(ValueError, match="seed"):
        tm(x, ctx)
