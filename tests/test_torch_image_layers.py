"""The image towers of the PyTorch port against the JAX package on the CPU:
the 2-D sin-cos grid, the patch embedding, the weight bridge's conv case,
the encoder and both decoders, on the same numpy inputs and bridged random
weights (random kernels catch any spatial transposition). fp32, max-abs
within 1e-5 of the largest JAX output (``_close``) unless a test says why
not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from torch import nn

import vaesne_tpu_torch.nn.layers as tlayers
from vaesne_tpu import nn as jnn
from vaesne_tpu.nn import image_layers as jimg
from vaesne_tpu.nn.layers import sinusoidal_embedding_2d as jax_grid
from vaesne_tpu_torch import nn as tnn
from vaesne_tpu_torch.ops import routes_to_kernel
from vaesne_tpu_torch.utils import init_params, load_jax_params, to_jax_params

RTOL = 1e-5
TOWER = dict(model_dim=8, num_heads=2, ff_dim=8, num_layers=2)


def _random_tree(variables, seed):
    """Every leaf of a flax tree replaced by numpy draws of σ 0.3."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32), variables)


def _bridge(jax_module, torch_module, *args, seed=0, **kwargs):
    """Init the flax module, randomise its tree, bridge it into the torch
    module (eval mode)."""
    variables = jax_module.init(jax.random.PRNGKey(0), *args, **kwargs)
    variables = _random_tree(variables, seed)
    load_jax_params(torch_module, variables)
    return variables, torch_module.eval()


def _close(got, want, rtol=RTOL):
    """max |got − want| ≤ rtol · max |want|."""
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _nhwc(a):
    return jnp.asarray(np.transpose(a, (0, 2, 3, 1)))


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


@pytest.mark.parametrize("d_model,h,w", [(8, 5, 7), (32, 30, 30), (4, 1, 3)])
def test_sinusoidal_embedding_2d_values(d_model, h, w):
    """[H·W, d] in row-major (h, w) order, within 1e-6 (sin and cos of
    coordinates up to 30)."""
    got = tlayers.sinusoidal_embedding_2d(d_model, h, w)
    assert got.shape == (h * w, d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_grid(d_model, h, w)), rtol=0,
                               atol=1e-6)


def test_sinusoidal_embedding_2d_needs_d_model_divisible_by_4():
    for module in (tlayers, jnn.layers):
        with pytest.raises(ValueError, match="divisible by 4"):
            module.sinusoidal_embedding_2d(6, 3, 3)


@pytest.mark.parametrize("patch,channels", [(2, 3), (3, 1), (4, 3)])
def test_patch_embedding_matches(patch, channels):
    img = np.random.default_rng(patch).normal(size=(2, channels, 12, 12)).astype(np.float32)
    jm, tm = jnn.PatchEmbedding(patch, 8), tnn.PatchEmbedding(patch, channels, 8)
    variables, tm = _bridge(jm, tm, _nhwc(img), seed=patch)
    got = tm(torch.from_numpy(img))
    assert got.shape == (2, (12 // patch) ** 2, 8)
    _close(got, jm.apply(variables, _nhwc(img)))


class _JaxStridedConv(fnn.Module):
    kernel: int
    stride: int

    @fnn.compact
    def __call__(self, x):
        return fnn.Conv(5, (self.kernel, self.kernel), strides=self.stride, padding="VALID",
                        name="conv")(x)


class _TorchStridedConv(nn.Module):
    def __init__(self, kernel, stride):
        super().__init__()
        self.conv = nn.Conv2d(3, 5, kernel, stride=stride)

    def forward(self, x):
        return tlayers.conv2d(x, self.conv)


@pytest.mark.parametrize("kernel,stride", [(2, 1), (3, 1), (2, 2), (3, 3)])
def test_conv_values_and_gradients_match_flax(kernel, stride):
    """``layers.conv2d`` (the port's convolution: the layer's own Conv2d,
    run under ``cudnn_fp32_deterministic``) against flax's Conv on bridged
    random weights: values and the gradients of input, kernel and bias,
    within 1e-5 relative. The flags hold while the layer runs."""
    img = np.random.default_rng(kernel).normal(size=(2, 3, 9, 12)).astype(np.float32)
    jm, tm = _JaxStridedConv(kernel, stride), _TorchStridedConv(kernel, stride)
    variables, tm = _bridge(jm, tm, _nhwc(img), seed=kernel + stride)
    flags = []
    tm.conv.register_forward_hook(lambda *_: flags.append((
        torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic,
        torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)))
    x = torch.from_numpy(img).requires_grad_()
    got = tm(x)
    assert flags == [(True, True, False, False)]
    want = jm.apply(variables, _nhwc(img))
    _close(got, _nchw(want))
    g = np.random.default_rng(3).normal(size=got.shape).astype(np.float32)
    got_grads = torch.autograd.grad(got, (x, tm.conv.weight, tm.conv.bias), torch.from_numpy(g))

    def loss(params, x_nhwc):
        return jnp.sum(jm.apply(params, x_nhwc) * _nhwc(g))

    dparams, dx = jax.grad(loss, argnums=(0, 1))(variables, _nhwc(img))
    conv = dparams["params"]["conv"]
    _close(got_grads[0], _nchw(dx))
    _close(got_grads[1], np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
    _close(got_grads[2], conv["bias"])


class _JaxConv(fnn.Module):
    kernel: int

    @fnn.compact
    def __call__(self, x):
        return fnn.Conv(5, (self.kernel, self.kernel), padding="SAME", name="conv")(x)


class _TorchConv(nn.Module):
    def __init__(self, kernel):
        super().__init__()
        self.conv = nn.Conv2d(3, 5, kernel)
        lo = (kernel - 1) // 2
        self.same = (lo, kernel - 1 - lo) * 2

    def forward(self, x):
        return self.conv(F.pad(x, self.same))


@pytest.mark.parametrize("kernel", [2, 3, 4])
def test_bridge_maps_square_conv_kernels_by_permutation(kernel):
    """A flax Conv kernel [kh, kw, in, out] loads as [out, in, kh, kw]. For
    a square kernel its transpose [out, in, kw, kh] has the same shape and
    other outputs, so only the values can tell; the bridge gives flax's
    outputs (within 1e-5 relative) and ``to_jax_params`` returns the kernel
    bitwise."""
    img = np.random.default_rng(kernel).normal(size=(2, 3, 9, 9)).astype(np.float32)
    jm, tm = _JaxConv(kernel), _TorchConv(kernel)
    variables, tm = _bridge(jm, tm, _nhwc(img), seed=kernel)
    want = _nchw(jm.apply(variables, _nhwc(img)))
    _close(tm(torch.from_numpy(img)), want)
    back = to_jax_params(tm)["params"]["conv"]
    for leaf in ("kernel", "bias"):
        np.testing.assert_array_equal(back[leaf], variables["params"]["conv"][leaf])
    kernel_t = torch.from_numpy(variables["params"]["conv"]["kernel"].T.copy())
    assert kernel_t.shape == tm.conv.weight.shape
    with torch.no_grad():
        tm.conv.weight.copy_(kernel_t)
    assert np.abs(tm(torch.from_numpy(img)).detach().numpy() - want).max() > 1e-2


def _image_vae_tree(seed, **kw):
    from vaesne_tpu.models import HostImgVAE

    jm = HostImgVAE(img_size=12, latent_len=2, latent_dim=2, **TOWER, **kw)
    x = (jnp.zeros((2, 3, 12, 12)), jnp.zeros((2, 2)))
    key = jax.random.PRNGKey(0)
    return _random_tree(jm.init({"params": key, "sample": key}, x, 1), seed)


@pytest.mark.parametrize("hybrid,patch", [(True, 2), (True, 3), (False, 4)])
def test_bridge_round_trip_of_an_image_vae_is_bitwise(hybrid, patch):
    """flax tree → port → flax tree is the identity, leaf for leaf, for a
    tree with square conv kernels (patch embedding, refine_0, refine_1)."""
    from vaesne_tpu_torch.models import HostImgVAE

    kw = dict(hybrid=hybrid, patch_size=patch, focal_loc=True)
    tree = _image_vae_tree(patch, **kw)
    model = HostImgVAE(img_size=12, latent_len=2, latent_dim=2, **TOWER, **kw)
    load_jax_params(model, tree)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(to_jax_params(model))[0])
    assert len(got) == len(flat)
    kernels = 0
    for path, value in flat:
        assert got[path].shape == value.shape
        np.testing.assert_array_equal(got[path], value)
        kernels += value.ndim == 4
    assert kernels == (3 if hybrid else 1)


def test_init_params_draws_conv_kernels_as_flax_does():
    """Conv weights lecun-normal (σ² = 1/fan_in, truncated at ±2σ of the
    untruncated normal), biases 0, seeded; the sample σ within 5% over
    4,608 draws."""
    a, b = tnn.PatchEmbedding(4, 3, 96), tnn.PatchEmbedding(4, 3, 96)
    init_params(a, torch.Generator().manual_seed(7))
    init_params(b, torch.Generator().manual_seed(7))
    w = a.proj.weight
    assert torch.equal(w, b.proj.weight) and bool((a.proj.bias == 0).all())
    fan_in = 3 * 4 * 4
    assert abs(w.std().item() * fan_in ** 0.5 - 1.0) <= 0.05
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / fan_in ** 0.5


@pytest.mark.parametrize("focal_loc,sincosin", [(False, True), (True, True), (False, False)])
def test_encoder_matches(focal_loc, sincosin):
    """The encoder with and without the event-location tokens, and with a
    learned ``pos_embed`` in place of the sin-cos grid."""
    rng = np.random.default_rng(3)
    img = rng.normal(size=(3, 3, 12, 12)).astype(np.float32)
    loc = rng.normal(size=(3, 2)).astype(np.float32)
    kw = dict(img_size=12, bottleneck_length=4, bottleneck_dim=2, patch_size=3,
              focal_loc=focal_loc, sincosin=sincosin, **TOWER)
    jm, tm = jimg.HostImgTransformerEncoder(**kw), tnn.HostImgTransformerEncoder(**kw)
    variables, tm = _bridge(jm, tm, _nhwc(img), jnp.asarray(loc), seed=4)
    got = tm(torch.from_numpy(img), torch.from_numpy(loc))
    assert got.shape == (3, 4, 2)
    _close(got, jm.apply(variables, _nhwc(img), jnp.asarray(loc)))
    if focal_loc:  # no event_loc: zeros, in both packages
        _close(tm(torch.from_numpy(img)), jm.apply(variables, _nhwc(img)))


DECODERS = [
    ("hybrid", jimg.HostImgTransformerDecoderHybrid, tnn.HostImgTransformerDecoderHybrid,
     dict(patch_size=2)),
    ("hybrid", jimg.HostImgTransformerDecoderHybrid, tnn.HostImgTransformerDecoderHybrid,
     dict(patch_size=3)),
    ("pixel", jimg.HostImgTransformerDecoder, tnn.HostImgTransformerDecoder,
     dict(mlpdecoder=True)),
    ("pixel", jimg.HostImgTransformerDecoder, tnn.HostImgTransformerDecoder,
     dict(mlpdecoder=False)),
]


@pytest.mark.parametrize("kind,jcls,tcls,extra", DECODERS,
                         ids=["hybrid-p2", "hybrid-p3", "pixel-mlp", "pixel-dense"])
def test_decoders_match(kind, jcls, tcls, extra):
    """Both decoders at a 12×12 image: the JAX output NHWC, the port's
    NCHW, the same numbers."""
    z = np.random.default_rng(5).normal(size=(3, 2, 2)).astype(np.float32)
    kw = dict(img_size=12, bottleneck_dim=2, in_channels=3, **TOWER, **extra)
    jm, tm = jcls(**kw), tcls(**kw)
    variables, tm = _bridge(jm, tm, jnp.asarray(z), seed=6)
    got = tm(torch.from_numpy(z))
    assert got.shape == (3, 3, 12, 12)
    _close(got, _nchw(jm.apply(variables, jnp.asarray(z))))


@pytest.mark.parametrize("kind", ["hybrid", "pixel"])
def test_decoder_at_a_kernel_grid_matches_pallas(kind, monkeypatch):
    """A 16×16 image at patch 1 (hybrid) or per pixel: the self-attention
    over 256 tokens is a 65,536-point grid, which both packages send to
    their kernel. The JAX decoder lowers to its Pallas kernel (interpret
    mode); the port's layers call ``fused_attention`` once a layer (its
    plain version on the CPU). Head dim 8."""
    monkeypatch.setenv("VAESNE_PALLAS", "1")
    monkeypatch.setenv("VAESNE_PALLAS_INTERPRET", "1")
    assert routes_to_kernel(2, 2, 256, 256) and not routes_to_kernel(2, 2, 256, 2)
    calls = []
    real = tlayers.fused_attention

    def counting(q, *args):
        calls.append(tuple(q.shape))
        return real(q, *args)

    monkeypatch.setattr(tlayers, "fused_attention", counting)
    z = np.random.default_rng(8).normal(size=(2, 2, 2)).astype(np.float32)
    kw = dict(img_size=16, bottleneck_dim=2, in_channels=3, model_dim=16, num_heads=2,
              ff_dim=8, num_layers=2)
    if kind == "hybrid":
        jm = jimg.HostImgTransformerDecoderHybrid(patch_size=1, **kw)
        tm = tnn.HostImgTransformerDecoderHybrid(patch_size=1, **kw)
    else:
        jm, tm = jimg.HostImgTransformerDecoder(**kw), tnn.HostImgTransformerDecoder(**kw)
    variables, tm = _bridge(jm, tm, jnp.asarray(z), seed=9)
    jaxpr = str(jax.make_jaxpr(lambda v: jm.apply(v, jnp.asarray(z)))(variables))
    assert "pallas_call" in jaxpr
    want = _nchw(jm.apply(variables, jnp.asarray(z)))
    got = tm(torch.from_numpy(z))
    assert calls == [(2, 256, 16)] * 2
    _close(got, want)


def test_each_conv2d_call_adds_one_to_the_conv_counter():
    """``conv2d`` adds one launch to ``conv`` a call, its backward none; an
    image VAE's forward adds its convolutions: the patch convolution, and
    the hybrid decoder's two refinements."""
    from vaesne_tpu_torch import HostImgVAE
    from vaesne_tpu_torch.ops import counters

    def conv_delta(fn):
        before = counters.launch_counts()
        fn()
        after = counters.launch_counts()
        assert after["LN plain"] == before["LN plain"]
        return after["conv"] - before["conv"]

    conv = nn.Conv2d(3, 4, 2)
    x = torch.randn(2, 3, 6, 6, requires_grad=True)
    y = []
    assert conv_delta(lambda: y.append(tlayers.conv2d(x, conv))) == 1
    assert conv_delta(lambda: y[0].sum().backward()) == 0
    images = (torch.randn(2, 3, 12, 12), torch.zeros(2, 0))
    for hybrid, launches in ((True, 3), (False, 1)):
        model = init_params(HostImgVAE(img_size=12, latent_len=2, latent_dim=2, patch_size=2,
                                       hybrid=hybrid, **TOWER), torch.Generator().manual_seed(0))
        assert conv_delta(lambda: model.eval()(images, 1)) == launches


def test_a_replay_adds_its_captures_conv_launches():
    """The ``conv`` counter moves with the others: set, and added to as a
    replay adds its capture's launches."""
    from vaesne_tpu_torch.ops import counters

    counts = counters.launch_counts()
    try:
        counters.set_launch_counts({"conv": 10})
        counters.add_launch_counts({"conv": 3, "K1": 0})
        after = counters.launch_counts()
        assert after["conv"] == counters.conv_launches == 13
        assert {k: v for k, v in after.items() if k != "conv"} == {
            k: v for k, v in counts.items() if k != "conv"}
    finally:
        counters.set_launch_counts({"conv": counts["conv"]})
    assert counters.launch_counts() == counts
