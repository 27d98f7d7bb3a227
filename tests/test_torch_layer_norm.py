"""The port's LayerNorm (``ops.layer_norm``, ``nn.LayerNorm`` subclass
``nn.layers.LayerNorm``) on the CPU: there it is ``F.layer_norm`` itself,
bit for bit, gradients included; the subclass keeps ``nn.LayerNorm``'s
parameter names through the weight bridges; its three counters move with
the others. The CUDA kernels are held in ``tests/test_torch_cuda.py``."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

import vaesne_tpu_torch.ops.layer_norm as layer_norm_ops
from vaesne_tpu_torch import PhotometricVAE, PhotoSpecMMVAE, SpectraVAE, init_params
from vaesne_tpu_torch.nn import LN_EPS, LayerNorm, TransformerBlock
from vaesne_tpu_torch.ops import counters
from vaesne_tpu_torch.utils import torch_port
from vaesne_tpu_torch.utils.weights import load_jax_params, to_jax_params

LN_COUNTERS = ("LN", "LN bwd", "LN plain")


def _inputs(shape, seed):
    g = torch.Generator().manual_seed(seed)
    n = shape[-1]
    x = torch.randn(shape, generator=g) * 2.0 + 0.5
    w = 1.0 + 0.1 * torch.randn(n, generator=g)
    b = 0.1 * torch.randn(n, generator=g)
    dy = torch.randn(shape, generator=g)
    return x, w, b, dy


def _forward_and_grads(fn, x, w, b, dy):
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y = fn(*leaves)
    y.backward(dy)
    return [y.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("shape", [(1, 32), (7, 32), (3, 41, 32), (5, 64), (2, 9, 16),
                                   (4, 48), (6, 30)])
def test_cpu_layer_norm_is_f_layer_norm_bitwise(shape):
    x, w, b, dy = _inputs(shape, sum(shape))
    n = shape[-1]
    before = counters.launch_counts()
    got = _forward_and_grads(lambda x, w, b: layer_norm_ops.layer_norm(x, (n,), w, b, LN_EPS),
                             x, w, b, dy)
    want = _forward_and_grads(lambda x, w, b: F.layer_norm(x, (n,), w, b, LN_EPS), x, w, b, dy)
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    after = counters.launch_counts()
    assert {k: after[k] - before[k] for k in LN_COUNTERS} == dict.fromkeys(LN_COUNTERS, 0)


def test_cpu_layer_norm_without_affine_and_over_two_axes_is_f_layer_norm():
    x, w, b, _ = _inputs((3, 4, 32), 1)
    assert torch.equal(layer_norm_ops.layer_norm(x, (32,)), F.layer_norm(x, (32,)))
    w2 = 1.0 + 0.1 * torch.randn(4, 32, generator=torch.Generator().manual_seed(2))
    assert torch.equal(layer_norm_ops.layer_norm(x, (4, 32), w2, None, LN_EPS),
                       F.layer_norm(x, (4, 32), w2, None, LN_EPS))


def test_cpu_layer_norm_under_bf16_autocast_is_f_layer_norm():
    x, w, b, _ = _inputs((5, 32), 3)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = layer_norm_ops.layer_norm(x.bfloat16(), (32,), w, b, LN_EPS)
        want = F.layer_norm(x.bfloat16(), (32,), w, b, LN_EPS)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_only_cuda_tensors_can_take_the_kernels():
    x, w, b, _ = _inputs((4, 32), 4)
    assert not layer_norm_ops.takes_kernel(x, (32,), w, b)
    assert not layer_norm_ops.takes_kernel(x.to("meta"), (32,), w.to("meta"), b.to("meta"))
    assert layer_norm_ops.WIDTHS == (32, 64)  # the towers' model_dim, PhotometricVAE's default


def test_operand_copies_only_what_the_kernels_cannot_read():
    x = torch.randn(8, 64)
    assert layer_norm_ops._operand(x) is x
    strided = x[:, :32]
    copied = layer_norm_ops._operand(strided)
    assert copied.is_contiguous() and torch.equal(copied, strided)
    flat = torch.randn(8 * 32 + 1)
    shifted = flat[1:].view(8, 32)  # 4 bytes past the storage's start
    assert shifted.data_ptr() % 16 != 0
    moved = layer_norm_ops._operand(shifted)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, shifted)


@pytest.mark.parametrize("n", [16, 32, 64])
def test_layer_norm_module_is_nn_layer_norm(n):
    x, w, b, dy = _inputs((6, n), n)
    mine, torchs = LayerNorm(n, eps=LN_EPS), nn.LayerNorm(n, eps=LN_EPS)
    with torch.no_grad():
        for m in (mine, torchs):
            m.weight.copy_(w)
            m.bias.copy_(b)
    assert isinstance(mine, nn.LayerNorm)
    assert list(mine.state_dict()) == list(torchs.state_dict()) == ["weight", "bias"]
    got = _forward_and_grads(lambda x, w, b: mine(x), x, w, b, dy)
    want = _forward_and_grads(lambda x, w, b: torchs(x), x, w, b, dy)
    assert torch.equal(got[0], want[0])
    mine(x).backward(dy)
    torchs(x).backward(dy)
    assert torch.equal(mine.weight.grad, torchs.weight.grad)
    assert torch.equal(mine.bias.grad, torchs.bias.grad)


@pytest.mark.parametrize("context_self_attn", [False, True])
def test_transformer_block_norms_are_the_port_layer_norm(context_self_attn):
    block = TransformerBlock(32, 4, 32, context_self_attn=context_self_attn)
    norms = {name for name, m in block.named_modules() if isinstance(m, LayerNorm)}
    want = {"layernorm1", "layernorm2", "layernorm3"} | (
        {"layernorm_context"} if context_self_attn else set())
    assert norms == want
    assert all(m.eps == LN_EPS for name, m in block.named_modules() if name in want)


def test_layer_norm_bridges_through_utils_weights():
    block = init_params(TransformerBlock(32, 4, 32, context_self_attn=True),
                        torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in block.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    tree = to_jax_params(block)["params"]
    for name in ("layernorm1", "layernorm_context", "layernorm2", "layernorm3"):
        assert sorted(tree[name]) == ["bias", "scale"]
        assert torch.equal(torch.from_numpy(tree[name]["scale"]), getattr(block, name).weight)
    other = TransformerBlock(32, 4, 32, context_self_attn=True)
    load_jax_params(other, {"params": tree})
    assert all(torch.equal(a, c) for a, c in zip(block.state_dict().values(),
                                                 other.state_dict().values()))


def test_layer_norm_bridges_through_utils_torch_port():
    kw = dict(latent_len=2, latent_dim=2, model_dim=16, ff_dim=16, num_layers=1, num_heads=2)

    def model(seed):
        return init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                           torch.Generator().manual_seed(seed))

    mine = model(0)
    with torch.no_grad():
        for m in mine.modules():
            if isinstance(m, LayerNorm):
                m.weight.mul_(1.5)
                m.bias.add_(0.25)
    reference = torch_port.to_reference_state_dict(mine.state_dict())
    assert any(k.endswith("layernorm1.weight") for k in reference)
    other = model(1)
    other.load_state_dict(torch_port.convert_photospec_mmvae(reference), strict=True)
    assert all(torch.equal(a, c) for a, c in zip(mine.state_dict().values(),
                                                 other.state_dict().values()))


def test_layer_norm_counters_round_trip():
    counts = counters.launch_counts()
    assert all(name in counts for name in LN_COUNTERS)
    assert (counts["LN"], counts["LN bwd"], counts["LN plain"]) == (
        layer_norm_ops.launches, layer_norm_ops.bwd_launches, layer_norm_ops.plain_calls)
    try:
        counters.set_launch_counts({"LN": 10, "LN bwd": 20, "LN plain": 30})
        assert (layer_norm_ops.launches, layer_norm_ops.bwd_launches,
                layer_norm_ops.plain_calls) == (10, 20, 30)
        # a replay adds the launches its capture recorded
        counters.add_launch_counts({"LN": 24, "LN bwd": 24, "LN plain": 0})
        after = counters.launch_counts()
        assert (after["LN"], after["LN bwd"], after["LN plain"]) == (34, 44, 30)
        assert after["K1"] == counts["K1"] and after["captures"] == counts["captures"]
    finally:
        counters.set_launch_counts({k: counts[k] for k in LN_COUNTERS})
    assert counters.launch_counts() == counts


@pytest.mark.parametrize("case", ["cpu", "width", "strided", "rank", "stats"])
def test_kernel_entry_points_refuse_what_the_kernels_cannot_take(case):
    x, w, b, dy = _inputs((8, 32), 5)
    stats = torch.zeros(8)
    if case == "cpu":
        with pytest.raises(TypeError, match="fp32 CUDA"):
            layer_norm_ops.layer_norm_fwd(x, w, b, LN_EPS)
    elif case == "width":
        for n in (16, 48, 128):
            with pytest.raises(ValueError, match="N in"):
                layer_norm_ops.layer_norm_fwd(torch.zeros(8, n), torch.ones(n), torch.zeros(n),
                                              LN_EPS)
    elif case == "strided":
        with pytest.raises(ValueError, match="contiguous"):
            layer_norm_ops._check(torch.zeros(8, 64)[:, :32])
    elif case == "rank":
        with pytest.raises(ValueError, match=r"\[M, N\]"):
            layer_norm_ops.layer_norm_bwd(dy[None], x[None], w, stats, stats)
    else:
        with pytest.raises(ValueError, match="does not fit"):
            layer_norm_ops._check(x, torch.zeros(16))
