"""The port's mesh, seeds, draws and tensor-parallel specs, in one process.

``resolve_mesh`` keeps the JAX package's specs and messages; a kernel
shard's dropout seed (``shard_seed``) gives the JAX package's sharded
kernel's mask, shard for shard (the JAX kernel in interpret mode on its
virtual CPU devices); the dispatch rule sees global rows; a rank's draws
are its part of the one process's. The tests that start gloo ranks are in
``test_torch_dp_train.py`` and ``test_torch_dp_serving.py``.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import vaesne_tpu_torch.distributions as tdist
import vaesne_tpu_torch.nn.layers as layers
import vaesne_tpu_torch.parallel.mesh as tmesh
from vaesne_tpu.ops.attention import fused_attention as jax_fused_attention
from vaesne_tpu.parallel import make_mesh as jax_make_mesh
from vaesne_tpu_torch import PhotometricVAE, PhotoSpecMMVAE, SpectraVAE
from vaesne_tpu_torch.ops import partition, routes_to_kernel
from vaesne_tpu_torch.ops.attention import fused_attention
from vaesne_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    resolve_mesh,
    shard_batch,
    shard_params_tp,
    tensor_parallel_specs,
)

from torch_parity import SMALL


def test_resolve_mesh_specs(monkeypatch):
    """The JAX specs and messages (``tests/test_dp_drivers.py``): on the
    CPU an explicit spec gives gloo ranks, ``auto`` one process outside a
    torchrun world and that world inside one, with the gcd rule."""
    for spec in ("none", "1", "off", "", "auto"):
        assert resolve_mesh(spec, device="cpu") is None
    m4 = resolve_mesh("4", device="cpu")
    assert m4.shape == {DATA_AXIS: 4, MODEL_AXIS: 1} and m4.backend == "gloo"
    assert m4.devices == ("cpu",) * 4
    assert resolve_mesh("4x2", device="cpu").shape == {"data": 4, "model": 2}
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert resolve_mesh("auto", device="cpu").shape[DATA_AXIS] == 4
    with pytest.warns(RuntimeWarning, match="does not divide"):
        assert resolve_mesh("auto", batch_size=6, device="cpu").shape[DATA_AXIS] == 2
    with pytest.warns(RuntimeWarning, match="does not divide"):
        assert resolve_mesh("auto", batch_size=5, device="cpu") is None
    with warnings.catch_warnings():  # the even case stays silent
        warnings.simplefilter("error")
        assert resolve_mesh("auto", batch_size=16, device="cpu").shape[DATA_AXIS] == 4


def test_a_mesh_on_the_card_needs_its_cards(monkeypatch):
    """Distinct cards take NCCL; more ranks than cards raise the JAX
    message; ranks that share a card (asked for by name) take gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = resolve_mesh("2")
    assert mesh.devices == ("cuda:0", "cuda:1") and mesh.backend == "nccl"
    assert resolve_mesh("auto").shape[DATA_AXIS] == 2
    with pytest.raises(ValueError, match="needs 4 devices, only 2 visible"):
        resolve_mesh("2x2")
    assert make_mesh(["cuda:0", "cuda:0"]).backend == "gloo"
    with pytest.raises(ValueError, match="mesh 3x2 != 4 devices"):
        make_mesh(["cpu"] * 4, data=3, model=2)
    with pytest.raises(ValueError, match="not both"):
        make_mesh(["cpu", "cuda:0"])


def _as_rank(monkeypatch, mesh, r):
    shard = partition.Shard(r // mesh.model, mesh.data, r % mesh.model, mesh.model, rank=r)
    monkeypatch.setattr(tmesh, "_CURRENT", tmesh._Rank(mesh, shard))
    return shard


def test_shard_batch_takes_the_ranks_slice(monkeypatch):
    mesh = make_mesh(["cpu"] * 4, data=2, model=2)
    batch = (torch.arange(8.0), (np.arange(16).reshape(8, 2),))
    _as_rank(monkeypatch, mesh, 3)  # data rank 1, model rank 1
    got = shard_batch(batch, mesh)
    torch.testing.assert_close(got[0], torch.arange(4.0, 8.0))
    np.testing.assert_array_equal(got[1][0], np.arange(8, 16).reshape(4, 2))
    with pytest.raises(ValueError, match="batch dim 5 not divisible by data axis 2"):
        shard_batch((torch.zeros(5),), mesh)


def _qkvb(rng, B=4, H=4, dh=4, L=64):
    E = H * dh
    q, k, v = (rng.normal(size=(B, E, L)).astype(np.float32) for _ in range(3))
    mask = rng.uniform(size=(B, L)) < 0.2
    return q, k, v, mask


@pytest.mark.parametrize("data,model", [(2, 1), (2, 2)])
def test_shard_seed_draws_the_jax_sharded_kernels_masks(data, model):
    """JAX's fused attention at rate 0.5 on a data×model mesh of its
    virtual devices (interpret mode; the batch over ``data``, whole heads
    over ``model``) against the port's kernel on each shard's rows and
    heads, seeded with ``shard_seed``: equal shard for shard. The same
    seed unshifted gives another mask on every shard but the first."""
    rng = np.random.default_rng(0)
    B, H, dh, L, seed = 4, 4, 4, 64, 123
    q, k, v, mask = _qkvb(rng, B, H, dh, L)
    bias = np.where(mask, -1e9, 0.0).astype(np.float32)
    mesh = jax_make_mesh(jax.devices()[:data * model], data=data, model=model)
    qkv = NamedSharding(mesh, P("data", "model" if model > 1 else None, None))
    args = [jax.device_put(a, qkv) for a in (q, k, v)]
    args.append(jax.device_put(bias, NamedSharding(mesh, P("data", None))))
    out = np.asarray(jax.jit(lambda q, k, v, b: jax_fused_attention(
        q, k, v, b, H, 0.5, True, np.int32(seed)))(*args))  # [B, E, L]
    Bl, Hl = B // data, H // model
    El = Hl * dh
    for d in range(data):
        for m in range(model):
            rows, cols = slice(d * Bl, (d + 1) * Bl), slice(m * El, (m + 1) * El)

            def local(a):
                return torch.from_numpy(np.ascontiguousarray(a[rows, cols].transpose(0, 2, 1)))

            s = partition.shard_seed(seed, d, m, model, Bl, Hl)
            got = fused_attention(local(q), local(k), local(v), torch.from_numpy(mask[rows]),
                                  Hl, 0.5, s)
            want = out[rows, cols].transpose(0, 2, 1)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
            plain = fused_attention(local(q), local(k), local(v), torch.from_numpy(mask[rows]),
                                    Hl, 0.5, seed)
            assert (d, m) == (0, 0) or not np.allclose(plain.numpy(), want, atol=1e-3)


def test_shard_seed_is_the_jax_rule():
    """seed + index·local_rows·local_heads·1024 mod 2³², the batch index
    before the head index."""
    assert partition.shard_seed(7, 0, 0, 1, 96, 4) == 7
    assert partition.shard_seed(7, 1, 0, 1, 96, 4) == 7 + 96 * 4 * 1024
    assert partition.shard_seed(7, 1, 1, 2, 8, 2) == 7 + 3 * 8 * 2 * 1024
    assert partition.shard_seed(2**32 - 1, 1, 0, 1, 1, 1) == 1023


def test_the_dispatch_rule_sees_the_global_rows(monkeypatch):
    """A rank of a 2-way data mesh asks ``routes_to_kernel`` with twice its
    rows and all the heads, as the JAX package traces the global batch:
    the 60x60 light-curve self-attention at 2,331 rows a rank routes to the
    kernel as 4,662 rows on one card do, though 2,331 alone would not."""
    assert routes_to_kernel(4662, 4, 60, 60) and not routes_to_kernel(2331, 4, 60, 60)
    asked = []

    def spy(rows, heads, lq, lk):
        asked.append((rows, heads, lq, lk))
        return False

    monkeypatch.setattr(layers, "routes_to_kernel", spy)
    mha = layers.MultiHeadAttention(8, 2).eval()
    x = torch.randn(3, 5, 8)
    with partition.sharded(partition.Shard(1, 2)):
        mha(x, x, x)
    mha(x, x, x)
    assert asked == [(6, 2, 5, 5), (3, 2, 5, 5)]


def test_a_ranks_draws_are_its_part_of_the_one_process_draw():
    """``draw_events`` (the posterior noise: [K, events, ...]) and
    ``global_draw`` (dropout: event-major rows, optionally split heads)
    keep this rank's block of the draw one process makes from the same
    generator state."""

    def gen():
        return torch.Generator().manual_seed(5)

    whole = torch.rand((3, 8, 4), generator=gen())
    with partition.sharded(partition.Shard(1, 2)):
        part = tdist.draw_events(lambda s: torch.rand(s, generator=gen()), (3, 4, 4))
    torch.testing.assert_close(part, whole[:, 4:], rtol=0, atol=0)
    whole = torch.rand((12, 4, 5, 5), generator=gen())  # rows, heads, Lq, Lk
    with partition.sharded(partition.Shard(1, 3, 1, 2)):
        part = partition.global_draw(lambda s: torch.rand(s, generator=gen()), (4, 2, 5, 5),
                                     head_axis=-3)
    torch.testing.assert_close(part, whole[4:8, 2:4], rtol=0, atol=0)
    with partition.sharded(partition.Shard(1, 3)):  # a residual branch: rows only
        part = partition.global_draw(lambda s: torch.rand(s, generator=gen()), (4, 4, 5))
    torch.testing.assert_close(part, torch.rand((12, 4, 5), generator=gen())[4:8], rtol=0,
                               atol=0)


def _flagship_small():
    kw = dict(SMALL, dropout=0.0)
    return PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)])


def test_tensor_parallel_specs_rules():
    """Megatron's split, over torch's [out, in] weights: q/k/v and ffn_0
    on their output axis (weight rows and bias), out_proj and ffn_2 on
    their contraction axis (weight columns; bias whole), the rest whole
    (``tests/test_sharding.py::test_tensor_parallel_specs_rules``)."""
    specs = tensor_parallel_specs(_flagship_small())
    blk = "vaes.0.enc.blocks.block_0."
    assert specs[blk + "self_attn.q_proj.weight"] == 0
    assert specs[blk + "self_attn.q_proj.bias"] == 0
    assert specs[blk + "self_attn.out_proj.weight"] == 1
    assert specs[blk + "self_attn.out_proj.bias"] is None
    assert specs[blk + "ffn_0.weight"] == 0 and specs[blk + "ffn_2.weight"] == 1
    assert specs[blk + "layernorm1.weight"] is None
    assert specs["vaes.0.enc.initbottleneck"] is None


def test_tp_divisibility_check():
    """The JAX messages: a tensor axis (embed 16 over 3) and a head count
    (2 heads over 4; 16 divides by 4) that do not divide the model axis
    (``tests/test_sharding.py::test_tp_divisibility_check``)."""
    with pytest.raises(ValueError, match="not divisible by model axis 3"):
        shard_params_tp(_flagship_small(), make_mesh(["cpu"] * 6, data=2, model=3))
    with pytest.raises(ValueError, match="num_heads \\(2\\) not divisible by model axis 4"):
        shard_params_tp(_flagship_small(), make_mesh(["cpu"] * 8, data=2, model=4),
                        num_heads=2)
