"""The image cell's own parts: its faults come out not correct, its counts
match counts made by hand, its inputs repeat per seed, and its trace
readers read only what the trace and the counters agree on.

The faults run the cell on the CPU at 32×32 images (the hybrid decoder's
256×256 self-attention still on the kernels' route and its hash dropout)
and 8 images, where a step takes a fraction of the 60×60 step's time;
``test_bench_correct.py`` runs the sound cell at the published image
size."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import core, counts, trace_image
from benchmark.counts import image
from benchmark.reference.image_model import parameter_shapes

WORKLOAD = "host-image-train-b32"
CONFIG = core.load_json(core.BENCH / "configs" / "ztf-hostimage.json")
SHAPE = image.shape_of(CONFIG)
DRIVER = core.load_module(core.BENCH / "drivers" / "image_train_loop.py")
BIG = 2 ** 31 + 977


def _small(tiny_cell):
    cell = tiny_cell(WORKLOAD)
    cell.config.update(img_size=32, synthetic_events=8)
    return cell


def _sound(monkeypatch):
    pass


def _unchanged(monkeypatch):
    from vaesne_tpu_torch import training

    monkeypatch.setattr(training, "_clip_and_update", lambda state, optimizer, shard: None)


def _half_batch(monkeypatch):
    """The ELBO over the first half of each batch alone."""
    from vaesne_tpu_torch import objectives
    from vaesne_tpu_torch.distributions import kl_divergence

    def half(model, x, K=1, *, seed, debug=False):
        generator, drop = objectives._rngs(model, x, seed)
        qz_x, px_z, _ = model(x, K, generator=generator, seed=drop)
        lpx = objectives.grid_loglik(px_z, x[0]) * model.total_llik_scaling
        kl = kl_divergence(qz_x, model.pz(x[0].device)).sum((-1, -2))
        terms = lpx - kl[None, :]
        return terms[:, :terms.shape[1] // 2].mean()

    monkeypatch.setattr(objectives, "elbo", half)


@pytest.mark.parametrize("fault, correct", [(_sound, True), (_unchanged, False),
                                            (_half_batch, False)],
                         ids=["sound", "unchanged", "half_batch"])
def test_the_image_cells_faults_are_not_correct(tiny_cell, monkeypatch, fault, correct):
    from benchmark import run, trace

    fault(monkeypatch)
    cell = _small(tiny_cell)
    out = DRIVER.run(cell)
    result = run.assemble(core.spec(), WORKLOAD, dict(out, profile=None), core, trace)
    assert result["correct"] == correct, out["checks"]
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_the_controls_read_over_the_sound_run(tiny_cell):
    """At this size the TF32 control's first loss gap stands far over the
    sound run's, the half batch's loss gap over the limit, and the
    unchanged state's change gap reads 1."""
    cell = _small(tiny_cell)
    sound = DRIVER.run(cell)["readings"]
    c = DRIVER.controls(cell)
    assert c["control"]["first_loss_gap"] >= 10 * max(sound["first_loss_gap"], 1e-9)
    assert c["half_batch"]["loss_gap"] > cell.limits["loss_gap"]
    assert c["unchanged"]["change_gap"] == 1.0


def test_hybrid_decoder_flops_by_hand():
    E, n, L, D = 32, 900, 4, 4
    block = (4 * 2 * E * E * n + 4 * n * n * E          # q, k, v, out; QKᵀ and PV
             + 2 * 2 * E * E * n + 2 * 2 * E * E * L + 4 * n * L * E  # cross to the latents
             + 2 * 2 * E * 32 * n)                       # the feed-forward
    context = 2 * D * E * L + 2 * E * E * L
    dense = 2 * E * (4 * E) * n
    refine = 2 * 3600 * (4 * E) * (E * 4) + 2 * 3600 * 3 * (4 * E * 4)
    decoder = context + 4 * block + dense + refine
    assert block == 118_902_784 and decoder == 612_017_152
    encoder = image.forward_flops(SHAPE, 1, 0)
    assert image.forward_flops(SHAPE, 1, 1) == encoder + decoder
    assert image.train_step_flops(SHAPE, 32, 1) == 3 * 32 * (encoder + decoder)


def test_convolution_counts_by_hand():
    patch, refine_0, refine_1 = image.convolutions(SHAPE, 32, 1)
    assert [c.name for c in (patch, refine_0, refine_1)] == ["patch_embed", "refine_0",
                                                            "refine_1"]
    kinds = {c.name: [k for k, _, _ in image.conv_products(c)] for c in (patch, refine_0)}
    assert kinds == {"patch_embed": ["fprop", "wgrad"], "refine_0": ["fprop", "dgrad", "wgrad"]}
    (_, flops, nbytes), *_ = image.conv_products(refine_0)
    assert flops == 2 * 32 * 60 * 60 * 128 * 32 * 2 * 2 == 3_774_873_600
    # the padded 61×61 input, the 60×60 output, the kernel and its bias, 4 bytes each
    assert nbytes == (32 * 32 * 61 * 61 + 32 * 128 * 60 * 60 + 128 * 32 * 4 + 128) * 4
    (_, flops, _), (_, wflops, _) = image.conv_products(patch)
    assert flops == wflops == 2 * 32 * 30 * 30 * 32 * 3 * 2 * 2
    assert image.conv_products(refine_1)[0][1] == 2 * 32 * 3600 * 3 * 128 * 4


def test_only_the_decoders_self_attention_goes_to_the_kernels():
    grids = image.kernel_grids(SHAPE, "enc", 32) + image.kernel_grids(SHAPE, "dec", 32)
    assert [(g.rows, g.lq, g.lk, g.masked) for g in grids] == [(32, 900, 900, False)] * 4
    assert all(not g.masked for g in image.tower_grids(SHAPE, "enc", 32))


def test_images_and_weights_repeat_per_seed():
    config = dict(CONFIG, synthetic_events=6)
    a, b = DRIVER.images(config, BIG), DRIVER.images(config, BIG)
    assert a.shape == (6, 3, 60, 60) and a.dtype == np.float32 and np.array_equal(a, b)
    assert a.min() >= -1.0 and a.max() <= 1.0
    assert not np.array_equal(a, DRIVER.images(config, BIG + 1))
    w1, w2 = (DRIVER.weights(CONFIG, BIG, torch.device("cpu")) for _ in range(2))
    assert w1.keys() == parameter_shapes(CONFIG).keys()
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    conv = w1["dec.refine_0.weight"]  # fan_in 32·2·2: lecun normal truncated at ±2σ
    sigma = math.sqrt(1.0 / 128)
    assert conv.abs().max() <= 2.0 * sigma / 0.8796 and abs(conv.std().item() / sigma - 1) < 0.1
    assert w1["dec.refine_0.bias"].eq(0).all() and w1["enc.patch_embed.proj.bias"].eq(0).all()
    assert w1["dec.blocks.block_1.layernorm2.weight"].eq(1).all()
    assert w1["dec.decoder.weight"].abs().max() <= 1.0 / math.sqrt(32)


class _Prof:
    """A traced sub-window as the readers see it."""

    def __init__(self, kernels, conv_counter, busy_s=1.0):
        self.kernels, self.busy_s, self.config = kernels, busy_s, CONFIG
        self.counters = {} if conv_counter is None else {"conv": conv_counter}
        shape = image.shape_of(CONFIG)
        grid = image.kernel_grids(shape, "dec", 32)[0]
        self.work = {"dtype": "fp32",
                     "launches": {"K1": [(grid, True, 8)], "K2": [(grid, None, 4)],
                                  "conv": [(c, 1) for c in image.convolutions(shape, 32, 1)]}}

    def kernel_seconds(self, *names):
        from benchmark.trace import Profile

        return Profile.kernel_seconds(self, *names)


KERNELS = {"sm80_xmma_fprop_implicit_gemm_x_cudnn": (0.004, 3),
           "sm80_xmma_dgrad_implicit_gemm_x_cudnn": (0.002, 1),
           "void cudnn::cnn::wgrad_alg1_engine<float>": (0.004, 1),
           "void fft2d_r2c_32x32<float>": (0.001, 2),
           "attention_fwd_kernel<float, 8, 1>": (0.008, 8),
           "attention_bwd_kernel<float, 8, 1>": (0.005, 4),
           "vaesne_layer_norm_fwd_kernel<32>": (0.5, 12)}


def test_conv_readers_need_the_counter_to_agree_with_the_trace():
    agreed = _Prof(KERNELS, 3)
    assert trace_image.conv_pct(agreed) == pytest.approx(100.0 * 0.011)
    bound = sum(counts.bound_s(b, f) for c in image.convolutions(SHAPE, 32, 1)
                for _, f, b in image.conv_products(c))
    assert trace_image.conv_roofline_pct(agreed) == pytest.approx(100.0 * bound / 0.011)
    for counter in (None, 4):  # the parent has no conv counter; a miscount reads nothing
        assert trace_image.conv_pct(_Prof(KERNELS, counter)) is None
        assert trace_image.conv_roofline_pct(_Prof(KERNELS, counter)) is None


def test_attention_rooflines_read_the_image_plan():
    prof = _Prof(KERNELS, 3)
    grid = image.kernel_grids(SHAPE, "dec", 32)[0]
    flops, nbytes = counts.attention_fwd(32, 900, 900, 32, 4, False, True)
    assert trace_image.attention_roofline_pct(prof, "K1", "attention_fwd_kernel") == \
        pytest.approx(100.0 * 8 * counts.bound_s(nbytes, flops) / 0.008)
    assert grid.lq == grid.lk == 900
    assert trace_image.attention_roofline_pct(prof, "K2", "attention_bwd_kernel") > 0
    prof.work["launches"]["K1"] = [(grid, True, 7)]
    assert trace_image.attention_roofline_pct(prof, "K1", "attention_fwd_kernel") is None
