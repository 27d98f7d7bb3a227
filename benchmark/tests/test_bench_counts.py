"""The operation and byte counts against counts made by hand."""

from __future__ import annotations

import pytest

from benchmark import core, counts

FLAGSHIP = counts.shape_of(core.load_json(core.BENCH / "configs" / "flagship-photospec.json"))


@pytest.mark.parametrize("rows, lq, lk, masked, stats, flops, nbytes", [
    # 4·Dh per (query, key, head); q, k, v, out at 4 bytes, the mask's bytes,
    # the statistics' two fp32 per (query, head)
    (64, 982, 982, True, True, 64 * 4 * 982 * 982 * 32,
     64 * 4 * 982 * 32 * 4 + 64 * 982 + 2 * 64 * 4 * 982 * 4),
    (800, 982, 5, False, False, 800 * 4 * 982 * 5 * 32, 800 * (2 * 982 + 2 * 5) * 32 * 4),
])
def test_attention_forward_counts(rows, lq, lk, masked, stats, flops, nbytes):
    assert counts.attention_fwd(rows, lq, lk, 32, 4, masked, stats) == (flops, nbytes)


@pytest.mark.parametrize("rows, lq, lk", [(64, 982, 982), (512, 60, 60)])
def test_attention_backward_counts(rows, lq, lk):
    flops, nbytes = counts.attention_bwd(rows, lq, lk, 32, 4)
    assert flops == rows * 4 * lq * lk * 10 * 8
    # q, dout, out (3·Lq) and k, v (2·Lk) read; dq (Lq), dk, dv (2·Lk) written;
    # the mask, the two fp32 statistics
    assert nbytes == (rows * (3 * lq + 2 * lk) * 32 * 4 + rows * lk + 2 * rows * 4 * lq * 4
                      + rows * (lq + 2 * lk) * 32 * 4)


def test_bound_takes_the_larger_time():
    assert counts.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 495e12) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 989e12, "bf16") == pytest.approx(1.0)


def test_spectra_decoder_flops_by_hand():
    E, n, L = 32, 982, 4
    block = (4 * 2 * E * E * n + 4 * n * n * E          # q, k, v, out; QKᵀ and PV
             + 2 * 2 * E * E * n + 2 * 2 * E * E * (L + 1) + 4 * n * (L + 1) * E
             + 2 * 2 * E * 32 * n)                       # the feed-forward
    embed = (2 * 2 * E * E + 2 * E * E) * (n + 1) + 2 * L * E * 4 + 2 * E * E * L
    head = 2 * E * E * n + 2 * E * n
    assert counts.tower_flops(FLAGSHIP, "spec_dec") == 4 * block + embed + head


def test_only_the_large_grids_go_to_the_kernels():
    train = counts.kernel_grids(FLAGSHIP, "spec_dec", 64)
    assert [(g.lq, g.lk) for g in train] == [(982, 982)] * 4
    suite = counts.kernel_grids(FLAGSHIP, "spec_dec", 12800) + counts.kernel_grids(
        FLAGSHIP, "photo_dec", 12800)
    assert sorted((g.lq, g.lk) for g in suite) == sorted([(982, 982)] * 4 + [(982, 5)] * 4
                                                         + [(60, 60)] * 4)
    assert counts.kernel_grids(FLAGSHIP, "spec_enc", 64) == []


def test_a_train_step_is_three_forwards():
    one = counts.mmvae_forward_flops(FLAGSHIP, 16, 4)
    assert counts.train_step_flops(FLAGSHIP, 16, 2) == 3 * one
