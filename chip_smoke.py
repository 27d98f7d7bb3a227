"""Drive the PyTorch port's serving and training paths on one CUDA card
and check them.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with an NVIDIA H100 (Hopper,
sm_90a), nvcc and Triton. Phases, each printing its own lines:

  1. environment: torch/CUDA/Triton versions, the card's name and power
     limit, TF32 off for matmuls and cuDNN;
  2. build: every CUDA kernel under vaesne_tpu_torch/csrc/ with nvcc (the
     Triton kernels compile at their first launch, in phase 3);
  3. each kernel against its plain PyTorch version on the card at the
     shapes the paths give it (serving, the B = 192 step, the B = 16
     drivers of phase 10): K1 attention forward at rate 0 and 0.1,
     its measured keep rate, K2 attention backward against autograd
     through the plain version, K3/K4 masked Laplace forward and backward;
  4. the serving path at the flagship model's full width (random weights
     from --seed): embed, crossmodal, crossmodal_ci and reconstruct through
     InferenceServer, with K1's launch count checked against what the
     dispatch rule predicts for every call;
  5. the whole decode on the card (kernel) against the same module on the
     CPU (plain version);
  6. serving times: K1, its plain version and the library yardstick
     (scaled_dot_product_attention, timed here only) with CUDA events, the
     end-to-end crossmodal_ci latency, and a torch.profiler breakdown;
  7. the training path at full width: the m-IWAE step of bench.py (B = 192,
     K = 2, dropout 0.1, AdamW 1e-4, clip 10, remat on), 5 steps in fp32
     and 5 under bf16 autocast, every kernel's launches per step checked;
  8. one train step's loss and gradients on the card against the CPU, at
     dropout 0 on pinned posterior noise;
  9. training times: each kernel at the training shapes in fp32 and bf16,
     its bound beside the exp2 and dropout-hash floors, its plain version
     and its library yardstick (K1 at rate 0 and 0.1 beside SDPA without
     and with dropout), and a profile of one step;
     K1 at rate 0.1 and K2 are held against their plain versions on the
     same R = 768 inputs; K3 and K4 also at the drivers' [32, 982], each
     beside one torch.sum over the same rows;
 10. the training drivers at the flagship widths on synthetic data from
     --seed, checkpoints and logs under build/chip_smoke/: (a)
     train_photospectra.main for 3 epochs, saving each, every epoch's
     launches checked; (b) 2 epochs into another directory, then resumed
     to 3, equal to (a); (c) InferenceServer.from_checkpoint on (a)'s
     directory, crossmodal_ci on 32 held-out events equal bitwise to a
     server over (a)'s model; (d) one epoch of each other driver; (e) the
     driver's samples/s per epoch of (a), and a profile of one epoch of
     the driver resumed from (a)'s checkpoint.

Any failure raises and exits non-zero before the last line, which is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import vaesne_tpu_torch.distributions as distributions
import vaesne_tpu_torch.ops.attention as attention
import vaesne_tpu_torch.ops.laplace as laplace
from vaesne_tpu_torch import (
    InferenceServer,
    PhotometricVAE,
    PhotoSpecMMVAE,
    SpectraVAE,
    TrainState,
    adamw,
    init_params,
    make_train_step,
    objectives,
)
from vaesne_tpu_torch.data import multimodal_tuple
from vaesne_tpu_torch.experiments import (
    train_photometry,
    train_photospectra,
    train_spectra,
    train_ztf_photospect,
    train_ztf_spectra,
)
from vaesne_tpu_torch.experiments.common import resolve_dataset
from vaesne_tpu_torch.ops import _build, laplace_routes_to_kernel, routes_to_kernel
from vaesne_tpu_torch.training import to_device
from vaesne_tpu_torch.utils.config import PhotoSpectraMMVAEConfig

# the flagship model (vaesne_tpu/experiments/train_photospectra.py, bench.py)
NUM_BANDS, LATENT_LEN, LATENT_DIM = 6, 4, 4
MODEL_DIM, FF_DIM, HEADS, LAYERS = 32, 32, 4, 4
LP, NS = 60, 982  # light-curve points, spectrum bins
BUCKETS = (8, 32, 128, 512)
K_SERVE = 100
# the training step bench.py times (bench.py:62-66, :105-144; training.py:38-69)
B_TRAIN, K_TRAIN, DROPOUT, LR, TRAIN_STEPS = 192, 2, 0.1, 1e-4, 5
M = 2  # modalities: every decoder runs on M·K·B rows
BIG_SPECTRA = 1e10  # the spectra likelihood's mask variance
# the flagship driver's batch (PhotoSpectraMMVAEConfig) and phase 10's run
B_DRIVER, DRIVER_EPOCHS, N_HELD_OUT = 16, 3, 32
SMOKE_DIR = os.path.join("build", "chip_smoke")

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s, fp32
# FMA-pipe flop/s, bf16 tensor-core flop/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
MUFU_PER_SM_CLK = 16  # exp2 results per SM per clock
INT32_PER_SM_CLK = 64  # 32-bit integer ALU results per SM per clock (half the fp32 rate)
# integer ALU operations of the dropout hash per (query, key, head): xor,
# shift, xor, compare (its two multiplies run on the FMA pipe)
HASH_OPS = 4


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def make_batch(n, seed):
    """Host-side (photometry, spectra) batch at the Goldstein contract: the
    numpy recipe of bench.make_batch (bench.py:69-96), copied here."""
    rng = np.random.default_rng(seed)
    photo = (rng.normal(size=(n, LP)).astype(np.float32),
             np.sort(rng.uniform(-1, 1, (n, LP)), axis=1).astype(np.float32),
             rng.integers(0, NUM_BANDS, (n, LP)).astype(np.int64),
             rng.uniform(size=(n, LP)) < 0.2)
    spec = (rng.normal(size=(n, NS)).astype(np.float32),
            np.linspace(-1, 1, NS, dtype=np.float32)[None].repeat(n, 0),
            rng.normal(size=(n,)).astype(np.float32),
            rng.uniform(size=(n, NS)) < 0.2)
    return photo, spec


def flagship(seed, dropout=DROPOUT):
    vaes = [PhotometricVAE(num_bands=NUM_BANDS, latent_len=LATENT_LEN, latent_dim=LATENT_DIM,
                           model_dim=MODEL_DIM, ff_dim=FF_DIM, num_heads=HEADS,
                           num_layers=LAYERS, dropout=dropout),
            SpectraVAE(latent_len=LATENT_LEN, latent_dim=LATENT_DIM, model_dim=MODEL_DIM,
                       ff_dim=FF_DIM, num_heads=HEADS, num_layers=LAYERS, dropout=dropout)]
    return init_params(PhotoSpecMMVAE(vaes, beta=1.0), torch.Generator().manual_seed(seed))


# -- launch counts the dispatch rule predicts ---------------------------------

def stack_launches(rows, lq, lk_context):
    """Kernel launches of one TransformerStack: per layer a self-attention
    (lq x lq) and a cross-attention (lq x lk_context)."""
    return LAYERS * (int(routes_to_kernel(rows, HEADS, lq, lq))
                     + int(routes_to_kernel(rows, HEADS, lq, lk_context)))


def encoder_launches(m, rows):
    # 2·latent_len bottleneck queries over the light curve, or over the
    # spectrum plus its phase token
    return stack_launches(rows, 2 * LATENT_LEN, LP if m == 0 else NS + 1)


def decoder_launches(d, rows):
    # grid queries over the latent tokens (plus the phase token for spectra)
    return stack_launches(rows, LP, LATENT_LEN) if d == 0 else stack_launches(
        rows, NS, LATENT_LEN + 1)


# -- timing --------------------------------------------------------------------

def time_ms(fn, reps=10, warmup=3, inner=1):
    """Median milliseconds of one ``fn`` call on the card: CUDA events
    around ``inner`` back-to-back calls (many for a microsecond kernel, so
    the events' resolution does not dominate), divided by ``inner``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def attention_inputs(rows, lq, lk, masked, seed, full_row=False):
    g = torch.Generator("cuda").manual_seed(seed)
    e = HEADS * (MODEL_DIM // HEADS)
    q = torch.randn(rows, lq, e, device="cuda", generator=g)
    k = torch.randn(rows, lk, e, device="cuda", generator=g)
    v = torch.randn(rows, lk, e, device="cuda", generator=g)
    mask = None
    if masked:
        mask = torch.rand(rows, lk, device="cuda", generator=g) < 0.2
        if full_row:
            mask[0] = True
    return q, k, v, mask


def bound(nbytes, ops, peak_ops_s):
    """(ms, resource): the least time for the work, the larger of its bytes
    over the memory rate and its operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak_ops_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound(rows, lq, lk, dtype, masked, stats=False):
    """K1's bound for one launch: q, k, v (and the mask) read once, the
    output (and with ``stats`` the fp32 row max and sum) written once;
    4·Dh flop per (query, key, head) at the card's peak for the dtype (the
    dropout hash's integer operations are not counted)."""
    dh = MODEL_DIM // HEADS
    size = torch.finfo(dtype).bits // 8
    nbytes = rows * (2 * lq + 2 * lk) * MODEL_DIM * size + (rows * lk if masked else 0)
    nbytes += 2 * rows * HEADS * lq * 4 if stats else 0
    return bound(nbytes, rows * HEADS * lq * lk * 4 * dh, PEAK_FLOPS[dtype])


def attention_bwd_bound(rows, lq, lk, dtype):
    """K2's bound for one backward: q, k, v, out, dout, the mask and the
    row statistics read once, dq, dk, dv written once; 10·Dh flop per
    (query, key, head): s = q·k again, dp = dout·v, dv, dq and dk."""
    dh = MODEL_DIM // HEADS
    size = torch.finfo(dtype).bits // 8
    nbytes = (rows * (3 * lq + 2 * lk) * MODEL_DIM * size + rows * lk
              + 2 * rows * HEADS * lq * 4 + rows * (lq + 2 * lk) * MODEL_DIM * size)
    return bound(nbytes, rows * HEADS * lq * lk * 10 * dh, PEAK_FLOPS[dtype])


def laplace_bound(rows, n, x_rows, backward):
    """K3/K4's bound: fp32 loc [R, N], x [Rx, N], the byte mask [R, N] read
    once, the row sums [R] (K3) or g [R] in and dloc [R, N] out (K4); ~7
    fp32 operations per point."""
    nbytes = rows * n * 4 + x_rows * n * 4 + rows * n + rows * 4
    nbytes += rows * n * 4 if backward else 0
    return bound(nbytes, 7 * rows * n, PEAK_FLOPS[torch.float32])


def unit_floors(pairs, sm_clock_mhz):
    """(exp2 floor ms, hash floor ms) of ``pairs`` (query, key, head) pairs:
    one exp2 each on the SFU, and the dropout hash's integer operations on
    the INT32 pipe, at the max SM clock. Floors of one unit each, printed
    beside the bound, which they do not change."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per_ms = n_sm * sm_clock_mhz * 1e3  # SM clocks per ms, summed over the SMs
    return pairs / (MUFU_PER_SM_CLK * per_ms), pairs * HASH_OPS / (INT32_PER_SM_CLK * per_ms)


def _sdpa_operands(q, k, v, mask):
    r, _, e = q.shape
    dh = e // HEADS
    q4, k4, v4 = (t.view(r, -1, HEADS, dh).transpose(1, 2).contiguous() for t in (q, k, v))
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill(mask, -1e9)
    return q4, k4, v4, bias[:, None, None, :]


def sdpa_call(q, k, v, mask, dropout=0.0):
    """The library yardstick: one scaled_dot_product_attention call with
    the −1e9 float mask, on [R, H, L, Dh] copies made outside the timing."""
    q4, k4, v4, bias = _sdpa_operands(q, k, v, mask)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=bias, dropout_p=dropout)


def sdpa_train_call(q, k, v, mask, dropout):
    """The library yardstick for K1 + K2: scaled_dot_product_attention
    forward and backward with the float mask and dropout."""
    q4, k4, v4, bias = _sdpa_operands(q, k, v, mask)
    leaves = [t.requires_grad_() for t in (q4, k4, v4)]
    dout = torch.randn_like(q4)

    def run():
        out = torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=bias, dropout_p=dropout)
        torch.autograd.grad(out, leaves, dout)
    return run


def sdpa_bwd_call(q, k, v, mask, dropout):
    """The library yardstick for K2 alone: the backward of one
    scaled_dot_product_attention forward (float mask, dropout), run once
    outside the timing and kept for repeated backwards."""
    q4, k4, v4, bias = _sdpa_operands(q, k, v, mask)
    leaves = [t.requires_grad_() for t in (q4, k4, v4)]
    out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias,
                                                           dropout_p=dropout)
    dout = torch.randn_like(out)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def chunk_slices(rows, chunk):
    """Row slices of ``chunk`` rows: the plain attention versions
    materialise int64 hash tensors of R·H·Lq·Lk entries, ~24 GB each at
    R = 768 in one piece."""
    return [slice(i, min(i + chunk, rows)) for i in range(0, rows, chunk)]


def chunk_seed(seed, s):
    """The seed under which rows ``s`` alone draw the dropout mask that
    rows s.start.. draw within the whole tensor under ``seed``: the hash
    seeds row r, head h with seed + (r·H + h)·1024."""
    return seed + s.start * HEADS * 1024


# -- phases --------------------------------------------------------------------

def phase_environment():
    log(1, f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True,
                           text=True, timeout=60, check=True).stdout.split()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(1, f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
           f"max SM clock {clock} MHz; allow_tf32 matmul="
           f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    return float(clock)


def phase_build():
    t0 = time.perf_counter()
    targets = _build.build_all()
    log(2, f"built {sorted(targets)} in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "Used" in line or ("spill" in line and ", 0 bytes spill stores, 0 bytes "
                                                       "spill loads" not in line):
                log(2, f"{name}: {line.strip()}")


def _rel(got, want):
    """max |got − want| over max |want| (floor 1e-6 for an all-zero want)."""
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-6)).item()


def phase_kernel_vs_plain():
    """Every kernel against its plain version on the same card inputs.
    Tolerances: a forward in fp32 max-abs ≤ 1e-5 (sums in another order);
    a gradient in fp32 ≤ 1e-4 of max |plain| (sums over ~1000 keys or
    queries of products that cancel); anything in bf16 ≤ 2e-2 of max |plain|
    against the plain version on fp32 inputs (bf16 keeps 8 bits); the
    Laplace row sums rtol 1e-5 (~1000 terms), their gradient rtol 1e-6 (the
    same elementwise operations). Returns the worst fp32 max-abs error per
    kernel."""
    worst = dict.fromkeys(("attention_fwd", "attention_fwd_dropout", "attention_bwd",
                           "laplace_fwd", "laplace_bwd"), 0.0)
    cases = [("982x982 masked, row 0 fully masked", 64, NS, NS, True),
             ("982x5", 256, NS, LATENT_LEN + 1, False),
             ("60x60 masked", 256, LP, LP, True),
             ("60x4", 256, LP, LATENT_LEN, False)]
    for i, (label, rows, lq, lk, masked) in enumerate(cases):
        q, k, v, mask = attention_inputs(rows, lq, lk, masked, seed=100 + i, full_row=masked)
        for rate, seed, name in ((0.0, None, "attention_fwd"),
                                 (DROPOUT, 1000 + i, "attention_fwd_dropout")):
            ref = attention.attention_reference(q, k, v, mask, HEADS, rate, seed)
            out = attention.fused_attention(q, k, v, mask, HEADS, rate, seed)
            torch.cuda.synchronize()
            err32 = (out - ref).abs().max().item()
            out16 = attention.fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask,
                                              HEADS, rate, seed)
            torch.cuda.synchronize()
            assert out16.dtype == torch.bfloat16
            err16 = _rel(out16, ref)
            log(3, f"attention_fwd rate {rate} R={rows} {label}: fp32 max-abs {err32:.3e}, "
                   f"bf16 rel {err16:.3e}")
            assert np.isfinite(err32) and err32 <= 1e-5, (label, rate, err32)
            assert np.isfinite(err16) and err16 <= 2e-2, (label, rate, err16)
            worst[name] = max(worst[name], err32)
            if masked and rate == 0.0:  # the fully masked row averages v uniformly
                uniform = v[0].mean(0).expand(lq, -1)
                assert torch.allclose(out[0], uniform, atol=1e-5), label
    keep_rate_check()
    # K2 at the training path's grids: 982x982 at the drivers' R = M·K·16 =
    # 64 (the plain version materialises int64 hash tensors of R·H·982²
    # entries, ~2 GB each), 982x5, 60x60
    for i, (label, rows, lq, lk, masked) in enumerate(cases[:3]):
        rows = M * K_TRAIN * B_DRIVER if lq == lk == NS else rows
        q, k, v, mask = attention_inputs(rows, lq, lk, masked, seed=200 + i, full_row=masked)
        dout = torch.randn_like(q)
        for rate, seed in ((0.0, None), (DROPOUT, 2000 + i)):
            want = attention.attention_backward_reference(q, k, v, mask, dout, HEADS, rate,
                                                           seed)
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                qd, kd, vd = (t.to(dtype) for t in (q, k, v))
                out, m, l = attention.fused_attention_fwd(qd, kd, vd, mask, HEADS, rate, seed)
                grads = attention.fused_attention_bwd(qd, kd, vd, mask, out, m, l,
                                                      dout.to(dtype), HEADS, rate, seed)
                torch.cuda.synchronize()
                errs[dtype] = [_rel(g, w) for g, w in zip(grads, want)]
                if dtype == torch.float32:
                    worst["attention_bwd"] = max(worst["attention_bwd"], *(
                        (g - w).abs().max().item() for g, w in zip(grads, want)))
            log(3, f"attention_bwd rate {rate} R={rows} {label}: dq, dk, dv rel fp32 "
                   + ", ".join(f"{e:.2e}" for e in errs[torch.float32]) + "; bf16 "
                   + ", ".join(f"{e:.2e}" for e in errs[torch.bfloat16]))
            assert all(np.isfinite(e) and e <= 1e-4 for e in errs[torch.float32]), label
            assert all(np.isfinite(e) and e <= 2e-2 for e in errs[torch.bfloat16]), label
    # K3/K4: the paths' [K·B, 982] rows over [B, 982] data (the B = 192
    # step, the B = 16 drivers); a row past a power of two (N = 2000 in a
    # 2048 block); a single row
    g = torch.Generator("cuda").manual_seed(300)
    for rows, n, x_rows in ((K_TRAIN * B_TRAIN, NS, B_TRAIN), (K_TRAIN * B_DRIVER, NS, B_DRIVER),
                            (6, 2000, 3), (1, NS, 1)):
        loc = torch.randn(rows, n, device="cuda", generator=g)
        x = torch.randn(x_rows, n, device="cuda", generator=g)
        x[0, :5] = loc[0, :5]  # sign(0) = 0
        mask = torch.rand(rows, n, device="cuda", generator=g) < 0.2
        gout = torch.randn(rows, device="cuda", generator=g)
        ref = laplace.masked_laplace_loglik_reference(loc, x, mask, BIG_SPECTRA)
        dref = laplace.masked_laplace_grad_reference(loc, x, mask, BIG_SPECTRA, gout)
        out = laplace.masked_laplace_loglik_fwd(loc, x, mask, BIG_SPECTRA)
        dloc = laplace.masked_laplace_loglik_bwd(loc, x, mask, BIG_SPECTRA, gout)
        torch.cuda.synchronize()
        e3, e4 = (out - ref).abs().max().item(), (dloc - dref).abs().max().item()
        log(3, f"laplace R={rows} N={n} x rows {x_rows}: fwd max-abs {e3:.3e} "
               f"(rel {_rel(out, ref):.2e}), bwd max-abs {e4:.3e}")
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(dloc, dref, rtol=1e-6, atol=0)
        assert bool((dloc[0, :5] == 0).all())
        worst["laplace_fwd"] = max(worst["laplace_fwd"], e3)
        worst["laplace_bwd"] = max(worst["laplace_bwd"], e4)
    return worst


def keep_rate_check():
    """K1's measured keep rate: with q = 0 every weight is 1/Lk, and with
    v = 1 each output is (#kept/Lk)/(1 − rate); over 31M draws it must be
    230/256 (the 8-bit threshold) within 4σ."""
    rows = 8
    q = torch.zeros(rows, NS, MODEL_DIM, device="cuda")
    out = attention.fused_attention(q, q, torch.ones_like(q), None, HEADS, DROPOUT, 99)
    keep = out.double().mean().item() * (1.0 - DROPOUT)
    p, n = 230 / 256, rows * HEADS * NS * NS
    sigma = (p * (1 - p) / n) ** 0.5
    log(3, f"attention_fwd keep rate over {n} draws: {keep:.6f} (expected {p:.6f}, "
           f"{abs(keep - p) / sigma:.2f} sigma)")
    assert abs(keep - p) <= 4 * sigma, keep


def phase_serving(model, seed):
    """The serving path at full width; every call's launch count must equal
    the dispatch rule's prediction. Returns the total launches."""
    server = InferenceServer(model, buckets=BUCKETS, seed=seed)
    photo, spec = make_batch(128, seed)

    def sub(batch, n):
        return tuple(a[:n] for a in batch)

    def check(label, expected, fn):
        before = attention.launches
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = attention.launches - before
        log(4, f"{label}: {dt * 1e3:.1f} ms, kernel launches {got} (predicted {expected})")
        assert got == expected, (label, got, expected)
        return out

    attention.launches = 0
    for m, x in enumerate((photo, spec)):
        z = check(f"embed m={m} n=8", encoder_launches(m, 8),
                  lambda x=x, m=m: server.embed(sub(x, 8), modality=m))
        assert z.shape == (8, LATENT_LEN, LATENT_DIM) and torch.isfinite(z).all()
    # bucket 128 also routes the 982x5 cross-attention (R = 12,800 >= 3,417)
    for n, bucket in ((6, 8), (20, 32), (128, 128)):
        out = check(f"crossmodal 0->1 K={K_SERVE} n={n} (bucket {bucket})",
                    encoder_launches(0, bucket) + decoder_launches(1, K_SERVE * bucket),
                    lambda n=n: server.crossmodal(sub(photo, n), sub(spec, n), K=K_SERVE))
        assert out.shape == (K_SERVE, n, NS) and torch.isfinite(out).all()
    mean, lo, hi = check(f"crossmodal_ci 0->1 K={K_SERVE} alpha=0.1 n=32",
                         encoder_launches(0, 32) + decoder_launches(1, K_SERVE * 32),
                         lambda: server.crossmodal_ci(sub(photo, 32), sub(spec, 32),
                                                      K=K_SERVE, alpha=0.1))
    for t in (mean, lo, hi):
        assert t.shape == (32, NS) and torch.isfinite(t).all()
    assert bool((lo <= mean).all() and (mean <= hi).all()), "lo <= mean <= hi violated"
    out = check(f"crossmodal 1->0 K={K_SERVE} n=100 (bucket 128)",
                encoder_launches(1, 128) + decoder_launches(0, K_SERVE * 128),
                lambda: server.crossmodal(sub(spec, 100), sub(photo, 100),
                                          direction=(1, 0), K=K_SERVE))
    assert out.shape == (K_SERVE, 100, LP) and torch.isfinite(out).all()
    rec = check("reconstruct K=2 n=8",
                sum(encoder_launches(m, 8) for m in (0, 1))
                + sum(decoder_launches(d, 2 * 2 * 8) for d in (0, 1)),
                lambda: server.reconstruct((sub(photo, 8), sub(spec, 8)), K=2))
    for e in (0, 1):
        for d, grid in ((0, LP), (1, NS)):
            assert rec[e][d].shape == (2, 8, grid) and np.isfinite(rec[e][d]).all()
    total = attention.launches
    log(4, f"main path: attention_fwd launched {total} times; stats {server.stats()}")
    assert total > 0
    return total


def phase_card_vs_cpu(model, cpu_model, seed):
    """The whole decode on the card (kernel) and on the CPU (plain
    version), fp32: max-abs error over max |CPU| ≤ 1e-4."""
    photo, spec = make_batch(2, seed + 1)
    zs = np.random.default_rng(seed + 2).normal(size=(2, 2, LATENT_LEN, LATENT_DIM))
    zs = torch.from_numpy(zs.astype(np.float32))
    for d, x in ((1, spec), (0, photo)):
        xt = tuple(torch.from_numpy(a) for a in x)
        with torch.inference_mode():
            before = attention.launches
            card = model.vaes[d].decode(zs.cuda(), tuple(a.cuda() for a in xt)).mean
            torch.cuda.synchronize()
            launched = attention.launches - before
            cpu = cpu_model.vaes[d].decode(zs, xt).mean
        err = (card.cpu() - cpu).abs().max().item()
        rel = err / cpu.abs().max().item()
        log(5, f"decode modality {d}: card (kernel launches {launched}) vs CPU max-abs "
               f"{err:.3e}, relative {rel:.3e}")
        assert launched == decoder_launches(d, 4)
        assert np.isfinite(rel) and rel <= 1e-4, (d, rel)


def phase_times(model, seed, sm_clock_mhz):
    """Kernel, plain and library times; end-to-end crossmodal_ci latency."""
    rows_main = 800
    res = {}
    for rows in (rows_main, 3200):
        q, k, v, mask = attention_inputs(rows, NS, NS, True, seed=7)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            ms = time_ms(lambda: attention.fused_attention(qd, kd, vd, mask, HEADS))
            lib = time_ms(sdpa_call(qd, kd, vd, mask))
            bound, by = attention_bound(rows, NS, NS, dtype, True)
            exp_ms = unit_floors(rows * HEADS * NS * NS, sm_clock_mhz)[0]
            name = str(dtype).split(".")[-1]
            log(6, f"attention_fwd R={rows} 982x982 {name}: {ms:.3f} ms; bound {bound:.3f} ms "
                   f"({by}); exp2 floor {exp_ms:.3f} ms; library sdpa {lib:.3f} ms")
            res[(rows, dtype)] = (ms, bound, by, lib)
            del qd, kd, vd
    q, k, v, mask = attention_inputs(rows_main, NS, NS, True, seed=7)
    plain = time_ms(lambda: attention.attention_reference(q, k, v, mask, HEADS), reps=10,
                    warmup=1)
    log(6, f"plain attention_reference R={rows_main} 982x982 float32: {plain:.3f} ms")
    del q, k, v, mask
    torch.cuda.empty_cache()

    photo, spec = make_batch(32, seed + 3)
    for precision in ("fp32", "bf16"):
        srv = InferenceServer(model, buckets=BUCKETS, seed=seed, precision=precision)
        call = lambda: srv.crossmodal_ci(photo, spec, K=K_SERVE, alpha=0.1)  # noqa: E731
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            mean, lo, hi = call()
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        assert torch.isfinite(mean.float()).all()
        med = statistics.median(lat)
        log(6, f"crossmodal_ci 0->1 K={K_SERVE} bucket 32 {precision}: median "
               f"{med * 1e3:.2f} ms, {32 / med:.1f} events/s, peak memory "
               f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        profile_calls(call, f"crossmodal_ci {precision}")
    return res, plain


# -- training ------------------------------------------------------------------

COUNTERS = ("K1 rate>0", "K1", "K2", "K3", "K4")


def kernel_counts():
    return (attention.dropout_launches, attention.launches, attention.bwd_launches,
            laplace.launches, laplace.bwd_launches)


def reset_counts():
    attention.launches = attention.dropout_launches = attention.bwd_launches = 0
    laplace.launches = laplace.bwd_launches = 0


def train_step_prediction(batch_size, dropout):
    """Launches per train step, from the dispatch rules: each routed grid
    launches K1 in the forward and again in remat's re-run, and K2 once in
    the backward; decoders run on M·K·B rows (in train mode:
    dropout), encoders on B rows (always deterministic); each of the M
    experts' likelihoods on a grid of 128 points or more launches K3 and
    K4 once."""
    dec = sum(decoder_launches(d, M * K_TRAIN * batch_size) for d in (0, 1))
    enc = sum(encoder_launches(m, batch_size) for m in (0, 1))
    lik = M * sum(laplace_routes_to_kernel(n) for n in (LP, NS))
    return (2 * dec if dropout > 0 else 0, 2 * (dec + enc), dec + enc, lik, lik)


def m_iwae_loss(model, batch, seed):
    return objectives.m_iwae(model, batch, K_TRAIN, seed=seed)


def phase_training(seed):
    """The flagship train step at bench.py's configuration, TRAIN_STEPS in
    fp32 and TRAIN_STEPS under bf16 autocast, each from fresh weights;
    every step's launches must equal the prediction. Returns the launches
    of the whole run and the step times."""
    batch = to_device(make_batch(B_TRAIN, seed + 10), torch.device("cuda"))
    want = train_step_prediction(B_TRAIN, DROPOUT)
    log(7, f"predicted launches per step {dict(zip(COUNTERS, want))}")
    reset_counts()
    res = {}
    for precision in ("fp32", "bf16"):
        model = flagship(seed)
        opt = adamw(LR)
        state = TrainState.create(model, opt, seed=seed)
        step = make_train_step(model, opt, m_iwae_loss, precision=precision)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(TRAIN_STEPS):
            before = kernel_counts()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            losses.append(loss.item())  # syncs
            times.append(time.perf_counter() - t0)
            got = tuple(b - a for a, b in zip(before, kernel_counts()))
            assert got == want, (precision, i, got, want)
        assert np.isfinite(losses).all(), (precision, losses)
        med = statistics.median(times[1:])  # the first step compiles the Triton kernels
        peak = torch.cuda.max_memory_allocated() / 2**20
        log(7, f"{precision}: losses {', '.join(f'{x:.2f}' for x in losses)}; step times "
               f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; median of steps 2-"
               f"{TRAIN_STEPS} {med * 1e3:.2f} ms = {1 / med:.3f} steps/s = "
               f"{B_TRAIN / med:.1f} samples/s; peak memory {peak:.0f} MiB")
        res[precision] = (med, peak, state, step, batch)
    totals = dict(zip(COUNTERS, kernel_counts()))
    log(7, f"main path (training, {2 * TRAIN_STEPS} steps): launches {totals}")
    assert all(v > 0 for v in totals.values())
    return totals, res


@contextlib.contextmanager
def pinned_noise(seed):
    """Laplace draws become loc + scale·noise, the noise a numpy function of
    (seed, the draw's shape), so the card and the CPU sample alike."""
    original = distributions.Laplace.sample

    def sample(self, generator=None, sample_shape=()):
        shape = distributions._as_shape(sample_shape) + tuple(self.batch_shape)
        noise = np.random.default_rng([seed, *shape]).laplace(size=shape).astype(np.float32)
        return self.loc + self.scale * torch.from_numpy(noise).to(self.loc.device)

    distributions.Laplace.sample = sample
    try:
        yield
    finally:
        distributions.Laplace.sample = original


def _rel_l2(got, want):
    """‖got − want‖ / ‖want‖ over lists of tensors."""
    err2 = sum(((g.cpu() - w) ** 2).sum().item() for g, w in zip(got, want))
    return (err2 / sum((w ** 2).sum().item() for w in want)) ** 0.5


def phase_train_card_vs_cpu(seed):
    """One train step (−m_iwae of the flagship model at dropout 0, B = 4,
    K = 2, pinned posterior noise) on the card (kernels) and on the CPU
    (plain versions), fp32, TF32 off:
      * the loss within 1e-4 relative;
      * the M·K·B importance log-weights lw within 1e-5 of max |lw|;
      * the gradients of mean(lw) within 1e-4 relative, L2 over all
        parameters;
      * the step's gradients within 1e-3 relative, L2 over all parameters.
    The step's tolerance is wider because the estimator weighs each
    sample's lw gradients by softmax(lw) over its M·K draws: at
    lw ≈ −1e4, fp32 holds lw to ~1e-3 absolute in any summation order, and
    a mixed weight (0.3 against 0.7) moves by about that much relatively,
    so two fp32 implementations of the step's gradient differ by 1e-4 to
    1e-3. The gradients of lw itself, free of that amplification, hold the
    1e-4 tolerance."""
    model = flagship(seed, dropout=0.0)
    results = []
    for device in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(device).train()
        params = list(m.parameters())
        batch = to_device(make_batch(4, seed + 20), torch.device(device))
        before = kernel_counts()
        with pinned_noise(seed):
            qz_xs, px_zs, zss = m(batch, K_TRAIN)
        lw = objectives.m_iwae_log_weights(qz_xs, px_zs, zss, batch, m.llik_scalings,
                                           m.pz(device))
        loss = -distributions.log_mean_exp(lw, dim=0).sum()  # = −m_iwae
        step_grads = torch.autograd.grad(loss, params, retain_graph=True)
        if device == "cuda":
            torch.cuda.synchronize()
            got = tuple(b - a for a, b in zip(before, kernel_counts()))
            log(8, f"card step launches {dict(zip(COUNTERS, got))}")
            assert got == train_step_prediction(4, 0.0), got
        lw_grads = torch.autograd.grad(-lw.mean(), params)
        results.append((loss.item(), lw.detach().cpu(), step_grads, lw_grads))
    (l_card, lw_card, g_card, h_card), (l_cpu, lw_cpu, g_cpu, h_cpu) = results
    rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
    rel_lw = ((lw_card - lw_cpu).abs().max() / lw_cpu.abs().max()).item()
    weights = torch.softmax(lw_cpu, dim=0)
    rel_lw_grad, rel_grad = _rel_l2(h_card, h_cpu), _rel_l2(g_card, g_cpu)
    log(8, f"loss card {l_card:.6f} CPU {l_cpu:.6f} (relative {rel_loss:.3e}); log-weights "
           f"max-abs {(lw_card - lw_cpu).abs().max().item():.3e} (relative {rel_lw:.3e}) at "
           f"|lw| up to {lw_cpu.abs().max().item():.4g}, largest importance weight per "
           f"sample {', '.join(f'{w:.3f}' for w in weights.max(0).values.tolist())}; "
           f"gradients relative L2 error: of mean(lw) {rel_lw_grad:.3e}, of the step "
           f"{rel_grad:.3e}")
    assert rel_loss <= 1e-4 and rel_lw <= 1e-5, (rel_loss, rel_lw)
    assert rel_lw_grad <= 1e-4 and rel_grad <= 1e-3, (rel_lw_grad, rel_grad)


def phase_train_times(train, seed, sm_clock_mhz):
    """Each training kernel at the training shapes: K1 (with its saved
    statistics) and K2 at R = M·K·B = 768 rows of 982x982, 20% of keys
    masked and row 0 fully masked, rate 0.1; K3 and K4 at [K·B, 982] rows
    over [B, 982] data. Beside each: its bound, its plain version and, for
    K1, K2 and K1 + K2, scaled_dot_product_attention (timed here only).
    K1 and K2 are also held against their plain versions on these very
    inputs, with phase 3's tolerances. Beside the bounds: the exp2 floor
    and the hash's integer floor at rate 0.1 (one exp2 and one hash per
    pair in K1 and in K2). Then a torch.profiler breakdown of
    one train step in each precision."""
    rows, chunk, dseed = M * K_TRAIN * B_TRAIN, 64, 5
    q, k, v, mask = attention_inputs(rows, NS, NS, True, seed=8, full_row=True)
    dout = torch.randn_like(q)
    slices = chunk_slices(rows, chunk)

    def plain_fwd():
        return torch.cat([attention.attention_reference(
            q[s], k[s], v[s], mask[s], HEADS, DROPOUT, chunk_seed(dseed, s)) for s in slices])

    def plain_bwd():
        grads = [attention.attention_backward_reference(
            q[s], k[s], v[s], mask[s], dout[s], HEADS, DROPOUT, chunk_seed(dseed, s))
            for s in slices]
        return [torch.cat(g) for g in zip(*grads)]

    res = {"plain_f": time_ms(plain_fwd, reps=3, warmup=1),
           "plain_b": time_ms(plain_bwd, reps=3, warmup=1)}
    log(9, f"plain versions R={rows} 982x982 float32 in chunks of {chunk} rows: "
           f"attention_reference rate 0.1 {res['plain_f']:.3f} ms; "
           f"attention_backward_reference (its forward and autograd backward) "
           f"{res['plain_b']:.3f} ms")
    want_out, want_grads = plain_fwd(), plain_bwd()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        qd, kd, vd, dd = (t.to(dtype) for t in (q, k, v, dout))
        fwd0 = time_ms(lambda: attention.fused_attention_fwd(qd, kd, vd, mask, HEADS, 0.0))
        fwd = time_ms(lambda: attention.fused_attention_fwd(qd, kd, vd, mask, HEADS, DROPOUT,
                                                            dseed))
        out, m, l = attention.fused_attention_fwd(qd, kd, vd, mask, HEADS, DROPOUT, dseed)
        bwd = time_ms(lambda: attention.fused_attention_bwd(qd, kd, vd, mask, out, m, l, dd,
                                                            HEADS, DROPOUT, dseed))
        grads = attention.fused_attention_bwd(qd, kd, vd, mask, out, m, l, dd, HEADS, DROPOUT,
                                              dseed)
        torch.cuda.synchronize()
        rel = [_rel(out, want_out)] + [_rel(g, w) for g, w in zip(grads, want_grads)]
        err_f = (out.float() - want_out).abs().max().item()
        err_b = max((g.float() - w).abs().max().item() for g, w in zip(grads, want_grads))
        log(9, f"R={rows} 982x982 {name} rate 0.1 against the plain versions: K1 max-abs "
               f"{err_f:.3e} (rel {rel[0]:.2e}); K2 dq, dk, dv rel "
               + ", ".join(f"{e:.2e}" for e in rel[1:]) + f" (max-abs {err_b:.3e})")
        assert all(np.isfinite(e) for e in rel), (name, rel)
        if dtype == torch.float32:
            assert err_f <= 1e-5 and all(e <= 1e-4 for e in rel[1:]), (err_f, rel)
            res["err_f"], res["err_b"] = err_f, err_b
        else:
            assert all(e <= 2e-2 for e in rel), rel
        del out, m, l, grads
        lib_f0 = time_ms(sdpa_call(qd, kd, vd, mask))
        lib_f = time_ms(sdpa_call(qd, kd, vd, mask, DROPOUT))
        lib_b = time_ms(sdpa_bwd_call(qd, kd, vd, mask, DROPOUT))
        lib_fb = time_ms(sdpa_train_call(qd, kd, vd, mask, DROPOUT))
        b_f = attention_bound(rows, NS, NS, dtype, True, stats=True)
        b_b = attention_bwd_bound(rows, NS, NS, dtype)
        exp_f, hash_f = unit_floors(rows * HEADS * NS * NS, sm_clock_mhz)
        log(9, f"R={rows} 982x982 {name}: K1 rate 0 {fwd0:.3f} ms (library sdpa no dropout "
               f"{lib_f0:.3f} ms), rate 0.1 {fwd:.3f} ms (library sdpa dropout 0.1 "
               f"{lib_f:.3f} ms); bound {b_f[0]:.3f} ms ({b_f[1]}), exp2 floor {exp_f:.3f} ms, "
               f"hash floor at rate 0.1 {hash_f:.3f} ms; K2 {bwd:.3f} ms (bound {b_b[0]:.3f} "
               f"ms, {b_b[1]}; the same exp2 and hash floors; library sdpa backward "
               f"{lib_b:.3f} ms); K1 + K2 {fwd + bwd:.3f} ms, "
               f"library sdpa forward + backward {lib_fb:.3f} ms")
        res[dtype] = dict(fwd0=fwd0, fwd=fwd, bwd=bwd, lib_f0=lib_f0, lib_f=lib_f, lib_b=lib_b,
                          lib_fb=lib_fb, b_f=b_f, b_b=b_b)
        del qd, kd, vd, dd
        torch.cuda.empty_cache()
    del q, k, v, mask, dout, want_out, want_grads
    torch.cuda.empty_cache()

    # K3/K4 at the B = 192 step's [K·B, 982] rows and at the flagship
    # driver's (B = 16); beside each, one torch.sum over the same fp32 rows,
    # a library call that reads loc's bytes and does less work than K3
    for b in (B_TRAIN, B_DRIVER):
        R, x_rows, suffix = K_TRAIN * b, b, "" if b == B_TRAIN else f"_{K_TRAIN * b}"
        g = torch.Generator("cuda").manual_seed(9)
        loc = torch.randn(R, NS, device="cuda", generator=g)
        x = torch.randn(x_rows, NS, device="cuda", generator=g)
        lmask = torch.rand(R, NS, device="cuda", generator=g) < 0.2
        gout = torch.randn(R, device="cuda", generator=g)
        calls = {
            "k3": lambda: laplace.masked_laplace_loglik_fwd(loc, x, lmask, BIG_SPECTRA),
            "k4": lambda: laplace.masked_laplace_loglik_bwd(loc, x, lmask, BIG_SPECTRA, gout),
            "p3": lambda: laplace.masked_laplace_loglik_reference(loc, x, lmask, BIG_SPECTRA),
            "p4": lambda: laplace.masked_laplace_grad_reference(loc, x, lmask, BIG_SPECTRA,
                                                                 gout),
            "sum": lambda: torch.sum(loc, dim=1)}
        host = {key: time_ms(fn, inner=100) for key, fn in calls.items()}
        dev = {key: device_ms(fn) for key, fn in calls.items()}
        b3, b4 = laplace_bound(R, NS, x_rows, False), laplace_bound(R, NS, x_rows, True)
        res.update({key + suffix: t for key, t in dev.items()})
        res["b3" + suffix], res["b4" + suffix] = b3, b4
        us = {key: f"{t * 1e3:.3f} us" for key, t in dev.items()}
        log(9, f"laplace [{R}, {NS}] over [{x_rows}, {NS}] data, device time per call: K3 "
               f"{us['k3']} (bound {b3[0] * 1e3:.3f} us, {b3[1]}; plain {us['p3']}); K4 "
               f"{us['k4']} (bound {b4[0] * 1e3:.3f} us, {b4[1]}; plain {us['p4']}); "
               f"torch.sum(loc, dim=1) {us['sum']}; no single library call computes K3 or K4")
        log(9, f"laplace [{R}, {NS}] wrapper throughput (100 back-to-back calls between CUDA "
               f"events, set by the host): "
               + ", ".join(f"{key} {t * 1e3:.2f} us" for key, t in host.items()))
    for precision, (_, _, state, step, batch) in train.items():
        profile_calls(lambda: step(state, batch), f"train step {precision}", n=2, top=12,
                      phase=9)
    return res


# -- the training drivers --------------------------------------------------------

def driver_args(seed, root, *extra):
    return [f"train.seed={seed}", f"train.ckpt_dir={root}",
            f"train.log_dir={os.path.join(root, 'logs')}", *extra]


def flagship_ckpt(root):
    cfg = PhotoSpectraMMVAEConfig()
    return os.path.join(root, f"goldstein_photospec_{cfg.model.latent_len}-"
                              f"{cfg.model.latent_dim}_K{cfg.train.K}_beta{cfg.train.beta}")


def _params_rel(a, b):
    """max |a − b| over the parameters, over max |a|."""
    diff = max((x - y).abs().max().item() for x, y in zip(a.parameters(), b.parameters()))
    return diff / max(x.abs().max().item() for x in a.parameters())


def phase_drivers(seed):
    """Phase 10: the training drivers as a user runs them, at the flagship
    widths, on the synthetic data of --seed. Returns the launches of (a)'s
    run and (c)'s serving, and the numbers of (e)."""
    cfg = PhotoSpectraMMVAEConfig()
    assert cfg.train.batch_size == B_DRIVER and cfg.train.K == K_TRAIN
    assert cfg.model.dropout == DROPOUT
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    dir_a, dir_b, dir_d = (os.path.join(SMOKE_DIR, s) for s in ("a", "b", "d"))
    per_step = train_step_prediction(B_DRIVER, DROPOUT)
    log(10, f"predicted launches per driver step (B = {B_DRIVER}) "
            f"{dict(zip(COUNTERS, per_step))}")

    # (a) train 3 epochs, saving every epoch; each epoch's launches checked
    epochs = []
    mark = {}

    def on_epoch(epoch, state, loss):
        now, counts = time.perf_counter(), kernel_counts()
        steps = state.step - mark["step"]
        got = tuple(c - p for c, p in zip(counts, mark["counts"]))
        want = tuple(steps * w for w in per_step)
        log(10, f"(a) epoch {epoch + 1}: loss {loss:.6f}, {steps} steps, "
                f"{now - mark['t']:.3f} s (with its checkpoint save), launches "
                f"{dict(zip(COUNTERS, got))}")
        assert np.isfinite(loss), (epoch, loss)
        assert got == want, (epoch, got, want)
        epochs.append((now - mark["t"], steps))
        mark.update(t=time.perf_counter(), counts=kernel_counts(), step=state.step)

    reset_counts()
    mark.update(t=time.perf_counter(), counts=kernel_counts(), step=0)
    state_a, losses_a = train_photospectra.main(
        driver_args(seed, dir_a, f"train.epochs={DRIVER_EPOCHS}", "train.save_every=1"),
        callback=on_epoch)
    launches_a = dict(zip(COUNTERS, kernel_counts()))
    log(10, f"(a) main path (drivers): launches {launches_a}")
    assert len(losses_a) == DRIVER_EPOCHS and all(v > 0 for v in launches_a.values())
    rates = [B_DRIVER * steps / t for t, steps in epochs]
    med_rate = statistics.median(rates[1:])
    log(10, f"(e) driver samples/s per epoch (host clock, the epoch ending in the loss's "
            f"float): {', '.join(f'{r:.1f}' for r in rates)}; median of epochs 2-"
            f"{DRIVER_EPOCHS} {med_rate:.1f} samples/s "
            f"({B_DRIVER / med_rate * 1e3:.2f} ms per step)")

    # (b) 2 epochs, then resumed to 3: the same run as (a)
    train_photospectra.main(driver_args(seed, dir_b, "train.epochs=2", "train.save_every=1"))
    state_b, losses_b = train_photospectra.main(driver_args(
        seed, dir_b, f"train.epochs={DRIVER_EPOCHS}", "train.resume=true", "train.save_every=1"))
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(losses_a, losses_b))
    param_rel = _params_rel(state_a.model, state_b.model)
    bitwise = all(torch.equal(x, y) for x, y in zip(state_a.model.parameters(),
                                                     state_b.model.parameters()))
    log(10, f"(b) kill-and-resume against (a): losses {losses_b} vs {losses_a}, max relative "
            f"difference {loss_rel:.3e}; parameters max-abs difference over max |param| "
            f"{param_rel:.3e} (bitwise equal: {bitwise}); step {state_b.step} vs {state_a.step}")
    assert state_b.step == state_a.step and len(losses_b) == DRIVER_EPOCHS
    assert loss_rel <= 1e-6 and param_rel <= 1e-6, (loss_rel, param_rel)

    # (c) serve (a)'s checkpoint: bitwise the server over (a)'s model
    data = resolve_dataset(None, "goldstein", seed=seed)
    idx = np.asarray(data["testing_idx"])[:N_HELD_OUT]
    photo, spec = (tuple(t.numpy() for t in m)
                   for m in multimodal_tuple(data, idx=idx, device="cpu"))
    want = encoder_launches(0, N_HELD_OUT) + decoder_launches(1, K_SERVE * N_HELD_OUT)
    outs = []
    reset_counts()
    for label, make in (("from_checkpoint", lambda: InferenceServer.from_checkpoint(
                             flagship_ckpt(dir_a), buckets=BUCKETS, seed=seed)),
                        ("in-memory model", lambda: InferenceServer(
                            state_a.model, buckets=BUCKETS, seed=seed))):
        server = make()
        before = attention.launches
        outs.append(server.crossmodal_ci(photo, spec, K=K_SERVE, alpha=0.1))
        torch.cuda.synchronize()
        got = attention.launches - before
        log(10, f"(c) {label}: crossmodal_ci 0->1 K={K_SERVE} on {N_HELD_OUT} held-out events, "
                f"K1 launches {got} (predicted {want})")
        assert got == want, (label, got, want)
    for t in outs[0]:
        assert t.shape == (N_HELD_OUT, NS) and torch.isfinite(t).all()
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    log(10, f"(c) from_checkpoint against the in-memory model: bitwise equal {same}")
    assert same
    serve_launches = attention.launches

    # (d) the other drivers, one epoch each (ZTF at repeat_factor 1, a cut
    # from the drivers' 10 to keep the smoke short)
    log(10, "(d) cut: the ZTF drivers run at repeat_factor=1 (their default is 10)")
    for name, driver, extra in (("train_spectra", train_spectra, ()),
                                ("train_photometry", train_photometry, ()),
                                ("train_ztf_photospect", train_ztf_photospect,
                                 ("repeat_factor=1",)),
                                ("train_ztf_spectra", train_ztf_spectra, ("repeat_factor=1",))):
        t0 = time.perf_counter()
        state, losses = driver.main(driver_args(seed, dir_d, "train.epochs=1", *extra))
        torch.cuda.synchronize()
        log(10, f"(d) {name}: 1 epoch, {state.step} steps, loss {losses[0]:.6f}, "
                f"{time.perf_counter() - t0:.2f} s with its set-up")
        assert len(losses) == 1 and np.isfinite(losses).all(), (name, losses)

    # (e) the device's busy share of one epoch of the driver itself: a copy
    # of (a)'s checkpoint resumed for two more epochs, the profiler running
    # from the end of the first to the end of the second (the same window
    # as (a)'s samples/s: augmentation, the steps, the checkpoint save)
    from torch.profiler import ProfilerActivity, profile

    dir_e = os.path.join(SMOKE_DIR, "e")
    shutil.copytree(flagship_ckpt(dir_a), flagship_ckpt(dir_e))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True)
    window = {}

    def on_profiled_epoch(epoch, state, loss):
        torch.cuda.synchronize()
        if epoch == DRIVER_EPOCHS:
            prof.start()
            window.update(t=time.perf_counter(), step=state.step)
        else:
            window.update(wall_us=(time.perf_counter() - window["t"]) * 1e6,
                          steps=state.step - window["step"])
            prof.stop()

    train_photospectra.main(driver_args(seed, dir_e, f"train.epochs={DRIVER_EPOCHS + 2}",
                                        "train.resume=true", "train.save_every=1"),
                            callback=on_profiled_epoch)
    busy = report_profile(prof, window["wall_us"], 1,
                          f"epoch {DRIVER_EPOCHS + 2} of train_photospectra.main "
                          f"({window['steps']} steps, resumed from (a)'s checkpoint)",
                          top=10, phase=10)
    return launches_a, serve_launches, med_rate, busy


def _device_us(event):
    return getattr(event, "self_device_time_total", None) or getattr(
        event, "self_cuda_time_total", 0)


def _is_kernel(event):
    """A device-side event (a kernel or copy), not the host op that
    launched it, which reports the same device time again, nor a named
    range on the device's timeline (``Optimizer.step``), which spans
    kernels counted on their own."""
    from torch.autograd import DeviceType

    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def profile_calls(call, label, n=3, top=8, phase=6):
    """Where the time of ``call`` goes: device time by kernel under
    torch.profiler, and the device's busy share of the (profiled) wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return report_profile(prof, wall_us, n, label, top, phase)


def report_profile(prof, wall_us, n, label, top, phase):
    """Log the device time by kernel of a finished profile over ``n`` calls
    in ``wall_us``; returns the device's busy share of that wall."""
    events = [e for e in prof.key_averages() if _is_kernel(e) and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in events)
    log(phase, f"profile {label}: {n} calls, wall {wall_us / n / 1e3:.2f} ms/call under the "
               f"profiler, device busy {busy_us / n / 1e3:.2f} ms/call ({busy_us / wall_us:.1%})")
    for e in sorted(events, key=_device_us, reverse=True)[:top]:
        log(phase, f"  {_device_us(e) / n / 1e3:8.3f} ms/call {e.count / n:6.1f} launches/call "
                   f"{e.key[:100]}")
    return busy_us / wall_us


def device_ms(call, n=100):
    """Device milliseconds per ``call``: the time of the kernels it
    launches under torch.profiler, summed, over ``n`` calls (the host's
    launch cost between them left out)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    busy_us = sum(_device_us(e) for e in prof.key_averages() if _is_kernel(e))
    assert busy_us > 0, "the profiler saw no device time"
    return busy_us / n / 1e3


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only", file=sys.stderr)
        return 1
    sm_clock = phase_environment()
    phase_build()
    errs = phase_kernel_vs_plain()
    model = flagship(args.seed)
    cpu_model = copy.deepcopy(model).eval()
    serving_launches = phase_serving(model, args.seed)
    phase_card_vs_cpu(model, cpu_model, args.seed)
    res, plain = phase_times(model, args.seed, sm_clock)
    del model, cpu_model
    torch.cuda.empty_cache()
    train_launches, train = phase_training(args.seed)
    phase_train_card_vs_cpu(args.seed)
    t = phase_train_times(train, args.seed, sm_clock)
    del train
    torch.cuda.empty_cache()
    drivers, drivers_serving, rate, busy = phase_drivers(args.seed)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(10, f"flagship driver (B = {B_DRIVER}, K = {K_TRAIN}, dropout {DROPOUT}, fp32): median "
            f"{rate:.1f} samples/s over epochs 2-{DRIVER_EPOCHS}; device busy {busy:.1%} of a "
            f"profiled epoch; on {smi}")
    ms, bound_ms, by, lib = res[(800, torch.float32)]
    ms16, _, _, lib16 = res[(800, torch.bfloat16)]
    f32, b16 = t[torch.float32], t[torch.bfloat16]
    errs["attention_fwd_dropout"] = max(errs["attention_fwd_dropout"], t["err_f"])
    errs["attention_bwd"] = max(errs["attention_bwd"], t["err_b"])
    attn_src, lap_src = "vaesne_tpu_torch/csrc/attention_{}.cu", "vaesne_tpu_torch/ops/laplace.py"
    r32 = f"_{K_TRAIN * B_DRIVER}"
    rows = [
        ("attention_fwd", "cuda", attn_src.format("fwd"), "vaesne_tpu/ops/attention.py:304",
         serving_launches, errs["attention_fwd"], ms, plain, (bound_ms, by), lib, ms16, lib16,
         drivers_serving),
        ("attention_fwd_dropout", "cuda", attn_src.format("fwd"),
         "vaesne_tpu/ops/attention.py:304", train_launches["K1 rate>0"],
         errs["attention_fwd_dropout"], f32["fwd"], t["plain_f"], f32["b_f"], f32["lib_f"],
         b16["fwd"], b16["lib_f"], drivers["K1 rate>0"]),
        ("attention_bwd", "cuda", attn_src.format("bwd"), "vaesne_tpu/ops/attention.py:353",
         train_launches["K2"], errs["attention_bwd"], f32["bwd"], t["plain_b"], f32["b_b"],
         f32["lib_b"], b16["bwd"], b16["lib_b"], drivers["K2"]),
        ("laplace_fwd", "triton", lap_src, "vaesne_tpu/ops/laplace.py:30",
         train_launches["K3"], errs["laplace_fwd"], t["k3"], t["p3"], t["b3"], None, None, None,
         drivers["K3"]),
        ("laplace_bwd", "triton", lap_src, "vaesne_tpu/ops/laplace.py:38",
         train_launches["K4"], errs["laplace_bwd"], t["k4"], t["p4"], t["b4"], None, None, None,
         drivers["K4"]),
    ]
    # ms/library_ms are fp32; ms_bf16/library_ms_bf16 the same calls on bf16
    # inputs (null for the fp32-only Laplace kernels); launches_drivers counts
    # phase 10's path (K1 at rate 0: the from_checkpoint serving); the Laplace
    # rows add their time at the drivers' [32, 982] and torch.sum's at both
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    laplace_at_32 = {
        name: {f"ms{r32}": t[f"k{n}{r32}"], f"bound_ms{r32}": t[f"b{n}{r32}"][0],
               "torch_sum_ms": t["sum"], f"torch_sum_ms{r32}": t[f"sum{r32}"]}
        for name, n in (("laplace_fwd", 3), ("laplace_bwd", 4))}
    print(json.dumps({"kernels": [
        dict(zip(keys, r[:8]), bound_ms=r[8][0], bound_by=r[8][1], library_ms=r[9],
             ms_bf16=r[10], library_ms_bf16=r[11], launches_drivers=r[12],
             **laplace_at_32.get(r[0], {}))
        for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
