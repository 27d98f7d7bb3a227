"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with an NVIDIA H100 (Hopper,
sm_90a) and nvcc. Phases, each printing its own lines:

  1. environment: torch/CUDA versions, the card's name and power limit,
     TF32 off for matmuls and cuDNN;
  2. build: every kernel under vaesne_tpu_torch/csrc/ with nvcc;
  3. each kernel against its plain PyTorch version on the card, fp32 and
     bf16, at the shapes the serving path gives it;
  4. the serving path at the flagship model's full width (random weights
     from --seed): embed, crossmodal, crossmodal_ci and reconstruct through
     InferenceServer, with the kernel's launch count checked against what
     the dispatch rule predicts for every call;
  5. the whole decode on the card (kernel) against the same module on the
     CPU (plain version);
  6. times: the kernel, its plain version and the library yardstick
     (scaled_dot_product_attention, timed here only) with CUDA events, and
     the end-to-end crossmodal_ci latency, and a torch.profiler breakdown
     of that call by kernel.

Any failure raises and exits non-zero before the last line, which is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import vaesne_tpu_torch.ops.attention as attention
from vaesne_tpu_torch import InferenceServer, PhotometricVAE, PhotoSpecMMVAE, SpectraVAE, init_params
from vaesne_tpu_torch.ops import _build, routes_to_kernel

# the flagship model (vaesne_tpu/experiments/train_photospectra.py, bench.py)
NUM_BANDS, LATENT_LEN, LATENT_DIM = 6, 4, 4
MODEL_DIM, FF_DIM, HEADS, LAYERS = 32, 32, 4, 4
LP, NS = 60, 982  # light-curve points, spectrum bins
BUCKETS = (8, 32, 128, 512)
K_SERVE = 100

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s, fp32
# FMA-pipe flop/s, bf16 tensor-core flop/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
MUFU_PER_SM_CLK = 16  # exp2 results per SM per clock


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def make_batch(n, seed):
    """Host-side (photometry, spectra) batch at the Goldstein contract."""
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


def flagship(seed):
    vaes = [PhotometricVAE(num_bands=NUM_BANDS, latent_len=LATENT_LEN, latent_dim=LATENT_DIM,
                           model_dim=MODEL_DIM, ff_dim=FF_DIM, num_heads=HEADS,
                           num_layers=LAYERS),
            SpectraVAE(latent_len=LATENT_LEN, latent_dim=LATENT_DIM, model_dim=MODEL_DIM,
                       ff_dim=FF_DIM, num_heads=HEADS, num_layers=LAYERS)]
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

def time_ms(fn, reps=10, warmup=3):
    """Median milliseconds of ``fn`` on the card, CUDA events around each run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def attention_bound(rows, lq, lk, dtype, masked):
    """(ms, resource): the least time for one launch, from the bytes it
    must move (each input read once, the output written once) and its
    flops at the card's peak for the dtype."""
    dh = MODEL_DIM // HEADS
    size = torch.finfo(dtype).bits // 8
    nbytes = rows * (2 * lq + 2 * lk) * MODEL_DIM * size + (rows * lk if masked else 0)
    flops = rows * HEADS * lq * lk * 4 * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_call(q, k, v, mask):
    """The library yardstick: one scaled_dot_product_attention call with
    the −1e9 float mask, on [R, H, L, Dh] copies made outside the timing."""
    r, lq, e = q.shape
    dh = e // HEADS
    q4, k4, v4 = (t.view(r, -1, HEADS, dh).transpose(1, 2).contiguous() for t in (q, k, v))
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill(mask, -1e9)
    bias = bias[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias)


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
            if "Used" in line or "spill" in line:
                log(2, f"{name}: {line.strip()}")


def phase_kernel_vs_plain():
    """fp32: max-abs ≤ 1e-5 (sums in another order). bf16: max-abs error
    over max |plain| ≤ 2e-2, against the plain version on fp32 inputs."""
    worst = 0.0
    cases = [("982x982 masked, row 0 fully masked", 64, NS, NS, True),
             ("982x5", 256, NS, LATENT_LEN + 1, False),
             ("60x60 masked", 256, LP, LP, True),
             ("60x4", 256, LP, LATENT_LEN, False)]
    for i, (label, rows, lq, lk, masked) in enumerate(cases):
        q, k, v, mask = attention_inputs(rows, lq, lk, masked, seed=100 + i, full_row=masked)
        ref = attention.attention_reference(q, k, v, mask, HEADS)
        out = attention.fused_attention(q, k, v, mask, HEADS)
        torch.cuda.synchronize()
        err32 = (out - ref).abs().max().item()
        out16 = attention.fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, HEADS)
        torch.cuda.synchronize()
        assert out16.dtype == torch.bfloat16
        err16 = ((out16.float() - ref).abs().max() / ref.abs().max()).item()
        log(3, f"attention_fwd R={rows} {label}: fp32 max-abs {err32:.3e}, "
               f"bf16 rel {err16:.3e}")
        assert np.isfinite(err32) and err32 <= 1e-5, (label, err32)
        assert np.isfinite(err16) and err16 <= 2e-2, (label, err16)
        worst = max(worst, err32)
        if masked:  # the fully masked row averages v uniformly
            uniform = v[0].mean(0).expand(lq, -1)
            assert torch.allclose(out[0], uniform, atol=1e-5), label
    return worst


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
            exps = rows * HEADS * NS * NS
            n_sm = torch.cuda.get_device_properties(0).multi_processor_count
            exp_ms = exps / (n_sm * MUFU_PER_SM_CLK * sm_clock_mhz * 1e6) * 1e3
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


def _device_us(event):
    return getattr(event, "self_device_time_total", None) or getattr(
        event, "self_cuda_time_total", 0)


def _is_kernel(event):
    """A device-side event (a kernel or copy), not the host op that
    launched it, which reports the same device time again."""
    from torch.autograd import DeviceType

    return event.device_type == DeviceType.CUDA


def profile_calls(call, label, n=3, top=8):
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
    events = [e for e in prof.key_averages() if _is_kernel(e) and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in events)
    log(6, f"profile {label}: {n} calls, wall {wall_us / n / 1e3:.2f} ms/call under the "
           f"profiler, device busy {busy_us / n / 1e3:.2f} ms/call ({busy_us / wall_us:.1%})")
    for e in sorted(events, key=_device_us, reverse=True)[:top]:
        log(6, f"  {_device_us(e) / n / 1e3:8.3f} ms/call {e.count / n:6.1f} launches/call "
               f"{e.key[:100]}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only", file=sys.stderr)
        return 1
    sm_clock = phase_environment()
    phase_build()
    max_err = phase_kernel_vs_plain()
    model = flagship(args.seed)
    cpu_model = copy.deepcopy(model).eval()
    launches = phase_serving(model, args.seed)
    phase_card_vs_cpu(model, cpu_model, args.seed)
    res, plain = phase_times(model, args.seed, sm_clock)
    ms, bound, by, lib = res[(800, torch.float32)]
    print(json.dumps({"kernels": [{
        "name": "attention_fwd", "route": "cuda",
        "source": "vaesne_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "vaesne_tpu/ops/attention.py:304",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
        "bound_ms": bound, "bound_by": by, "library_ms": lib}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
