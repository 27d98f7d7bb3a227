"""Compare checkouts of the port on one CUDA card, in turns.

    python3 chip_ab.py --tree change=. --tree parent=build/parent --order change,parent,parent,change

Each turn runs in its own process from the root of one checkout and
imports that checkout's ``vaesne_tpu_torch`` and ``chip_smoke`` (whose
helpers it uses, so a checkout needs both), building its kernels there.
A turn measures, on the flagship shapes of ``chip_smoke.py``:

  * K3 (``masked_laplace_loglik_fwd``) and K4 (``masked_laplace_loglik_bwd``)
    through the flat form [K·B, 982] over [B, 982] data, which every
    checkout has, at the step's K = 2, B = 192, the drivers' B = 16 and the
    ZTF driver's K = 8, B = 32, loc in fp32 and bf16 (a checkout that reads
    fp32 only pays its cast inside the call): device time per call under
    torch.profiler and the wrapper's host time per call;
  * one ``MaskedGridLaplace.grid_loglik`` forward, and forward + backward
    into the whole stack, on expert 0's [K, B, 982] slice of a stacked
    [2·K, B, 982] decode as ``MMVAE.forward`` hands it over: device time and
    kernels per call;
  * K1 (``fused_attention_fwd``, with its statistics) and K2
    (``fused_attention_bwd``) at R = 768 rows of 982x982, 20% of keys
    masked, at rate 0 and 0.1, fp32 and bf16, medians of 10 with CUDA
    events, beside scaled_dot_product_attention without dropout and its
    backward with dropout;
  * K1 at rate 0 without statistics (the serving call) at R = 800 and 3200;
  * the m-IWAE train step (B = 192, K = 2, dropout 0.1, remat), median of
    steps 2-5, fp32 and bf16;
  * ``crossmodal_ci`` (K = 100, bucket 32), median of 10 calls, fp32 and
    bf16.

The parent process prints the card's name and power limit, then one JSON
line per turn, in order. Run it on the card only: without a
CUDA device a turn exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def worker():
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import vaesne_tpu_torch.ops.attention as attention
    from vaesne_tpu_torch import InferenceServer, TrainState, adamw, make_train_step
    from vaesne_tpu_torch.training import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    laplace_turn(cs, out)
    rows, heads, rate, dseed = 768, cs.HEADS, cs.DROPOUT, 5
    q, k, v, mask = cs.attention_inputs(rows, cs.NS, cs.NS, True, seed=8, full_row=True)
    dout = torch.randn_like(q)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        qd, kd, vd, dd = (t.to(dtype) for t in (q, k, v, dout))
        o, m, l = attention.fused_attention_fwd(qd, kd, vd, mask, heads, 0.0)
        out[f"k2_rate0_{name}"] = cs.time_ms(
            lambda: attention.fused_attention_bwd(qd, kd, vd, mask, o, m, l, dd, heads))
        o, m, l = attention.fused_attention_fwd(qd, kd, vd, mask, heads, rate, dseed)
        out[f"k1_rate0_{name}"] = cs.time_ms(
            lambda: attention.fused_attention_fwd(qd, kd, vd, mask, heads, 0.0))
        out[f"k1_rate01_{name}"] = cs.time_ms(
            lambda: attention.fused_attention_fwd(qd, kd, vd, mask, heads, rate, dseed))
        out[f"k2_rate01_{name}"] = cs.time_ms(
            lambda: attention.fused_attention_bwd(qd, kd, vd, mask, o, m, l, dd, heads, rate,
                                                  dseed))
        out[f"sdpa_rate0_{name}"] = cs.time_ms(cs.sdpa_call(qd, kd, vd, mask))
        out[f"sdpa_bwd_rate01_{name}"] = cs.time_ms(cs.sdpa_bwd_call(qd, kd, vd, mask, rate))
        del qd, kd, vd, dd, o, m, l
    del q, k, v, mask, dout
    torch.cuda.empty_cache()
    for rows in (800, 3200):
        q, k, v, mask = cs.attention_inputs(rows, cs.NS, cs.NS, True, seed=7)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            out[f"k1_serve_R{rows}_{str(dtype).split('.')[-1]}"] = cs.time_ms(
                lambda: attention.fused_attention(qd, kd, vd, mask, heads))
            del qd, kd, vd
        del q, k, v, mask
        torch.cuda.empty_cache()

    seed = 0
    batch = to_device(cs.make_batch(cs.B_TRAIN, seed + 10), torch.device("cuda"))
    for precision in ("fp32", "bf16"):
        model = cs.flagship(seed)
        opt = adamw(cs.LR)
        state = TrainState.create(model, opt, seed=seed)
        step = make_train_step(model, opt, cs.m_iwae_loss, precision=precision)
        times = []
        for _ in range(cs.TRAIN_STEPS):
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            loss.item()
            times.append(time.perf_counter() - t0)
        out[f"train_step_ms_{precision}"] = statistics.median(times[1:]) * 1e3
        del model, opt, state, step
        torch.cuda.empty_cache()

    model = cs.flagship(seed)
    photo, spec = cs.make_batch(32, seed + 3)
    for precision in ("fp32", "bf16"):
        srv = InferenceServer(model, buckets=cs.BUCKETS, seed=seed, precision=precision)
        for _ in range(2):
            srv.crossmodal_ci(photo, spec, K=cs.K_SERVE, alpha=0.1)
        torch.cuda.synchronize()
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            srv.crossmodal_ci(photo, spec, K=cs.K_SERVE, alpha=0.1)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        out[f"crossmodal_ci_ms_{precision}"] = statistics.median(lat) * 1e3
    print(json.dumps(out), flush=True)
    return 0


def laplace_turn(cs, out):
    """The K3/K4 and grid_loglik entries of a turn (see the module
    docstring), into ``out``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import vaesne_tpu_torch.ops.laplace as laplace
    from vaesne_tpu_torch.distributions import MaskedGridLaplace

    def device(call, n=100):
        """(device us per call, kernels per call) under torch.profiler: each
        kernel's mean time times its launches per call, rounded (the
        profiler may drop a few of the first events). Written out here
        because an older checkout's chip_smoke has no such helper."""
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if cs._is_kernel(e) and e.count > 0]
        per_call = [max(1, round(e.count / n)) for e in events]
        return (sum(cs._device_us(e) / e.count * c for e, c in zip(events, per_call)),
                sum(per_call))

    big, n_pts = cs.BIG_SPECTRA, cs.NS
    for k, b in ((2, cs.B_TRAIN), (2, cs.B_DRIVER), (8, 32)):
        g = torch.Generator("cuda").manual_seed(9)
        stack = torch.randn(b, 2 * k, n_pts, device="cuda", generator=g)
        mask_stack = torch.rand(b, 2 * k, n_pts, device="cuda", generator=g) < 0.2
        x = torch.randn(b, n_pts, device="cuda", generator=g)
        gout = torch.randn(k, b, device="cuda", generator=g)
        flat_mask = mask_stack[:, :k].reshape(b * k, n_pts)
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{k}x{b}_{str(dtype)[6:]}"
            flat_loc = stack[:, :k].reshape(b * k, n_pts).to(dtype)
            g_flat = gout.T.reshape(-1)
            calls = {"k3": lambda: laplace.masked_laplace_loglik_fwd(flat_loc, x, flat_mask, big),
                     "k4": lambda: laplace.masked_laplace_loglik_bwd(flat_loc, x, flat_mask, big,
                                                                     g_flat)}
            for key, fn in calls.items():
                out[f"{key}_us_{tag}"] = device(fn)[0]
                out[f"{key}_host_us_{tag}"] = cs.time_ms(fn, inner=100) * 1e3
            leaf = stack.to(dtype).transpose(0, 1).detach().requires_grad_()
            d = MaskedGridLaplace(leaf[:k], mask_stack.transpose(0, 1)[:k], big)

            def fwd_bwd():
                leaf.grad = None
                d.grid_loglik(x).backward(gout)

            (out[f"grid_fwd_us_{tag}"], out[f"grid_fwd_kernels_{tag}"]) = device(
                lambda: d.grid_loglik(x))
            (out[f"grid_fwd_bwd_us_{tag}"], out[f"grid_fwd_bwd_kernels_{tag}"]) = device(fwd_bwd)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                        help="a checkout to measure (repeatable)")
    parser.add_argument("--order", required=False, default="",
                        help="comma-separated labels, one turn each, in this order")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        return worker()
    trees = dict(t.split("=", 1) for t in args.tree)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    for label in args.order.split(","):
        tree = os.path.abspath(trees[label])
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker"], cwd=tree,
                             capture_output=True, text=True, timeout=1500)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"turn {label} failed with exit {res.returncode}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": label, "seconds": round(time.perf_counter() - t0, 1),
                          **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
