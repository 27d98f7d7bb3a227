"""Driver ``eval_suite``: whole passes of the evaluation over a test set,
as the Goldstein evaluation driver runs one.

Each pass is ``evaluation.mmvae_reconstruction_suite`` (K reconstructions
of every test event in every cell, chunks of ``chunk`` events, the
posterior-sample band, denormalised) and then ``evaluation.evaluate_mmvae``
over its reconstructions (residual, band coverage, band width and MSE per
phase, numpy on the host); no file is written. The model is the driver's
with the benchmark's weights; the test set is the synthetic data set's
test split. Pass p draws from its own seed. Set-up runs one pass.

``eval_events_per_s``: the test events of every whole pass in the window
over the window, which ends with the first pass that ends ``--seconds``
after the start.

Correctness: the last pass's reconstructions of a few test events drawn
from the seed (the first event of the padded last chunk among them), every
cell, against the reference's from the same inputs and seed; and the
pass's metrics against the reference's metrics over the reference's own
``LC2spec`` of every test event: the band coverage as the number of
(event, bin) indicators that differ, the others as their largest gap.

Spans: ``bench.suite``, ``bench.metrics``.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np

from benchmark import core, counts, program
from benchmark.reference import evaluate as reference
from benchmark.reference.model import Net, dims_of


def run(cell) -> dict:
    torch = cell.torch
    from vaesne_tpu_torch.data import multimodal_tuple
    from vaesne_tpu_torch.evaluation import evaluate_mmvae, mmvae_reconstruction_suite
    from vaesne_tpu_torch.ops import _build

    config, traffic, spans, device = cell.config, cell.traffic, cell.spans, cell.device
    K, chunk = traffic["K"], traffic["chunk"]
    dtype = program.precision(config)
    if device.type == "cuda":
        _build.build_all()
    raw = program.data(config, cell.seed)
    model = program.build_model(config, program.port_config(config))
    weights = program.weights(config, cell.seed, device)
    model.load_state_dict(weights)
    te_idx = np.asarray(raw["testing_idx"])
    test_batch = multimodal_tuple(raw, idx=te_idx, device=device)
    phase_phys = raw["phase"][te_idx] * float(raw["phase_std"]) + float(raw["phase_mean"])
    gt_spectra = raw["flux"][te_idx] * float(raw["flux_std"]) + float(raw["flux_mean"])
    norm = {k: float(raw[k]) for k in ("flux_mean", "flux_std", "photoflux_mean",
                                        "photoflux_std")}

    def one_pass(p):
        seed = core.derive(cell.seed, 8, p)
        with spans.span("bench.suite"):
            recs = mmvae_reconstruction_suite(model, test_batch, K=K, chunk_size=chunk, seed=seed,
                                              norm=norm, device=device)
        with spans.span("bench.metrics"):
            metrics = evaluate_mmvae(model, test_batch, phase_phys, gt_spectra, recs=recs)
        return seed, recs, metrics

    one_pass(0)
    core.synchronize(torch, device)
    prof = cell.profile() if cell.trace else None
    start = time.perf_counter()
    passes = 0
    while True:
        if prof is not None and passes + 1 == traffic["profile_pass"]:
            prof.start()
        last = one_pass(passes + 1)
        passes += 1
        if prof is not None and prof.active:
            prof.stop()
        if time.perf_counter() - start >= cell.seconds:
            break
    end = time.perf_counter()
    n = len(te_idx)
    for span in ("bench.suite", "bench.metrics"):
        took = [b - a for name, a, b in spans.done if name == span and a >= start]
        print(f"benchmark: {len(took)} {span} of {min(took):.4f}-{statistics.median(took):.4f}-"
              f"{max(took):.4f} s", file=sys.stderr)
    metrics = {"eval_events_per_s": passes * n / (end - start), "setup_s": start - cell.t_start}
    device_info = core.device_info(torch, device)
    if prof is not None:
        shape = counts.shape_of(config)
        prof.work = {"flops": counts.mmvae_forward_flops(shape, n, 2 * K), "dtype": dtype,
                     "launches": _launches(shape, prof.counters, -(-n // chunk), chunk, K)}
    model.cpu()
    core.free(torch, device)

    seed, recs, prog_metrics = last
    events = checked_events(cell.seed, n, chunk, traffic["check_events"])
    net = Net(weights, dims_of(config))
    ref = reference.reconstruct(net, test_batch[0], test_batch[1], events, K, chunk, seed, norm)
    t0 = time.perf_counter()
    whole = reference.lc2spec(net, test_batch[0], test_batch[1], K, chunk, seed, norm)
    print(f"benchmark: the reference's LC2spec of the pass took {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    values = {"recon_gap": recon_gap({c: recs[c][:, events] for c in ref}, ref),
              **compare_metrics(prog_metrics, reference.aggregate(whole, gt_spectra, phase_phys),
                                phase_phys)}
    return {"metrics": metrics, "device": device_info, "attempted": passes, "failed": 0,
            "profile": prof, "checks": checks(values, cell.limits)}


def checks(values: dict, limits: dict) -> dict:
    """The numbers the cell's limits name, each beside its limit."""
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}


def compare_metrics(prog: dict, ref: dict, phase: np.ndarray) -> dict:
    """``metrics_gap``: the largest gap of any metric but the coverage, over
    the reference's largest magnitude of that metric; ``coverage_flips``:
    how many (event, bin) coverage indicators differ, as the phase buckets'
    coverage means show them (a flip moves its bucket's mean by one over
    the bucket's events)."""
    cover = [k for k in ref if k.endswith("_coverage_mean")]
    gap = max(_gap(prog[k], v) for k, v in ref.items() if k not in cover)
    counts_ = np.array([(np.round(phase) == p).sum() for p in reference.PHASE_BUCKETS], float)
    flips = 0.0
    for k in cover:
        a, b = np.asarray(prog[k], np.float64), np.asarray(ref[k], np.float64)
        if (np.isnan(a) != np.isnan(b)).any():
            return {"metrics_gap": gap, "coverage_flips": float("inf")}
        flips += float(np.nansum(np.abs(a - b) * counts_.reshape(-1, *[1] * (a.ndim - 1))))
    return {"metrics_gap": gap, "coverage_flips": round(flips, 6)}


def checked_events(seed: int, n: int, chunk: int, count: int):
    """The test events checked: drawn from the seed, with the first event
    of the (padded) last chunk."""
    draw = np.random.default_rng(core.derive(seed, 9))
    tail = (n - 1) // chunk * chunk
    return sorted({tail, *draw.choice(n, size=count - 1, replace=False).tolist()})


def recon_gap(recs: dict, ref: dict) -> float:
    """The largest gap of any cell's reconstructions of an event from the
    reference's, over that event's largest reference magnitude in the cell."""
    gap = 0.0
    for c, r in ref.items():
        scale = np.abs(r).max(axis=(0, 2))
        gap = max(gap, float((np.abs(recs[c] - r).max(axis=(0, 2)) / scale).max()))
    return gap


def controls(cell) -> dict:
    """The control's readings at this seed: the reference at TF32 in the
    program's place, the checked events' reconstructions and the metrics
    over its ``LC2spec`` of every test event, against the fp32 reference."""
    config, traffic, device = cell.config, cell.traffic, cell.device
    from vaesne_tpu_torch.data import multimodal_tuple

    K, chunk = traffic["K"], traffic["chunk"]
    raw = program.data(config, cell.seed)
    weights = program.weights(config, cell.seed, device)
    te_idx = np.asarray(raw["testing_idx"])
    photo, spec = multimodal_tuple(raw, idx=te_idx, device=device)
    norm = {k: float(raw[k]) for k in ("flux_mean", "flux_std", "photoflux_mean",
                                        "photoflux_std")}
    seed = core.derive(cell.seed, 8, 1)
    events = checked_events(cell.seed, len(te_idx), chunk, traffic["check_events"])
    phase = raw["phase"][te_idx] * float(raw["phase_std"]) + float(raw["phase_mean"])
    gt = raw["flux"][te_idx] * float(raw["flux_std"]) + float(raw["flux_mean"])
    recs, metrics = [], []
    for p in ("fp32", "tf32"):
        net = Net(weights, dims_of(config), p)
        recs.append(reference.reconstruct(net, photo, spec, events, K, chunk, seed, norm))
        whole = reference.lc2spec(net, photo, spec, K, chunk, seed, norm)
        metrics.append(reference.aggregate(whole, gt, phase))
    return {"control": {"recon_gap": recon_gap(recs[1], recs[0]),
                        **compare_metrics(metrics[1], metrics[0], phase)}}


def _gap(a, b) -> float:
    """The largest difference of two arrays over the reference's largest
    magnitude; NaN where both are NaN counts as equal."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if (np.isnan(a) != np.isnan(b)).any():
        return float("inf")
    both = np.isnan(b)
    scale = np.abs(np.where(both, 0.0, b)).max(initial=0.0)
    diff = np.abs(np.where(both, 0.0, a - b)).max(initial=0.0)
    return diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))


def _launches(shape, delta, chunks, chunk, K):
    """K1's launches over a pass's chunks by grid, as the dispatch rule
    predicts them, if the launch counters agree."""
    plan = []
    for tower, rows in (("photo_enc", chunk), ("spec_enc", chunk), ("photo_dec", 2 * K * chunk),
                        ("spec_dec", 2 * K * chunk)):
        plan += [(g, False, chunks) for g in counts.kernel_grids(shape, tower, rows)]
    if delta.get("K1") != sum(n for _, _, n in plan):
        return None
    return {"K1": plan}
