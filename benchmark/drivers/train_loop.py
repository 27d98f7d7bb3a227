"""Driver ``train_loop``: the port's training loop as its training drivers
run it, epoch after epoch.

``experiments.common.train_loop`` gets the driver's model, the training
split of the synthetic data (repeated ``repeat_factor`` times where the
configuration has one), the driver's objective and augmentation and the
configuration's training settings with ``train.scan_epoch`` on: each epoch
draws its augmentation, replays the CUDA graph of the step, and every
``save_every`` epochs saves the state into the run's ``TMPDIR``. The
benchmark's weights replace the initial ones (``install_params``).

The first epoch (the warm-up step, the capture) is set-up; the window
runs from its end to the end of the first epoch that ends ``--seconds``
later. ``train_samples_per_s`` counts the samples of every step in the
window over that wall time, augmentation, shuffles and saves included.

Correctness: the window's own training call records, as its first four
steps run, each step's loss; every parameter's gradient as AdamW took it,
worked out from its first moments, at the first step (the warm-up, eager)
and the second (the first replay of the captured graph); and its change
over steps 2–4, the three replays. The reference takes the same four
steps from the same seed, data and weights. The first replay's gradient
is read, not compared: AdamW's first update moves a parameter element
whose gradient is near zero by ±lr on round-off, so the replay's gradient
is taken where the two sides already differ by more than round-off, and
reads as far from the reference as the control does.

Spans: ``bench.augment`` (the epoch's augmentation), ``bench.steps`` (the
epoch's steps), ``bench.save``, ``bench.callback``.
"""

from __future__ import annotations

import math
import shutil
import statistics
import sys
import tempfile
import time

from benchmark import core, counts, program
from benchmark.reference import train as reference

RECORDED_STEPS = 4  # the warm-up step, then three replays
GRAD_STEPS = 2  # the gradients read: the warm-up's (compared) and the first replay's


class _WindowClosed(Exception):
    pass


def run(cell) -> dict:
    torch = cell.torch
    from vaesne_tpu_torch import objectives
    from vaesne_tpu_torch.data import augment_multimodal, multimodal_tuple, repeat_dataset
    from vaesne_tpu_torch.experiments import common
    from vaesne_tpu_torch.ops import _build

    config, traffic, spans, device = cell.config, cell.traffic, cell.spans, cell.device
    dtype = program.precision(config)
    train_seed = core.derive(cell.seed, 1)
    ckpt_dir = tempfile.mkdtemp(prefix="bench-train-")
    cfg = program.port_config(config, seed=train_seed, epochs=10 ** 9, scan_epoch=True,
                              mesh="none", save_every=traffic["save_every"], ckpt_dir=ckpt_dir,
                              log_dir=ckpt_dir)
    if device.type == "cuda":
        _build.build_all()
    raw = program.data(config, cell.seed)
    model = program.build_model(config, cfg)
    weights = program.weights(config, cell.seed, device)
    train_data, _ = common.split_tuples(raw, multimodal_tuple, device)
    repeat = config.get("repeat_factor", 1)
    if repeat > 1:
        train_data = repeat_dataset(train_data, repeat)
    n = train_data[0][0].shape[0]
    forwards = 2 if model.vaes[1].dec.blocks.remat else 1  # remat runs each forward again
    B, K = cfg.train.batch_size, cfg.train.K
    steps_per_epoch = n // B

    rec = {"loss": [], "grads": [], "change": None}
    b1 = cfg.train.b1
    kept = {}  # after step 1: the first moments and the parameters

    def norms(tensors):
        return {name: torch.linalg.vector_norm(t) for name, t in tensors.items()}

    def instrument(epoch_fn):
        step = epoch_fn._step

        def recorded(state, data, leaves, idx):
            loss = step(state, data, leaves, idx)
            rec["loss"].append(loss.clone())
            named = dict(state.model.named_parameters())
            moments = {name: state.optimizer.state[p].get("exp_avg", torch.zeros_like(p))
                       for name, p in named.items()}
            n = len(rec["loss"])
            if n == 1:
                kept["m"] = {k: m.clone() for k, m in moments.items()}
                kept["p"] = {k: p.detach().clone() for k, p in named.items()}
                rec["grads"].append(norms({k: m / (1.0 - b1) for k, m in moments.items()}))
            elif n <= GRAD_STEPS:  # m_n = β1 m_(n−1) + (1 − β1) g_n
                rec["grads"].append(norms({k: (m - b1 * kept["m"][k]) / (1.0 - b1)
                                           for k, m in moments.items()}))
                kept["m"] = {k: m.clone() for k, m in moments.items()}
            if n == RECORDED_STEPS:
                rec["change"] = norms({k: p.detach() - kept["p"][k] for k, p in named.items()})
                del epoch_fn._step  # the class's own step from here on
            return loss

        epoch_fn._step = recorded

    def make_scan_epoch(*args, **kwargs):
        epoch_fn = original["make_scan_epoch"](*args, **kwargs)
        instrument(epoch_fn)
        return epoch_fn

    def save_checkpoint(*args, **kwargs):
        spans.close("bench.steps")
        with spans.span("bench.save"):
            return original["save_checkpoint"](*args, **kwargs)

    def augment(generator, data):
        spans.close("bench.steps")
        with spans.span("bench.augment"):
            out = augment_multimodal(generator, data)
        spans.open("bench.steps")
        return out

    prof = cell.profile() if cell.trace else None
    first, last = traffic["profile_epochs"]
    window = {"start": None, "end": None, "epochs": 0, "bad": 0, "prof_epochs": 0, "ends": []}

    def callback(epoch, state, loss):
        spans.close("bench.steps")
        with spans.span("bench.callback"):
            now = time.perf_counter()
            window["ends"].append(now)
            if window["start"] is None:
                window["start"] = now
            else:
                window["epochs"] += 1
                window["bad"] += not math.isfinite(loss)
            if prof is not None:
                if window["epochs"] == first - 1:
                    prof.start()
                elif window["epochs"] == last and prof.active:
                    prof.stop()
                    window["prof_epochs"] = last - first + 1
            if window["epochs"] and now - window["start"] >= cell.seconds and not (
                    prof is not None and prof.active):
                window["end"] = now
                raise _WindowClosed

    original = {"make_scan_epoch": common.make_scan_epoch,
                "save_checkpoint": common.save_checkpoint}
    common.make_scan_epoch, common.save_checkpoint = make_scan_epoch, save_checkpoint
    loss_fn = objectives.as_loss(objectives.m_iwae, K=K)
    try:
        common.train_loop(model, train_data, loss_fn, cfg.train, config=cfg, augment_fn=augment,
                          ckpt_name=traffic["ckpt_name"], callback=callback, log=False,
                          install_params=weights, device=device)
    except _WindowClosed:
        pass
    finally:
        common.make_scan_epoch = original["make_scan_epoch"]
        common.save_checkpoint = original["save_checkpoint"]
        spans.close("bench.steps")
    if window["end"] is None:
        raise RuntimeError("the training loop ended before the window closed")
    core.synchronize(torch, device)
    elapsed = window["end"] - window["start"]
    epochs = [b - a for a, b in zip(window["ends"], window["ends"][1:])]
    saves = [b - a for n, a, b in spans.done if n == "bench.save"]
    print(f"benchmark: {len(epochs)} epochs of {min(epochs):.4f}-{statistics.median(epochs):.4f}-"
          f"{max(epochs):.4f} s, {len(saves)} saves of {max(saves, default=0):.4f} s at most",
          file=sys.stderr)
    window_steps = window["epochs"] * steps_per_epoch
    metrics = {"train_samples_per_s": window_steps * B / elapsed,
               "setup_s": window["start"] - cell.t_start}
    device_info = core.device_info(torch, device)
    program_rec = {"loss": [float(v) for v in rec["loss"]],
                   "grads": [{k: float(v) for k, v in g.items()} for g in rec["grads"]],
                   "change": {k: float(v) for k, v in rec["change"].items()}}
    model.cpu()
    core.free(torch, device)
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    if prof is not None:
        shape = counts.shape_of(config)
        steps = window["prof_epochs"] * steps_per_epoch
        prof.work = {"flops": steps * counts.train_step_flops(shape, B, K), "dtype": dtype,
                     "launches": _launches(shape, prof.counters, steps, B, K, forwards)}

    ref = reference.record(weights, raw, config, train_seed, RECORDED_STEPS, GRAD_STEPS)
    values = compare(program_rec, ref)
    return {"metrics": metrics, "device": device_info, "attempted": window_steps,
            "failed": window["bad"] * steps_per_epoch, "profile": prof, "readings": values,
            "checks": checks(values, cell.limits)}


def _launches(shape, delta, steps, B, K, forwards):
    """The K1 and K2 launches of ``steps`` steps by grid, as the dispatch
    rule predicts them (``forwards`` of each grid a step), if the launch
    counters agree."""
    grids = (counts.kernel_grids(shape, "photo_enc", B) + counts.kernel_grids(shape, "spec_enc", B)
             + counts.kernel_grids(shape, "photo_dec", 2 * K * B)
             + counts.kernel_grids(shape, "spec_dec", 2 * K * B))
    plan = {"K1": [(g, True, steps * forwards) for g in grids],
            "K2": [(g, None, steps) for g in grids]}
    if delta.get("K1") != steps * forwards * len(grids) or delta.get("K2") != steps * len(grids):
        print(f"benchmark: launches {delta} differ from the {steps} steps' predicted "
              f"{steps * forwards * len(grids)} K1 and {steps * len(grids)} K2", file=sys.stderr)
        return None
    return plan


def compare(prog: dict, ref: dict) -> dict:
    """The readings: the worst step's loss gap over the reference's loss,
    and the first step's (``first_loss_gap``, before any update); at
    each recorded gradient, the gap between the program's and the
    reference's norms of a parameter over the larger of that norm and the
    median one: the median parameter's and the worst (``grad_*`` the first
    step's, ``replay_grad_median_gap`` the first replay's); likewise of the
    change over the replays, leaving out parameters whose reference
    gradient at the first replay is under a thousandth of the median (they
    move by round-off alone)."""
    loss = max(core.relative_gap(a, b) for a, b in zip(prog["loss"], ref["loss"]))
    grads = []
    for mine, theirs in zip(prog["grads"], ref["grads"]):
        median = statistics.median(theirs.values())
        grads.append({k: core.relative_gap(mine[k], g, median) for k, g in theirs.items()})
    last = ref["grads"][-1]
    moved = [k for k, g in last.items() if g >= 1e-3 * statistics.median(last.values())]
    change_median = statistics.median(ref["change"][k] for k in moved)
    changes = {k: core.relative_gap(prog["change"][k], ref["change"][k], change_median)
               for k in moved}
    for what, gaps, mine, theirs in [
            *((f"step {n} gradient", g, prog["grads"][n - 1], ref["grads"][n - 1])
              for n, g in enumerate(grads, 1)),
            ("change", changes, prog["change"], ref["change"])]:
        worst = max(gaps, key=gaps.get)
        print(f"benchmark: the worst {what} is {worst}'s, {mine[worst]!r} against "
              f"{theirs[worst]!r}", file=sys.stderr)
    medians = [statistics.median(g.values()) for g in grads]
    return {"loss_gap": loss, "first_loss_gap": core.relative_gap(prog["loss"][0], ref["loss"][0]),
            "grad_gap": max(grads[0].values()), "grad_median_gap": medians[0],
            "replay_grad_median_gap": medians[1],
            "change_gap": max(changes.values()),
            "change_median_gap": statistics.median(changes.values())}


def checks(values: dict, limits: dict) -> dict:
    """The numbers the cell's limits name, each beside its limit."""
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}


def controls(cell) -> dict:
    """The control's and the planted faults' readings at this seed: the
    reference in the program's place at TF32, and with half of each batch
    (the mean over the rest), each against the reference at fp32; and a
    state left unchanged by the replays, which reads 1 in ``change_gap``
    by construction."""
    config, device = cell.config, cell.device
    raw = program.data(config, cell.seed)
    weights = program.weights(config, cell.seed, device)
    train_seed = core.derive(cell.seed, 1)
    ref = reference.record(weights, raw, config, train_seed, RECORDED_STEPS, GRAD_STEPS)
    out = {}
    for name, kwargs in (("control", {"precision": "tf32"}),
                         ("half_batch", {"fault": reference.HALF_BATCH})):
        other = reference.record(weights, raw, config, train_seed, RECORDED_STEPS, GRAD_STEPS,
                                 **kwargs)
        out[name] = compare(other, ref)
    out["unchanged"] = compare(dict(ref, change={k: 0.0 for k in ref["change"]}), ref)
    return out
