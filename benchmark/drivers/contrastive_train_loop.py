"""Driver ``contrastive_train_loop``: the port's contrastive two-tower
network trained as ``train_contrastive.main`` trains it, epoch after epoch.

``experiments.common.train_loop`` gets ``train_contrastive.build_model``'s
model, the training split of the benchmark's synthetic Goldstein-like
events, the symmetric InfoNCE at the configuration's temperature and
``augment_multimodal``, with ``train.scan_epoch`` on: each epoch draws its
augmentation, replays the CUDA graph of the step, and every ``save_every``
epochs saves the state into the run's ``TMPDIR``. The benchmark's weights
(``core.make_weights`` over the two-tower network's parameters) replace the
initial ones (``install_params``).

The window, the spans (``bench.augment``, ``bench.steps``, ``bench.save``,
``bench.callback``), the readings and the checks are the ``train_loop``
driver's: the first epoch (the warm-up step, the capture) is set-up, the
window runs from its end to the end of the first epoch that ends
``--seconds`` later, and ``train_samples_per_s`` counts the samples of
every step in it over its wall time. The plain reference
(``reference/contrastive_train.py``) takes the same four first steps from
the same seed, data and weights, and follows each way of deciding the ReLU
inputs that fp32 leaves undetermined (``reference.record_branches``); the
readings are against the trajectory nearest the program's (``nearest``).

The cell needs the port's ``ctx attn`` counter (``ops.counters``): the run
holds the context self-attentions of the steps to it, and a port without it
is refused before anything is built. A traced run carries the FLOPs
(``mfu_pct.train``) and the launch plans of K1 and K2
(``k1_roofline_pct.train``, ``k2_roofline_pct.train``).
"""

from __future__ import annotations

import math
import shutil
import statistics
import sys
import tempfile
import time

from benchmark import core, program
from benchmark.counts import contrastive as counts
from benchmark.reference import contrastive_train as reference
from benchmark.reference.contrastive_model import parameter_shapes
from benchmark.reference.train import HALF_BATCH

TRAIN_LOOP = core.load_module(core.BENCH / "drivers" / "train_loop.py")
RECORDED_STEPS, GRAD_STEPS = TRAIN_LOOP.RECORDED_STEPS, TRAIN_LOOP.GRAD_STEPS
compare, checks = TRAIN_LOOP.compare, TRAIN_LOOP.checks


class _WindowClosed(Exception):
    pass


def weights(config: dict, seed: int, device):
    """The run's initial weights, made on the card from the seed."""
    return core.make_weights(parameter_shapes(config), core.derive(seed, 3), device)


def build_model(config: dict, cfg):
    """``train_contrastive.build_model(cfg)``; its parameters must be the
    reference's, name for name and shape for shape."""
    from vaesne_tpu_torch.experiments import train_contrastive

    model = train_contrastive.build_model(cfg)
    have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = parameter_shapes(config)
    if have != want:
        raise ValueError(f"the port's contrastive model and the reference differ: "
                         f"{sorted(set(have) ^ set(want))[:5]} "
                         f"{[k for k in have if k in want and have[k] != want[k]][:5]}")
    return model


def run(cell) -> dict:
    torch = cell.torch
    from vaesne_tpu_torch import objectives
    from vaesne_tpu_torch.data import augment_multimodal, multimodal_tuple
    from vaesne_tpu_torch.experiments import common
    from vaesne_tpu_torch.ops import _build, counters

    if "ctx attn" not in counters.COUNTERS:
        raise RuntimeError("the port has no ctx attn counter (ops.counters), which this cell "
                           "holds the context self-attentions to")
    config, traffic, spans, device = cell.config, cell.traffic, cell.spans, cell.device
    dtype = program.precision(config)
    train_seed = core.derive(cell.seed, 1)
    ckpt_dir = tempfile.mkdtemp(prefix="bench-contrastive-")
    cfg = program.port_config(config, seed=train_seed, epochs=10 ** 9, scan_epoch=True,
                              mesh="none", save_every=traffic["save_every"], ckpt_dir=ckpt_dir,
                              log_dir=ckpt_dir)
    if device.type == "cuda":
        _build.build_all()
    raw = program.data(config, cell.seed)
    model = build_model(config, cfg)
    params = weights(config, cell.seed, device)
    train_data, _ = common.split_tuples(raw, multimodal_tuple, device)
    forwards = 2 if model.spectra_encoder.blocks.remat else 1  # remat runs each forward again
    B = cfg.train.batch_size
    steps_per_epoch = train_data[0][0].shape[0] // B

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
    loss_fn = objectives.as_loss(objectives.neg_info_nce, temperature=cfg.temperature)
    ctx0 = counters.launch_counts()["ctx attn"]
    try:
        common.train_loop(model, train_data, loss_fn, cfg.train, config=cfg, augment_fn=augment,
                          ckpt_name=traffic["ckpt_name"], callback=callback, log=False,
                          install_params=params, device=device)
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
    shape = counts.shape_of(config)
    all_steps = (window["epochs"] + 1) * steps_per_epoch
    ctx = counters.launch_counts()["ctx attn"] - ctx0
    want = all_steps * forwards * len(counts.context_attentions(shape, B))
    print(f"benchmark: ctx attn {ctx} over {all_steps} steps (predicted {want})", file=sys.stderr)
    if ctx != want:
        raise RuntimeError(f"the context self-attention ran {ctx} times where {want} were "
                           f"predicted")
    window_steps = window["epochs"] * steps_per_epoch
    metrics = {"train_samples_per_s": window_steps * B / elapsed,
               "setup_s": window["start"] - cell.t_start}
    device_info = core.device_info(torch, device)
    program_rec = {"loss": [float(v) for v in rec["loss"]],
                   "grads": [{k: float(v) for k, v in g.items()} for g in rec["grads"]],
                   "change": {k: float(v) for k, v in rec["change"].items()}}
    model.cpu()
    del train_data
    core.free(torch, device)
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    if prof is not None:
        steps = window["prof_epochs"] * steps_per_epoch
        prof.work = {"flops": steps * counts.train_step_flops(shape, B), "dtype": dtype,
                     "launches": _launches(shape, prof.counters, steps, B, forwards)}

    refs = reference.record_branches(params, raw, config, train_seed, RECORDED_STEPS,
                                     GRAD_STEPS)
    values = nearest(program_rec, refs, cell.limits)
    return {"metrics": metrics, "device": device_info, "attempted": window_steps,
            "failed": window["bad"] * steps_per_epoch, "profile": prof, "readings": values,
            "checks": checks(values, cell.limits)}


def nearest(prog: dict, refs: list, limits: dict) -> dict:
    """``compare``'s readings against the reference's trajectory that
    stands nearest the program's: the one whose largest reading over its
    limit is least."""
    scored = []
    for ref in refs:
        values = compare(prog, ref)
        scored.append((max(values[k] / limits[k] for k in limits), len(scored), values))
    _, at, values = min(scored)
    if len(refs) > 1:
        print(f"benchmark: {len(refs)} reference trajectories over the undetermined ReLU inputs; "
              f"the nearest flips {refs[at]['flips']}", file=sys.stderr)
    return values


def _launches(shape, delta, steps, B, forwards):
    """The K1 and K2 launches of ``steps`` steps by grid, as the dispatch
    rule predicts them (``forwards`` of each grid a step), if the launch
    counters agree."""
    grids = counts.kernel_grids(shape, "photo", B) + counts.kernel_grids(shape, "spec", B)
    plan = {"K1": [(g, True, steps * forwards) for g in grids],
            "K2": [(g, None, steps) for g in grids]}
    if delta.get("K1") != steps * forwards * len(grids) or delta.get("K2") != steps * len(grids):
        print(f"benchmark: launches {delta} differ from the {steps} steps' predicted "
              f"{steps * forwards * len(grids)} K1 and {steps * len(grids)} K2", file=sys.stderr)
        return None
    return plan


def controls(cell) -> dict:
    """The control's and the planted faults' readings at this seed: the
    reference in the program's place at TF32, and with InfoNCE over half of
    each batch, each against the nearest of the reference's trajectories at
    fp32; and a state left unchanged by the replays, which reads 1 in
    ``change_gap`` by construction."""
    config, device = cell.config, cell.device
    raw = program.data(config, cell.seed)
    params = weights(config, cell.seed, device)
    train_seed = core.derive(cell.seed, 1)
    refs = reference.record_branches(params, raw, config, train_seed, RECORDED_STEPS,
                                     GRAD_STEPS)
    out = {}
    for name, kwargs in (("control", {"precision": "tf32"}),
                         ("half_batch", {"fault": HALF_BATCH})):
        other = reference.record(params, raw, config, train_seed, RECORDED_STEPS, GRAD_STEPS,
                                 **kwargs)
        out[name] = nearest(other, refs, cell.limits)
    ref = refs[0]
    out["unchanged"] = compare(dict(ref, change={k: 0.0 for k in ref["change"]}), ref)
    return out
