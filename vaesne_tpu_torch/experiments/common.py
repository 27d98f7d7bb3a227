"""The machinery every training driver of the port shares.

The counterpart of ``vaesne_tpu/experiments/common.py``: the dataset is
resolved once (a real npz, validated at load, or the synthetic generator)
and placed on the device, augmentation is drawn there once per epoch, the
epoch runs through ``training.make_scan_epoch``, and checkpoints hold the
whole ``TrainState``. Each ``train_*.py`` is then a config and a model.

Seeds. Everything random in a run derives from ``train.seed`` through
``utils.rng.fold_in``: the initial weights, the per-step seeds (the state's
CPU generator, whose state a checkpoint carries) and, for epoch e, the
augmentation and shuffle seeds as a pure function of (seed, e). A resumed
run therefore needs no key chain fast-forwarded: training to epoch N,
stopping, and resuming gives the run that never stopped.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ..data import (
    load_npz,
    make_goldstein_like,
    make_ztf_like,
    multimodal_tuple,
    photometry_tuple,
    spectra_tuple,
)
from ..data.validate import validate_npz
from ..parallel import current_mesh, gather_state_tp, launch, resolve_mesh, shard_state_tp
from ..parallel.mesh import rank, rank_device, to_host, torchrun_world
from ..training import (
    TrainState,
    _leaves,
    adamw,
    make_scan_epoch,
    resolve_device,
    to_device,
)
from ..utils.checkpoint import (
    check_format,
    has_state,
    load_config,
    restore_checkpoint,
    save_checkpoint,
)
from ..utils.config import asdict
from ..utils.plotting import plot_loss_curve
from ..utils.profiling import span
from ..utils.rng import device_generator, fold_in
from ..utils.weights import init_params


def resolve_dataset(path: Optional[str], kind: str = "goldstein", n_synthetic: int = 512,
                    seed: int = 0):
    """The npz at ``path`` (validated against the data contract at load),
    or without a path the synthetic data of ``kind`` with the same keys.
    ``VAESNE_SKIP_VALIDATE=1`` loads a file that fails the contract."""
    if path:
        data = load_npz(path)
        if os.environ.get("VAESNE_SKIP_VALIDATE", "0") in ("0", ""):
            problems = validate_npz(data, kind=kind)
            if problems:
                raise ValueError(
                    f"{path} does not satisfy the {kind} npz contract:\n  - "
                    + "\n  - ".join(problems)
                    + "\nFix the file or set VAESNE_SKIP_VALIDATE=1 to bypass validation.")
        return data
    maker = make_goldstein_like if kind == "goldstein" else make_ztf_like
    return maker(n=n_synthetic, seed=seed)


def split_tuples(data, builder: Callable, device=None):
    """(train tuple, test tuple) on ``device``, by the npz's stored indices."""
    return (builder(data, idx=np.asarray(data["training_idx"]), device=device),
            builder(data, idx=np.asarray(data["testing_idx"]), device=device))


TUPLE_BUILDERS = {
    "photometry": photometry_tuple,
    "spectra": spectra_tuple,
    "multimodal": multimodal_tuple,
}


def optimizer_from_config(train_cfg):
    """AdamW as ``train_loop`` builds it for this config: ``parity`` or
    ``grad_clip <= 0`` means no clip."""
    grad_clip = train_cfg.grad_clip
    if train_cfg.parity or grad_clip <= 0:
        grad_clip = None
    return adamw(train_cfg.lr, weight_decay=train_cfg.weight_decay, b1=train_cfg.b1,
                 b2=train_cfg.b2, grad_clip=grad_clip)


def _given(mask, model):
    return mask


def _picklable(**objects) -> None:
    """Raise, naming it, where an object a spawned rank needs does not
    pickle (a lambda or a function defined inside another)."""
    import pickle

    for name, obj in objects.items():
        try:
            pickle.dumps(obj)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise ValueError(
                f"{name} must pickle to run on spawned ranks (a module-level function or a "
                f"functools.partial of one), or run the driver under torchrun: {e}") from e


def _train_rank(model, train_data, loss_fn, train_cfg, kwargs):
    """One spawned rank of ``train_loop``: train, then hand back the whole
    state (gathered over a tensor-parallel model group) on the CPU."""
    state, losses = train_loop(model, train_data, loss_fn, train_cfg, **kwargs)
    return to_host(gather_state_tp(state, current_mesh())), losses


def _eval_rank(run: Callable, argv, device):
    mesh = current_mesh()
    return run(argv, rank_device(mesh), mesh)


def run_evaluation(run: Callable, argv, device, mesh_spec, chunk_size: int):
    """``run(argv, device, mesh)`` (an evaluation driver's body, a
    module-level function) on one process, or on every rank of the mesh
    ``mesh_spec`` resolves to for chunks of ``chunk_size`` events (the JAX
    drivers' ``resolve_mesh(spec, batch_size=chunk)``); rank 0's result.
    The chunk must shard evenly over the data axis."""
    device = resolve_device(device)
    mesh = resolve_mesh(mesh_spec, batch_size=chunk_size, device=device)
    if mesh is not None and chunk_size % mesh.data:
        raise ValueError(f"batch dim {chunk_size} not divisible by data axis {mesh.data}")
    if mesh is None or current_mesh() == mesh:
        return run(argv, device if mesh is None else rank_device(mesh), mesh)
    return launch(_eval_rank, mesh, run, argv, device)


def _epoch_seeds(seed: int, epoch: int):
    """(augmentation seed, shuffle seed) of ``epoch``."""
    e = fold_in(fold_in(seed, 2), epoch)
    return fold_in(e, 0), fold_in(e, 1)


def _resume_epoch(ckpt_path: str, state: TrainState, n: int, batch_size: int,
                  log: bool) -> int:
    """The epoch a restored run continues from: the checkpoint's step
    counter where it is epoch-aligned under this data and batch geometry,
    checked against progress.json, which may lag the state by one save but
    is never ahead of it."""
    steps_per_epoch = max(1, n // batch_size)
    recorded = None
    progress_file = os.path.join(ckpt_path, "progress.json")
    if os.path.exists(progress_file):
        try:
            with open(progress_file) as f:
                recorded = int(json.load(f)["epochs_done"])
        except (ValueError, KeyError, OSError):
            recorded = None  # truncated or corrupt: the step counter decides
    step = state.step
    start = step // steps_per_epoch
    if step % steps_per_epoch == 0:
        if recorded is not None and recorded > start:
            raise ValueError(
                f"resume geometry mismatch at {ckpt_path}: the checkpoint records "
                f"{recorded} completed epochs at step {step}, but the current data/batch "
                f"settings give {steps_per_epoch} steps/epoch (which implies only {start} "
                f"epochs). The dataset size, repeat factor, or batch size changed since "
                f"the original run.")
        if recorded is not None and recorded != start and log:
            print(f"progress.json records {recorded} epochs but the checkpoint step {step} "
                  f"implies {start}; using the checkpoint (stale progress record)")
    elif recorded is not None:
        raise ValueError(
            f"resume geometry mismatch at {ckpt_path}: the checkpoint records {recorded} "
            f"completed epochs at step {step}, but the current data/batch settings give "
            f"{steps_per_epoch} steps/epoch (expected step {recorded * steps_per_epoch}). "
            f"The dataset size, repeat factor, or batch size changed since the original run.")
    return start


def train_loop(model, train_data, loss_fn, train_cfg, *, config: Any = None,
               augment_fn: Optional[Callable] = None, init_K: Optional[int] = None,
               ckpt_name: str = "model", callback: Optional[Callable] = None,
               log: bool = True, install_params: Optional[Mapping[str, Any]] = None,
               opt_mask: Optional[Callable] = None, device=None):
    """Train ``model`` on ``train_data`` (a nested tuple of tensors on the
    device); returns (state, per-epoch losses).

    ``loss_fn(model, batch, seed)`` is the objective (maximised).
    ``augment_fn(generator, data) -> data`` runs on the device once per
    epoch, with a generator there seeded for that epoch; ``train.parity``
    draws it once before training instead (the reference's dynamics, with
    no gradient clip). The weights start from ``init_params`` under the
    run's seed; ``install_params`` (parameter names to tensors) then
    overwrites some or all of them. ``opt_mask(model)`` gives every
    parameter name → trainable (the JAX package wraps the optimizer in
    ``optax.masked``): the parameters it marks False are frozen, outside the
    optimizer and the gradient clip (``TrainState.create``), and the
    checkpoint holds them beside AdamW moments for the rest alone.
    ``init_K`` has no effect here: the
    port's parameters do not depend on K (the JAX package initialises by
    running the model with it). ``train.scan_epoch`` (default true) runs
    each epoch as one CUDA graph of the step on the card, replayed at every
    step after a warm-up step and kept across epochs (the capture-ready step
    eagerly on the CPU); false runs the step loop, the same run bitwise.
    Under a data-parallel ``train.mesh`` each rank's step is two graphs,
    the gradients and the update, around the eager gradient all-reduce
    (InfoNCE's step also splits at its gather, whose all-reduces run
    between graphs), and the step loop runs the same stages eagerly; where
    a collective runs inside a graph's part of the step (a tensor-parallel
    mesh) the step loop runs from the second step on, and a line says
    which collective kept it. Augmentation, the save,
    ``callback`` and the progress record stay outside the graph, and a
    save between epochs reads the live weights.

    Every ``train.save_every`` epochs and at the last epoch the state, the
    config (tagged with its class), ``losses.npy`` and ``progress.json`` go
    to ``{ckpt_dir}/{ckpt_name}``; ``train.resume`` continues from there.
    ``callback(epoch, state, loss)`` runs after each epoch. The run is on
    ``device``, by default the card. As in the JAX package, the environment
    sets what the steps compute: ``VAESNE_BF16`` trains under bf16 autocast
    over fp32 parameters and moments (``make_scan_epoch``), ``VAESNE_REMAT=0``
    turns the blocks' rematerialisation off (``TransformerStack``, read
    when the model is built) and ``VAESNE_DROPOUT_BITS`` sets the width of
    the kernels' dropout draws (``ops.attention.dropout_bits``).
    While a profiler runs, the epoch's augmentation is the span
    ``train.augment`` and a save, from the gather through the loss plot,
    ``train.save`` (``utils.profiling.span``).

    ``train.mesh`` (``parallel.resolve_mesh``) spreads the run over ranks:
    "N" is data parallelism over N ranks, "DxM" adds Megatron tensor
    parallelism over M. Every rank trains on its slice of each batch, rank
    0 alone writes the checkpoint, logs and runs ``callback``, and the
    returned state is rank 0's, whole. The other ranks wait for rank 0's
    checkpoint and ``callback`` at the next step's all-reduce, for as long
    as the group's timeout allows (``parallel.mesh.GROUP_TIMEOUT``, by
    default torch's: 30 min for gloo). Outside a rank the ranks are
    spawned (``parallel.launch``; ``loss_fn``, ``augment_fn`` and
    ``callback`` must then pickle) and their result is loaded into
    ``model``; under ``torchrun`` every process trains its own rank in
    place and returns its own state.
    """
    device = resolve_device(device)
    mesh = resolve_mesh(train_cfg.mesh, batch_size=train_cfg.batch_size, device=device)
    if mesh is not None and train_cfg.batch_size % mesh.data != 0:
        raise ValueError(
            f"batch_size {train_cfg.batch_size} not divisible by the mesh data axis "
            f"({mesh.data}); every step's batch must shard evenly (set train.batch_size or "
            f"train.mesh accordingly)")
    if mesh is not None and current_mesh() != mesh:
        kwargs = dict(config=config, augment_fn=augment_fn, ckpt_name=ckpt_name,
                      callback=callback, log=log, install_params=install_params,
                      opt_mask=opt_mask, device=device)
        if torchrun_world() > 1:  # this process is a rank already: it trains in place
            return launch(functools.partial(train_loop, **kwargs), mesh, model, train_data,
                          loss_fn, train_cfg)
        _picklable(loss_fn=loss_fn, augment_fn=augment_fn, callback=callback)
        trainable = None if opt_mask is None else opt_mask(model)
        if trainable is not None:
            kwargs["opt_mask"] = functools.partial(_given, trainable)
        full, losses = launch(_train_rank, mesh, model, to_host(train_data), loss_fn, train_cfg,
                              kwargs)
        state = TrainState.create(model, optimizer_from_config(train_cfg), device=device,
                                  trainable=trainable)
        state.load_state_dict(full)
        return state, losses
    lead = mesh is None or rank() == 0  # writes the checkpoint and logs
    log = log and lead
    if mesh is not None:
        device = rank_device(mesh)
        train_data = to_device(train_data, device)
    seed = train_cfg.seed
    init_params(model, torch.Generator().manual_seed(fold_in(seed, 0)))
    if install_params:
        unknown = model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in install_params.items()}, strict=False
        ).unexpected_keys
        if unknown:
            raise KeyError(f"install_params names no parameter of the model: {unknown}")
    opt = optimizer_from_config(train_cfg)
    state = TrainState.create(model, opt, seed=fold_in(seed, 1), device=device,
                              trainable=None if opt_mask is None else opt_mask(model))
    losses = []
    start_epoch = 0
    ckpt_path = os.path.join(train_cfg.ckpt_dir, ckpt_name)
    check_format(ckpt_path)
    cfg_dict = None
    if config is not None:
        cfg_dict = asdict(config)
        # restore_config and InferenceServer.from_checkpoint dispatch on it
        cfg_dict["_config_class"] = type(config).__name__
    if train_cfg.resume:
        if has_state(ckpt_path):
            saved_bs = ((load_config(ckpt_path) or {}).get("train", {})
                        .get("batch_size"))
            if saved_bs is not None and saved_bs != train_cfg.batch_size:
                raise ValueError(
                    f"resume geometry mismatch at {ckpt_path}: checkpoint was trained "
                    f"with batch_size={saved_bs}, current run uses "
                    f"{train_cfg.batch_size}. Restart with the original batch_size or "
                    f"train fresh under a new ckpt name.")
            state = restore_checkpoint(ckpt_path, state)
            n = _leaves(train_data)[0].shape[0]
            start_epoch = _resume_epoch(ckpt_path, state, n, train_cfg.batch_size, log)
            losses_file = os.path.join(ckpt_path, "losses.npy")
            if os.path.exists(losses_file):
                losses = [float(v) for v in np.load(losses_file)][:start_epoch]
            if log:
                print(f"resumed from {ckpt_path} at epoch {start_epoch}")
        elif log:
            print(f"resume requested but no checkpoint at {ckpt_path}; starting fresh")
    if mesh is not None:  # after any restore, as in the JAX package
        if mesh.model > 1:
            shard_state_tp(state, mesh)  # checks every attention's head count
        if log:
            print(f"training on {mesh.size} ranks (mesh {mesh.shape}, {mesh.backend})")
    epoch_fn = make_scan_epoch(model, opt, loss_fn, train_cfg.accum_steps,
                               train_cfg.accum_reduction, device, mesh=mesh,
                               graph=train_cfg.scan_epoch)
    if train_cfg.parity and augment_fn is not None:
        train_data = augment_fn(device_generator(fold_in(seed, 3), device), train_data)
        augment_fn = None
    plot_warned = False
    for epoch in range(start_epoch, train_cfg.epochs):
        aug_seed, shuffle_seed = _epoch_seeds(seed, epoch)
        epoch_data = train_data
        if augment_fn is not None:
            with span("train.augment", epoch=epoch):
                epoch_data = augment_fn(device_generator(aug_seed, device), train_data)
        state, mean_loss = epoch_fn(state, epoch_data,
                                    torch.Generator().manual_seed(shuffle_seed),
                                    train_cfg.batch_size)
        losses.append(mean_loss)
        reason = getattr(epoch_fn, "step_loop_reason", None)
        if reason and log and epoch == start_epoch:
            print(f"train.scan_epoch: the step loop runs under this mesh from the second step "
                  f"on: the step runs {reason} inside its forward and backward, where no CUDA "
                  f"graph of the step holds a collective")
        if log:
            print(f"epoch {epoch + 1}/{train_cfg.epochs}: loss {losses[-1]:.6f}")
        if (epoch + 1) % train_cfg.save_every == 0 or epoch + 1 == train_cfg.epochs:
            with span("train.save", epoch=epoch):
                # every rank of a tensor-parallel group gathers; rank 0 writes
                whole = gather_state_tp(state, mesh)
                if lead:
                    save_checkpoint(ckpt_path, whole, cfg_dict)
                    np.save(os.path.join(ckpt_path, "losses.npy"),
                            np.asarray(losses, np.float64))
                    # atomic: a kill mid-write must not leave truncated JSON
                    progress_tmp = os.path.join(ckpt_path, "progress.json.tmp")
                    with open(progress_tmp, "w") as f:
                        json.dump({"epochs_done": epoch + 1}, f)
                    os.replace(progress_tmp, os.path.join(ckpt_path, "progress.json"))
                    os.makedirs(train_cfg.log_dir, exist_ok=True)
                    try:
                        plot_loss_curve(losses, path=os.path.join(train_cfg.log_dir,
                                                                  f"{ckpt_name}_loss.png"))
                    except ImportError:
                        if not plot_warned:
                            print("matplotlib is not installed: no loss-curve PNG is written "
                                  "(losses.npy holds every epoch's loss)")
                            plot_warned = True
        if callback is not None and lead:
            callback(epoch, state, losses[-1])
    return state, losses


def parse_cli(argv, default_data=None):
    """Split ``data=/path.npz`` off the override list: (path, the rest)."""
    data_path, rest = default_data, []
    for a in argv:
        if a.startswith("data="):
            data_path = a.split("=", 1)[1]
        else:
            rest.append(a)
    return data_path, rest
