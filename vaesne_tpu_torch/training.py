"""Training loop of the port: the train step, gradient accumulation and an
epoch loop.

Counterparts of ``vaesne_tpu/training.py``: ``adamw`` (AdamW with torch's
weight decay 1e-2 and a global-norm clip, as the JAX package chains
``optax.clip_by_global_norm`` before ``optax.adamw``), ``TrainState``,
``make_train_step``, ``accumulate_gradients``, ``epoch_batches``,
``train_epoch``, ``make_scan_epoch`` and ``fit``. Objectives are maximised,
so the step minimises ``-loss_fn`` and reports that, as the JAX package
does.

A loss function is ``loss_fn(model, batch, seed) -> objective``, the
counterpart of the JAX ``loss_fn(model, variables, batch, key)``: the model
holds its parameters, and ``seed`` is an integer drawn per step from the
state's CPU generator (``utils.rng``). The entry points run on ``"cuda"``
unless the caller passes ``device="cpu"``, and raise when no card is
present. The step runs eagerly: a CUDA graph of the step is later work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .nn.layers import autocast, cudnn_fp32_deterministic, resolve_precision
from .ops import partition
from .utils.rng import draw_seed, fold_in

LossFn = Callable[[nn.Module, Any, int], torch.Tensor]


def safelog10(x: float) -> float:
    """log10 clamped at 1e-10 (the reference's training utility; unused
    there, kept for its API)."""
    return math.log10(max(1e-10, x))


def resolve_device(device=None) -> torch.device:
    """``device`` or, by default, the CUDA card; raises rather than run on
    the CPU when no card is present and the CPU was not asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW with a global-norm gradient clip ahead of the update (the
    counterpart of the JAX ``adamw`` chain). ``init`` builds the torch
    optimizer for a model's parameters."""

    lr: float
    weight_decay: float = 1e-2
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: Optional[float] = 10.0

    def init(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(params, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps,
                                 weight_decay=self.weight_decay)


def adamw(lr: float, weight_decay: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, grad_clip: Optional[float] = 10.0) -> AdamW:
    """AdamW with torch defaults and global-norm clipping at ``grad_clip``
    (None: no clip)."""
    return AdamW(lr, weight_decay, b1, b2, eps, grad_clip)


def _sum_of_squares(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(list(grads))).square().sum()


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm/‖g‖ when the global norm ‖g‖ is
    at least ``max_norm``, exactly as ``optax.clip_by_global_norm`` does
    (``clip_grad_norm_`` adds 1e-6 to the norm). ``norm`` is ‖g‖ where the
    caller has it (over a tensor-parallel model's whole gradient). Returns
    ‖g‖; no host sync."""
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(grads), factor)
    return norm


@dataclasses.dataclass
class TrainState:
    """Everything a step mutates: the model (its parameters), the torch
    optimizer, the step count and the CPU generator that seeds each step."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator

    @classmethod
    def create(cls, model: nn.Module, optimizer: AdamW, seed: int = 0,
               device=None, trainable: Optional[Mapping[str, bool]] = None) -> "TrainState":
        """Move ``model`` to ``device`` (default: the card), put it in train
        mode and build its optimizer. ``trainable`` (every parameter name →
        bool, the JAX package's ``optax.masked`` mask) freezes the
        parameters it marks False: they stay out of the optimizer, so they
        get no Adam update, no weight decay and no place in the clip's
        norm, and they take no gradient."""
        model = model.to(resolve_device(device)).train()
        params = dict(model.named_parameters())
        if trainable is not None:
            if set(trainable) != set(params):
                raise KeyError(
                    f"the trainable mask must name every parameter of the model: it lacks "
                    f"{sorted(set(params) - set(trainable))[:3]} and names no parameter "
                    f"{sorted(set(trainable) - set(params))[:3]}")
            params = {n: p for n, p in params.items() if trainable[n]}
            if not params:
                raise ValueError("the trainable mask freezes every parameter")
        for name, p in model.named_parameters():
            p.requires_grad_(name in params)
        return cls(model, optimizer.init(params.values()), 0,
                   torch.Generator().manual_seed(seed))

    def trainable_parameters(self) -> List[nn.Parameter]:
        """The parameters the optimizer updates, in its order."""
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def state_dict(self) -> dict:
        """The model's parameters, the AdamW moments, the step and the
        generator's state: everything a resumed run continues from. The
        tensors are the live ones; ``torch.save`` copies them."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()`` output. The optimizer keeps its own
        hyperparameters (learning rate, betas, weight decay), as the JAX
        package's optimizer state holds none: a resumed run trains with the
        configuration it is given."""
        self.model.load_state_dict(state["model"])
        hyper = [{k: v for k, v in g.items() if k != "params"}
                 for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(state["optimizer"])
        for group, h in zip(self.optimizer.param_groups, hyper):
            group.update(h)
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _leaves(tree) -> List[Any]:
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def to_device(batch, device: torch.device):
    """A nested tuple of numpy arrays or tensors on ``device`` (numpy int32
    band indices become int64, the embedding's index type)."""
    def move(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
        return a.to(device, non_blocking=True)
    return _tree_map(move, batch)


def accumulate_gradients(neg_loss_fn: Callable[[nn.Module, Any, int], torch.Tensor],
                         model: nn.Module, batch, seed: int, accum_steps: int,
                         reduction: str = "mean", no_sync=None) -> torch.Tensor:
    """Microbatched value-and-grad: the batch axis is cut into
    ``accum_steps`` equal microbatches, each backward adds into the
    parameters' ``.grad``, so peak activation memory is one microbatch's.
    ``reduction`` must match the objective's batch reduction: ``"mean"``
    averages the microbatch losses and gradients, ``"sum"`` (``m_iwae``)
    sums them. Microbatch i takes ``fold_in(seed, i)``. ``no_sync`` (DDP's)
    holds the gradient all-reduce back until the last microbatch. Returns
    the loss."""
    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction must be 'mean' or 'sum', got {reduction!r}")
    n = _leaves(batch)[0].shape[0]
    if n % accum_steps != 0:
        raise ValueError(f"batch size {n} not divisible by accum_steps {accum_steps}")
    size = n // accum_steps
    total = None
    for i in range(accum_steps):
        micro = _tree_map(lambda a: a[i * size:(i + 1) * size], batch)
        hold = no_sync is not None and i < accum_steps - 1
        with no_sync() if hold else contextlib.nullcontext():
            loss = neg_loss_fn(model, micro, fold_in(seed, i))
            loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    if reduction == "mean":
        inv = 1.0 / accum_steps
        torch._foreach_mul_([p.grad for p in model.parameters() if p.grad is not None], inv)
        total = total * inv
    return total


class _Objective(nn.Module):
    """The step's loss as a module, so that DDP wraps the whole objective
    and ``loss_fn`` still gets the model itself."""

    def __init__(self, model: nn.Module, neg_loss):
        super().__init__()
        self.model = model
        self.neg_loss = neg_loss

    def forward(self, batch, seed):
        return self.neg_loss(self.model, batch, seed)


def _allreduce_sum(group, bucket):
    """DDP comm hook: sum the bucket over the group (the default averages)."""
    import torch.distributed as dist

    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def _ddp(model: nn.Module, neg_loss, shard, reduction: str):
    """DDP over the data group around the objective: the gradients are
    averaged (a batch-mean objective) or summed (a batch-sum one) over the
    ranks in the backward. Frozen parameters stay out of its buckets; every
    trainable parameter must take a gradient in every step."""
    from torch.nn.parallel import DistributedDataParallel

    ddp = DistributedDataParallel(_Objective(model, neg_loss), process_group=shard.data_group)
    if reduction == "sum":
        ddp.register_comm_hook(shard.data_group, _allreduce_sum)
    return ddp


def _global_norm(state: "TrainState", grads, shard) -> Optional[torch.Tensor]:
    """‖g‖ of a tensor-parallel model's whole gradient: the split
    parameters' squares summed over the model group, the replicated ones
    counted once. None where nothing is split."""
    specs = getattr(state.model, "tp_specs", None)
    if not specs or shard is None:
        return None
    import torch.distributed as dist

    split = {id(p) for n, p in state.model.named_parameters() if n in specs}
    parts = [[g for p, g in grads if (id(p) in split) == s] for s in (True, False)]
    sq = [_sum_of_squares(g) if g else torch.zeros((), device=grads[0][1].device)
          for g in parts]
    dist.all_reduce(sq[0], group=shard.model_group)
    return torch.sqrt(sq[0] + sq[1])


def make_train_step(model: nn.Module, optimizer: AdamW, loss_fn: LossFn,
                    accum_steps: int = 1, accum_reduction: str = "mean", device=None,
                    precision: Optional[str] = None, mesh=None):
    """The train step ``step(state, batch) -> (state, loss)``: gradients of
    ``-loss_fn`` (accumulated over ``accum_steps`` microbatches when > 1),
    the global-norm clip, then the AdamW update. ``batch`` is moved to
    ``device`` (default: the card). ``precision="bf16"`` runs the forward
    under bf16 autocast over the fp32 weights, whose AdamW moments stay fp32
    (the JAX package's ``VAESNE_BF16``); None takes ``VAESNE_BF16`` as it
    stands when the step is built (``nn.layers.resolve_precision``). The
    loss stays on the device.

    ``mesh`` (a ``parallel`` mesh this process is a rank of): the step
    takes the global batch and runs this rank's slice of it under DDP over
    the data group; ``accum_reduction`` names the objective's batch
    reduction, so the gradients and the returned loss are the global
    batch's (summed for ``"sum"``, averaged for ``"mean"``). The clip's
    norm is taken after the gradient all-reduce, over the whole gradient
    of a tensor-parallel model."""
    device = resolve_device(device)
    precision = resolve_precision(precision)
    shard = None
    if mesh is not None:
        from .parallel.mesh import shard_batch, shard_of

        shard = shard_of(mesh)
    wrapped = []  # the DDP module, built at the first step on every rank

    def neg_loss(m, b, seed):
        with autocast(precision, device):
            return -loss_fn(m, b, seed)

    def objective():
        """(loss of a global (micro)batch, DDP's no_sync): under a mesh the
        rank runs its slice of each microbatch under DDP."""
        if shard is None:
            return neg_loss, None
        if not wrapped:
            wrapped.append(_ddp(model, neg_loss, shard, accum_reduction))
        ddp = wrapped[0]
        return (lambda m, b, seed: ddp(shard_batch(b, mesh), seed)), ddp.no_sync

    def step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state holds another model than this step")
        seed = draw_seed(state.generator)
        batch = to_device(batch, device)
        state.optimizer.zero_grad(set_to_none=True)
        fn, no_sync = objective()
        # the convolutions' backward reads the cuDNN flags, remat's re-runs
        # in the backward the shard
        with cudnn_fp32_deterministic(), partition.sharded(shard):
            if accum_steps == 1:
                loss = fn(model, batch, seed)
                loss.backward()
                loss = loss.detach()
            else:
                loss = accumulate_gradients(fn, model, batch, seed, accum_steps,
                                            accum_reduction, no_sync)
        if shard is not None:
            import torch.distributed as dist

            dist.all_reduce(loss, group=shard.data_group)
            if accum_reduction == "mean":
                loss = loss / shard.n_data
        if optimizer.grad_clip is not None:  # over the trainable parameters alone
            grads = [(p, p.grad) for p in state.trainable_parameters() if p.grad is not None]
            clip_by_global_norm([g for _, g in grads], optimizer.grad_clip,
                                _global_norm(state, grads, shard))
        state.optimizer.step()
        state.step += 1
        return state, loss

    return step


def epoch_batches(generator: torch.Generator, data, batch_size: int,
                  shuffle: bool = True) -> Iterator[Any]:
    """Minibatches of ``data`` (a nested tuple of arrays or tensors with one
    leading sample axis) in an order drawn from ``generator``; the trailing
    remainder is dropped so every step has one shape. The order goes to the
    data's device once per epoch, and each step gathers its batch there."""
    n = _leaves(data)[0].shape[0]
    steps = n // batch_size
    if steps == 0:
        raise ValueError(f"batch_size {batch_size} exceeds dataset size {n}")
    perm = torch.randperm(n, generator=generator) if shuffle else torch.arange(n)
    perm = perm[:steps * batch_size].view(steps, batch_size)
    placed = {}

    def order(a):
        where = "numpy" if isinstance(a, np.ndarray) else a.device
        if where not in placed:
            placed[where] = perm.numpy() if where == "numpy" else perm.to(where)
        return placed[where]

    for i in range(steps):
        yield _tree_map(lambda a: a[order(a)[i]], data)


def train_epoch(state: TrainState, step_fn, data, batch_size: int,
                generator: torch.Generator) -> Tuple[TrainState, float]:
    """One epoch over ``data``; returns (state, mean loss). The step losses
    stay on the device until the one sync at the end of the epoch."""
    losses = []
    for batch in epoch_batches(generator, data, batch_size):
        state, loss = step_fn(state, batch)
        losses.append(loss)
    if not losses:
        return state, 0.0
    return state, float(torch.stack(losses).mean())


def make_scan_epoch(model: nn.Module, optimizer: AdamW, loss_fn: LossFn,
                    accum_steps: int = 1, accum_reduction: str = "mean", device=None,
                    mesh=None, precision: Optional[str] = None):
    """The whole-epoch train function ``run(state, data, generator,
    batch_size) -> (state, mean loss)``, the counterpart of the JAX
    package's ``make_scan_epoch``: ``train_epoch`` over ``make_train_step``
    at ``precision`` (None: ``VAESNE_BF16`` when the function is built).
    The steps run eagerly and the host syncs once, for the mean loss; a
    CUDA graph of the step is later work. Under ``mesh`` every rank draws
    the same permutation and each step runs the rank's slice of the batch
    (``make_train_step``)."""
    step = make_train_step(model, optimizer, loss_fn, accum_steps, accum_reduction, device,
                           precision, mesh)

    def run(state: TrainState, data, generator: torch.Generator,
            batch_size: int) -> Tuple[TrainState, float]:
        return train_epoch(state, step, data, batch_size, generator)

    return run


def fit(state: TrainState, step_fn, data, batch_size: int, epochs: int,
        generator: torch.Generator,
        callback: Optional[Callable[[int, TrainState, float], None]] = None):
    """``epochs`` epochs, each shuffled from ``generator``, with an optional
    per-epoch ``callback(epoch, state, loss)``. Returns (state, losses)."""
    losses = []
    for epoch in range(epochs):
        state, loss = train_epoch(state, step_fn, data, batch_size, generator)
        losses.append(loss)
        if callback is not None:
            callback(epoch, state, loss)
    return state, losses
