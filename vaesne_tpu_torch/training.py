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
present. ``make_scan_epoch`` runs an epoch as the JAX package's one scanned
program runs it: on the card every step after a warm-up step is a replay of
one CUDA graph of the step, whose random draws follow each step's seed
(``utils.rng.SeedTape``). Under a data-parallel mesh the step is one list
of stages around the gradient all-reduce (``_DataParallelStep``), which
``make_train_step`` runs eagerly and ``make_scan_epoch`` captures.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import (Any, Callable, Dict, Iterator, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch import nn

from . import objectives
from .nn.layers import (TransformerStack, autocast, cudnn_fp32_deterministic, no_autocast_cache,
                        resolve_precision)
from .ops import counters, dropout_bits, partition
from .utils.profiling import span
from .utils.rng import SeedTape, StepSeed, draw_seed, fold_in, recording, word_value

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
        """The torch optimizer over ``params``: ``capturable`` on the card
        (its step count and bias corrections stay on the device), so the step
        loop and the CUDA graph of the step run one update, bitwise."""
        params = list(params)
        return torch.optim.AdamW(params, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps,
                                 weight_decay=self.weight_decay,
                                 capturable=any(p.is_cuda for p in params))


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
    optimizer, the step count and the CPU generator that seeds each step.
    ``version`` counts the restores (``load_state_dict``), which replace the
    optimizer's tensors: a CUDA graph of the step is captured anew after
    one."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator
    version: int = 0

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
        hyperparameters (learning rate, betas, weight decay, capturable), as
        the JAX package's optimizer state holds none: a resumed run trains
        with the configuration it is given, and a state saved on the CPU
        resumes on the card and the other way round."""
        self.model.load_state_dict(state["model"])
        hyper = [{k: v for k, v in g.items() if k != "params"}
                 for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(state["optimizer"])
        for group, h in zip(self.optimizer.param_groups, hyper):
            group.update(h)
            if group.get("capturable"):  # the step count lives beside its parameter
                for p in group["params"]:
                    slot = self.optimizer.state.get(p, {})
                    if "step" in slot:
                        slot["step"] = slot["step"].to(p.device, torch.float32)
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
        self.version += 1


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
                         reduction: str = "mean") -> torch.Tensor:
    """Microbatched value-and-grad: the batch axis is cut into
    ``accum_steps`` equal microbatches, each backward adds into the
    parameters' ``.grad``, so peak activation memory is one microbatch's.
    ``reduction`` must match the objective's batch reduction: ``"mean"``
    averages the microbatch losses and gradients, ``"sum"`` (``m_iwae``)
    sums them. Microbatch i takes ``fold_in(seed, i)``. Returns the loss."""
    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction must be 'mean' or 'sum', got {reduction!r}")
    total = _accumulate(neg_loss_fn, model, batch, seed, accum_steps)
    if reduction == "mean":
        inv = 1.0 / accum_steps
        torch._foreach_mul_([p.grad for p in model.parameters() if p.grad is not None], inv)
        total = total * inv
    return total


def _microbatch(batch, seed: int, i: int, accum_steps: int):
    """Microbatch ``i`` of ``accum_steps`` equal parts of ``batch``, and its
    seed ``fold_in(seed, i)``."""
    n = _leaves(batch)[0].shape[0]
    if n % accum_steps != 0:
        raise ValueError(f"batch size {n} not divisible by accum_steps {accum_steps}")
    size = n // accum_steps
    return _tree_map(lambda a: a[i * size:(i + 1) * size], batch), fold_in(seed, i)


def _accumulate(neg_loss_fn, model: nn.Module, batch, seed: int,
                accum_steps: int) -> torch.Tensor:
    """``accumulate_gradients``' microbatch loop: the gradients and the
    losses summed over the microbatches."""
    total = None
    for i in range(accum_steps):
        micro, micro_seed = _microbatch(batch, seed, i, accum_steps)
        loss = neg_loss_fn(model, micro, micro_seed)
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    return total


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


def _step_body(model: nn.Module, optimizer: AdamW, loss_fn: LossFn, accum_steps: int,
               accum_reduction: str, device: torch.device, precision: str):
    """The step's device work on one process, ``body(state, batch, seed) ->
    loss``: zero the gradients, the (accumulated) backward of ``-loss_fn``
    under bf16 autocast where ``precision`` asks for it, the clip and the
    AdamW update. It makes no host sync and keeps no host state, so a CUDA
    graph can capture it (``make_scan_epoch``)."""

    def neg_loss(m, b, seed):
        with autocast(precision, device):
            return -loss_fn(m, b, seed)

    def body(state: TrainState, batch, seed: int) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        with cudnn_fp32_deterministic():  # the convolutions' backward reads the flags
            if accum_steps == 1:
                loss = neg_loss(model, batch, seed)
                loss.backward()
                loss = loss.detach()
            else:
                loss = accumulate_gradients(neg_loss, model, batch, seed, accum_steps,
                                            accum_reduction)
        _clip_and_update(state, optimizer, None)
        return loss

    return body


def _clip_and_update(state: TrainState, optimizer: AdamW, shard) -> None:
    """The global-norm clip over the trainable parameters alone, then the
    AdamW update."""
    if optimizer.grad_clip is not None:
        grads = [(p, p.grad) for p in state.trainable_parameters() if p.grad is not None]
        clip_by_global_norm([g for _, g in grads], optimizer.grad_clip,
                            _global_norm(state, grads, shard))
    state.optimizer.step()


class _Stage(NamedTuple):
    """A part of the step, ``fn(state, batch, seed)``, the last returning
    the loss; ``captured``: a CUDA graph holds it on the card."""

    fn: Callable[[TrainState, Any, int], Optional[torch.Tensor]]
    captured: bool


class _DataParallelStep:
    """The step under a mesh, in three stages, so that a CUDA graph can hold
    each side of the gradient all-reduce (``stages``):

    (i) the (accumulated) backward of this rank's slice of each
        (micro)batch under the shard; then the trainable gradients and the
        loss packed into one buffer, the gradients times 1/n for a
        batch-mean objective;
    (ii) one all-reduce of the buffer over the data group (eager);
    (iii) the gradients unpacked (then divided by the microbatch count for
        a batch-mean objective), the loss divided by n for a batch-mean
        objective, the clip and the AdamW update.

    So the gradients are the global batch's, summed for a batch-sum
    objective and averaged for a batch-mean one, reduced once after the
    last microbatch; the backend orders the sum of the one buffer. Frozen
    parameters stay out of the buffer. ``start`` broadcasts the data
    group's first rank's parameters and buffers, once before the first
    step."""

    def __init__(self, model: nn.Module, optimizer: AdamW, loss_fn: LossFn, accum_steps: int,
                 accum_reduction: str, device: torch.device, precision: str, mesh):
        from .parallel.mesh import shard_batch, shard_of

        if accum_reduction not in ("mean", "sum"):
            raise ValueError(f"reduction must be 'mean' or 'sum', got {accum_reduction!r}")
        self.model, self.optimizer, self.accum_steps = model, optimizer, accum_steps
        self.mean = accum_reduction == "mean"
        self.shard = shard_of(mesh)
        self.buffer: Optional[torch.Tensor] = None  # the gradients, then the loss
        self.grads: List[torch.Tensor] = []  # the gradients packed into it

        def neg_loss(m, b, seed):
            with autocast(precision, device):
                return -loss_fn(m, shard_batch(b, mesh), seed)

        self.neg_loss = neg_loss

    def stages(self) -> List[_Stage]:
        return [_Stage(self.gradients, True), _Stage(self.reduce, False),
                _Stage(self.update, True)]

    def start(self) -> None:
        import torch.distributed as dist

        # the data group's first rank: (data 0, this model rank)
        for t in [*self.model.parameters(), *self.model.buffers()]:
            dist.broadcast(t.detach(), src=self.shard.model_rank, group=self.shard.data_group)

    def gradients(self, state: TrainState, batch, seed: int) -> None:
        state.optimizer.zero_grad(set_to_none=True)
        with cudnn_fp32_deterministic(), partition.sharded(self.shard):
            if self.accum_steps == 1:
                loss = self.neg_loss(self.model, batch, seed)
                loss.backward()
                loss = loss.detach()
            else:
                loss = _accumulate(self.neg_loss, self.model, batch, seed, self.accum_steps)
                if self.mean:
                    loss = loss * (1.0 / self.accum_steps)
        self._pack(state, loss)

    def _pack(self, state: TrainState, loss: torch.Tensor) -> None:
        """The trainable gradients and ``loss`` into the buffer, the
        gradients times 1/n for a batch-mean objective."""
        grads = [p.grad for p in state.trainable_parameters()]
        if any(g is None for g in grads):
            raise RuntimeError("a trainable parameter took no gradient: under a mesh every "
                               "trainable parameter must take one in every step")
        if any(g.dtype != loss.dtype for g in grads):
            raise TypeError(f"the data-parallel step packs the gradients and the loss into one "
                            f"buffer of one dtype; the loss is {loss.dtype}, the gradients "
                            f"{sorted({str(g.dtype) for g in grads})}")
        n = sum(g.numel() for g in grads) + 1
        if self.buffer is None or (self.buffer.numel(), self.buffer.dtype) != (n, loss.dtype):
            self.buffer = loss.new_empty(n)  # kept: the graphs and the all-reduce meet here
        self.grads = grads
        torch.cat([*(g.reshape(-1) for g in grads), loss.reshape(1)], out=self.buffer)
        if self.mean and self.shard.n_data > 1:
            self.buffer[:-1].mul_(1.0 / self.shard.n_data)

    def reduce(self, state: TrainState, batch, seed: int) -> None:
        import torch.distributed as dist

        dist.all_reduce(self.buffer, group=self.shard.data_group)

    def update(self, state: TrainState, batch, seed: int) -> torch.Tensor:
        parts = self.buffer.split([g.numel() for g in self.grads] + [1])
        torch._foreach_copy_(self.grads, [v.view_as(g) for v, g in zip(parts, self.grads)])
        if self.mean and self.accum_steps > 1:
            torch._foreach_mul_(self.grads, 1.0 / self.accum_steps)
        loss = parts[-1].view(())
        loss = loss / self.shard.n_data if self.mean else loss.clone()
        _clip_and_update(state, self.optimizer, self.shard)
        return loss


class _GatheredStep(_DataParallelStep):
    """``_DataParallelStep`` for an objective that gathers its model's
    outputs over the data group (``objectives.gathered``: InfoNCE over the
    global batch). The unsplit objective runs the gather's two all-reduces
    inside its forward and backward (``partition.gather_events``); here
    each (micro)batch's step splits at them, and they run as eager stages,
    as the gradient all-reduce does:

    (i) the towers: the gradients zeroed (first microbatch), this rank's
        outputs of its slice under the shard, kept with their autograd
        graph, each placed at this rank's rows of a zeroed buffer of the
        gathered shape in the gather's wide dtype;
    (ii) the all-reduce of each buffer (eager): the gather's forward;
    (iii) the head: the objective of the buffers cast back, and the
        gradient of its negation with respect to them, in the wide dtype;
    (iv) the all-reduce of each gradient (eager): the gather's backward;
    (v) this rank's rows of each summed gradient, cast back, through the
        towers' backward, whose rematerialised blocks draw their dropout
        again; after the last microbatch the packing of
        ``_DataParallelStep``'s (i);

    then its all-reduce and update. Each collective does what
    ``partition.gather_events`` does, on the same values, so the stages
    give the unsplit objective's step bitwise. The stages keep their
    outputs and buffers, which the next stage (and, on the card, its
    graph) reads."""

    def __init__(self, model: nn.Module, optimizer: AdamW, loss_fn: LossFn, accum_steps: int,
                 accum_reduction: str, device: torch.device, precision: str, mesh,
                 split: objectives.Gathered):
        super().__init__(model, optimizer, loss_fn, accum_steps, accum_reduction, device,
                         precision, mesh)
        self.split, self.device, self.precision, self.mesh = split, device, precision, mesh
        self.outputs: List[Tuple[torch.Tensor, ...]] = [()] * accum_steps
        self.gathered: List[List[torch.Tensor]] = [[] for _ in range(accum_steps)]
        self.gathered_grads: List[List[torch.Tensor]] = [[] for _ in range(accum_steps)]
        self.losses: List[Optional[torch.Tensor]] = [None] * accum_steps

    def stages(self) -> List[_Stage]:
        out = []
        for i in range(self.accum_steps):
            out += [_Stage(functools.partial(self._towers, i), True),
                    _Stage(functools.partial(self._sum, self.gathered[i]), False),
                    _Stage(functools.partial(self._head, i), True),
                    _Stage(functools.partial(self._sum, self.gathered_grads[i]), False),
                    _Stage(functools.partial(self._backward, i), True)]
        return [*out, _Stage(self.reduce, False), _Stage(self.update, True)]

    def _towers(self, i: int, state: TrainState, batch, seed: int) -> None:
        from .parallel.mesh import shard_batch

        if i == 0:
            state.optimizer.zero_grad(set_to_none=True)
        if self.accum_steps > 1:
            batch, seed = _microbatch(batch, seed, i, self.accum_steps)
        with autocast(self.precision, self.device), cudnn_fp32_deterministic(), \
                partition.sharded(self.shard):
            outs = tuple(self.split.towers(self.model, shard_batch(batch, self.mesh), seed))
        n, rank = self.shard.n_data, self.shard.data_rank
        shapes = [((o.shape[0] * n, *o.shape[1:]), partition.wide_dtype(o.dtype)) for o in outs]
        if [(tuple(b.shape), b.dtype) for b in self.gathered[i]] != shapes:
            self.gathered[i][:] = [outs[0].new_empty(shape, dtype=dtype) for shape, dtype in shapes]
            self.gathered_grads[i][:] = [torch.empty_like(b) for b in self.gathered[i]]
        for buf, o in zip(self.gathered[i], outs):
            buf.zero_()
            buf.narrow(0, rank * o.shape[0], o.shape[0]).copy_(o.detach())
        self.outputs[i] = outs

    def _sum(self, buffers: List[torch.Tensor], state: TrainState, batch, seed: int) -> None:
        for buf in buffers:
            partition.sum_events(buf, self.shard)

    def _head(self, i: int, state: TrainState, batch, seed: int) -> None:
        leaves = [buf.to(o.dtype).detach().requires_grad_()
                  for buf, o in zip(self.gathered[i], self.outputs[i])]
        with autocast(self.precision, self.device):
            neg = -self.split.head(*leaves)
        for buf, grad in zip(self.gathered_grads[i], torch.autograd.grad(neg, leaves)):
            buf.copy_(grad)
        self.losses[i] = neg.detach()

    def _backward(self, i: int, state: TrainState, batch, seed: int) -> None:
        outs, rank = self.outputs[i], self.shard.data_rank
        grads = [buf.narrow(0, rank * o.shape[0], o.shape[0]).to(o.dtype)
                 for buf, o in zip(self.gathered_grads[i], outs)]
        with cudnn_fp32_deterministic(), partition.sharded(self.shard):
            torch.autograd.backward(outs, grads)
        self.outputs[i] = ()
        if i == self.accum_steps - 1:
            loss = self.losses[0]
            for more in self.losses[1:]:
                loss = loss + more
            if self.accum_steps > 1 and self.mean:
                loss = loss * (1.0 / self.accum_steps)
            self._pack(state, loss)


def _run(stages: List[_Stage], state: TrainState, batch, seed: int) -> torch.Tensor:
    """The step's stages in order, eagerly; the last one's loss."""
    for stage in stages:
        loss = stage.fn(state, batch, seed)
    return loss


def _step_stages(model: nn.Module, optimizer: AdamW, loss_fn: LossFn, accum_steps: int,
                 accum_reduction: str, device: torch.device, precision: str, mesh):
    """The step as ``_Stage``s, and what runs once before the first step
    (None without a mesh): one captured stage on one process; under a mesh
    ``_DataParallelStep``'s stages, or ``_GatheredStep``'s for an objective
    that ``objectives.gathered`` splits where the data axis is > 1."""
    if mesh is None:
        return [_Stage(_step_body(model, optimizer, loss_fn, accum_steps, accum_reduction,
                                  device, precision), True)], None
    args = (model, optimizer, loss_fn, accum_steps, accum_reduction, device, precision, mesh)
    gathered = objectives.gathered(loss_fn) if mesh.data > 1 else None
    split = _DataParallelStep(*args) if gathered is None else _GatheredStep(*args, gathered)
    return split.stages(), split.start


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
    takes the global batch and runs, eagerly and in order, the stages that
    ``make_scan_epoch`` captures (``_DataParallelStep``, or
    ``_GatheredStep``); the data group's first rank's parameters are
    broadcast before the first step. ``accum_reduction`` names the objective's batch reduction, so the
    gradients and the returned loss are the global batch's (summed for
    ``"sum"``, averaged for ``"mean"``). The clip's norm is taken after the
    gradient all-reduce, over the whole gradient of a tensor-parallel
    model."""
    device = resolve_device(device)
    stages, start = _step_stages(model, optimizer, loss_fn, accum_steps, accum_reduction,
                                 device, resolve_precision(precision), mesh)

    def step(state: TrainState, batch) -> Tuple[TrainState, torch.Tensor]:
        nonlocal start
        if state.model is not model:
            raise ValueError("the state holds another model than this step")
        if start is not None:
            start()
            start = None
        loss = _run(stages, state, to_device(batch, device), draw_seed(state.generator))
        state.step += 1
        return state, loss

    return step


def epoch_batches(generator: torch.Generator, data, batch_size: int,
                  shuffle: bool = True) -> Iterator[Any]:
    """Minibatches of ``data`` (a nested tuple of arrays or tensors with one
    leading sample axis) in an order drawn from ``generator``; the trailing
    remainder is dropped so every step has one shape. The order goes to the
    data's device once per epoch, and each step gathers its batch there."""
    perm = _epoch_order(generator, _leaves(data)[0].shape[0], batch_size, shuffle)
    placed = {}

    def order(a):
        where = "numpy" if isinstance(a, np.ndarray) else a.device
        if where not in placed:
            placed[where] = perm.numpy() if where == "numpy" else perm.to(where)
        return placed[where]

    for i in range(perm.shape[0]):
        yield _tree_map(lambda a: a[order(a)[i]], data)


def _epoch_order(generator: torch.Generator, n: int, batch_size: int,
                 shuffle: bool = True) -> torch.Tensor:
    """The epoch's sample order, [steps, batch_size] on the CPU: a
    permutation drawn from ``generator`` without its trailing remainder."""
    steps = n // batch_size
    if steps == 0:
        raise ValueError(f"batch_size {batch_size} exceeds dataset size {n}")
    perm = torch.randperm(n, generator=generator) if shuffle else torch.arange(n)
    return perm[:steps * batch_size].view(steps, batch_size)


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


def _rebuild(tree, leaves: Iterator[torch.Tensor]):
    """``tree``'s nesting with its leaves taken from ``leaves`` in order."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    return next(leaves)


class _Captured(NamedTuple):
    """A captured step: a graph for each captured stage (None for an eager
    one), the capture's tape, the generators and seed words it draws from,
    its loss output and its kernel launches."""

    graphs: List[Optional["torch.cuda.CUDAGraph"]]
    tape: SeedTape
    generators: List[torch.Generator]
    words: torch.Tensor
    loss: torch.Tensor
    launches: Dict[str, int]


def _generator_sites(tape: SeedTape, start: int) -> int:
    """The generator sites ``tape`` recorded from site ``start`` on."""
    return sum(kind == "generator" for kind, _, _ in tape.sites[start:])


class _GraphEpoch:
    """``make_scan_epoch``'s epoch on one process or one rank, ``run(state,
    data, generator, batch_size)``: the permutation of ``epoch_batches``,
    each step's batch gathered into static buffers (``index_select(out=)``),
    the step's ``stages`` on them.

    On the card the first step of a geometry runs eagerly on a side stream,
    its draw sites recorded (``utils.rng.SeedTape``) with the stage that
    reached each; the next step captures each captured stage once as a
    ``torch.cuda.CUDAGraph``, in stage order (the later ones in the first
    one's memory pool), each with the generators its draws take registered,
    and it and every later step are replays: the host recomputes the sites'
    seeds from the step's seed, re-seeds the graphs' generators, writes the
    kernels' seed words and replays the graphs in order, running an eager
    stage (a mesh's all-reduce) between them. A stage's graph may replay
    the backward of an earlier stage's forward (``_GatheredStep``): the
    tensors that forward saved stay in the shared pool until the later
    capture has used them. Parameters and moments update in place. A new
    graph is captured when the batch geometry, the model's train mode, the
    remat setting, the dropout width, the mesh, the optimizer or its restore
    count (``TrainState.version``) changes. A failed capture raises. On the
    CPU the same stages run eagerly at every step.

    Spans (``utils.profiling.span``, recorded while a profiler runs): an
    epoch is ``train.epoch`` (``epoch``: the state's step over the epoch's
    steps), holding ``train.order`` (the permutation and its copy to the
    device), a ``train.step`` a step (``kind``: ``warm_up``, ``capture``,
    ``replay``, ``eager`` on the CPU, or ``loop`` where a mesh keeps the
    step loop: the stages run eagerly)
    and ``train.loss_read`` (the epoch's one sync); a step holds
    ``train.gather`` (the batch into the static buffers), and where graphs
    replay ``train.reseed`` (the sites' seeds, the generators' re-seeds and
    the seed words' fills), a ``train.replay`` per graph and a
    ``train.collective`` per eager stage between them.

    Under a mesh ``start`` runs once, before the first step, and the first
    step counts the layers' collectives inside the captured stages
    (``partition.collectives_reached``; an eager stage's are the step's
    own): where one runs there (a tensor-parallel layer's all-reduce, the
    gather of an objective that ``objectives.gathered`` does not split), no
    graph can hold it under gloo, and every later step runs the stages
    eagerly on its gathered batch instead (the step loop);
    ``step_loop_reason`` then names those collectives."""

    def __init__(self, model: nn.Module, stages: List[_Stage], device: torch.device,
                 mesh=None, start=None):
        if not stages[-1].captured:
            raise ValueError("the step's last stage returns the loss and must be captured")
        self.model, self.stages, self.device, self.mesh = model, stages, device, mesh
        self.start = start
        self.key = None      # what the buffers, the warm-up and the graph were made for
        self.buffers = None  # the step's batch leaves, filled in place
        self.warm = None     # the warm-up step's tape
        self.drawn: List[int] = []  # the warm-up's generator sites, stage by stage
        self.graph: Optional[_Captured] = None
        self.step_loop_reason: Optional[str] = None

    def __call__(self, state: TrainState, data, generator: torch.Generator,
                 batch_size: int) -> Tuple[TrainState, float]:
        if state.model is not self.model:
            raise ValueError("the state holds another model than this epoch function")
        data = to_device(data, self.device)
        leaves = _leaves(data)
        steps = max(leaves[0].shape[0] // batch_size, 1)  # _epoch_order raises at 0
        with span("train.epoch", epoch=state.step // steps):
            with span("train.order"):
                order = _epoch_order(generator, leaves[0].shape[0], batch_size).to(self.device)
            losses = [self._step(state, data, leaves, idx) for idx in order]
            with span("train.loss_read"):
                loss = float(torch.stack(losses).mean())
        return state, loss

    def _key(self, state: TrainState, leaves, batch_size: int):
        remat = tuple(m.remat for m in self.model.modules() if isinstance(m, TransformerStack))
        return (tuple((a.shape[1:], a.dtype) for a in leaves), batch_size, state.optimizer,
                state.version, self.model.training, dropout_bits(), remat, self.mesh)

    def _step(self, state: TrainState, data, leaves, idx: torch.Tensor) -> torch.Tensor:
        if self.step_loop_reason is not None:
            with span("train.step", kind="loop"):
                loss = _run(self.stages, state, _tree_map(lambda a: a[idx], data),
                            draw_seed(state.generator))
                state.step += 1
            return loss
        with span("train.step") as step:
            seed = StepSeed(draw_seed(state.generator))
            key = self._key(state, leaves, idx.numel())
            if key != self.key:
                self.key, self.warm, self.graph = key, None, None
                self.buffers = [a.new_empty((idx.numel(), *a.shape[1:])) for a in leaves]
            step.set(kind="replay" if self.graph is not None
                     else "warm_up" if self.warm is None
                     else "eager" if self.device.type != "cuda" else "capture")
            with span("train.gather"):
                for a, buf in zip(leaves, self.buffers):
                    torch.index_select(a, 0, idx, out=buf)
            if self.graph is None:
                batch = _rebuild(data, iter(self.buffers))
                if self.warm is None:
                    loss = self._warm_up(state, batch, seed)
                elif self.device.type != "cuda":
                    loss = _run(self.stages, state, batch, seed)
                else:
                    self._capture(state, batch, seed)
            if self.graph is not None:
                loss = self._replay(state, seed)
            state.step += 1
        return loss

    def _warm_up(self, state: TrainState, batch, seed: int) -> torch.Tensor:
        """The first step of a geometry, eager (on the card on a side
        stream, as torch asks of a capture's warm-up, its draw sites
        recorded), each stage's generator sites and the collectives of the
        captured stages counted."""
        if self.start is not None:
            self.start()
            self.start = None
        tape, reached, self.drawn = SeedTape(), set(), []
        with contextlib.ExitStack() as stack:
            if self.device.type == "cuda":
                main = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(self.device)
                side.wait_stream(main)
                stack.enter_context(torch.cuda.stream(side))
                stack.enter_context(recording(tape))  # on the CPU no capture follows
            for stage in self.stages:
                before, sites = partition.collectives_reached(), len(tape.sites)
                loss = stage.fn(state, batch, seed)
                self.drawn.append(_generator_sites(tape, sites))
                if stage.captured:
                    reached.update(name for name, n in partition.collectives_reached().items()
                                   if n != before.get(name, 0))
        if self.device.type == "cuda":
            main.wait_stream(side)
            loss.record_stream(main)
        if reached:
            if self.mesh is None:
                raise RuntimeError(f"the step ran {', '.join(sorted(reached))} outside a mesh")
            self.step_loop_reason = ", ".join(sorted(reached))
        self.warm = tape
        return loss

    def _capture(self, state: TrainState, batch, seed: int) -> None:
        """Capture the captured stages in order: a generator per generator
        site of the warm-up, registered with the graph of the stage that
        draws from it, and a seed word per kernel seed, which every stage
        reads (K2 and a rematerialised K1 the word their forward read). The
        capture runs no kernel, so its launches come off the counters."""
        warm = self.warm
        generators = [torch.Generator(device=self.device) for _ in warm.paths("generator")]
        words = torch.zeros(len(warm.paths("word")), dtype=torch.int32, device=self.device)
        tape = SeedTape(generators, words)
        graphs, pool, registering = [], None, iter(generators)
        # a mesh's process group polls its work from threads of its own,
        # whose CUDA calls must not void this thread's capture
        mode = "global" if self.mesh is None else "thread_local"
        before = counters.launch_counts()
        # autocast's cached casts would outlive the capture; uncached, the
        # casts give the same values
        with recording(tape), no_autocast_cache():
            for stage, drawn in zip(self.stages, self.drawn):
                if not stage.captured:
                    if drawn:
                        raise RuntimeError("an eager stage of the step draws random numbers, "
                                           "which no graph re-seeds")
                    graphs.append(None)
                    continue
                graph = torch.cuda.CUDAGraph()
                for _ in range(drawn):
                    graph.register_generator_state(next(registering))
                sites = len(tape.sites)
                with torch.cuda.graph(graph, pool=pool, capture_error_mode=mode):
                    loss = stage.fn(state, batch, seed)
                if _generator_sites(tape, sites) != drawn:
                    raise RuntimeError("a captured stage drew from other generator sites than "
                                       "in its warm-up step")
                pool = graph.pool() if pool is None else pool
                graphs.append(graph)
        after = counters.launch_counts()
        counters.set_launch_counts(before)
        if [site[:2] for site in tape.sites] != [site[:2] for site in warm.sites]:
            raise RuntimeError("the captured step reached other draw sites than its warm-up step")
        self.graph = _Captured(graphs, tape, generators, words, loss,
                               {name: after[name] - before[name] for name in after})
        counters.add_launch_counts({"captures": 1})  # after the restore; a replay adds 0

    def _replay(self, state: TrainState, seed: int) -> torch.Tensor:
        g = self.graph
        with span("train.reseed"):
            generator_seeds, word_seeds = g.tape.values(seed)
            for generator, s in zip(g.generators, generator_seeds):
                generator.manual_seed(s)
            for word, s in zip(g.words.unbind(), word_seeds):  # a fill each, in stream order
                word.fill_(word_value(s))
        for stage, graph in zip(self.stages, g.graphs):
            if graph is None:
                with span("train.collective"):
                    stage.fn(state, None, seed)
            else:
                with span("train.replay"):
                    graph.replay()
        counters.add_launch_counts(g.launches)
        return g.loss.clone()


def make_scan_epoch(model: nn.Module, optimizer: AdamW, loss_fn: LossFn,
                    accum_steps: int = 1, accum_reduction: str = "mean", device=None,
                    mesh=None, precision: Optional[str] = None, graph: bool = True):
    """The whole-epoch train function ``run(state, data, generator,
    batch_size) -> (state, mean loss)``, the counterpart of the JAX
    package's ``make_scan_epoch``, at ``precision`` (None: ``VAESNE_BF16``
    when the function is built). The host syncs once an epoch, for the mean
    loss.

    ``graph=True`` (``train.scan_epoch``, the default): on the card one CUDA
    graph of the step, replayed at every step after a warm-up step, with
    the same permutation, seeds and update as the step loop, bitwise
    (``_GraphEpoch``); on the CPU the same capture-ready body eagerly.
    Under ``mesh`` every rank draws the same permutation and runs its slice
    of each step's batch, and the step is ``make_train_step``'s stages: two
    graphs, the gradients and the update, around the gradient all-reduce,
    which runs eagerly between their replays (``_DataParallelStep``). An
    objective that gathers its model's outputs over the ranks
    (``objectives.gathered``: InfoNCE's global batch) splits its backward
    at the gather too, whose all-reduces run eagerly between graphs of the
    towers, the head and the towers' backward (``_GatheredStep``). A
    collective inside a captured stage (a tensor-parallel layer's, an
    unsplit objective's gather) keeps the step loop from the second step
    on, and the function's ``step_loop_reason`` names it. ``graph=False``:
    ``train_epoch`` over ``make_train_step``."""
    if graph:
        device = resolve_device(device)
        stages, start = _step_stages(model, optimizer, loss_fn, accum_steps, accum_reduction,
                                     device, resolve_precision(precision), mesh)
        return _GraphEpoch(model, stages, device, mesh, start)
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
