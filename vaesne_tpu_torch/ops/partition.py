"""The kernels and layers under a (data, model) mesh: where this rank sits,
its dropout seeds, and the collectives the layers run.

The counterpart of ``vaesne_tpu/ops/partition.py`` and of the seed rule in
``vaesne_tpu/ops/attention.py::_seed_lower_fn``. The JAX package runs one
program on global shapes and partitions the Pallas calls per shard; here
every rank is a process that runs its own shard of the events (the data
axis) and, under tensor parallelism, its own heads (the model axis), and
calls the kernels on those local shapes.

``sharded(shard)`` marks the computation that runs on this rank's event
shard (a train step's forward and backward, a served request, an
evaluation chunk). Inside it:

* ``shard_seed`` offsets a kernel's dropout seed by the shard's linearized
  mesh index times ``local_rows·local_heads·1024``, the kernel's seed
  namespace on one shard, so the shards' mask streams are disjoint and each
  equals the JAX package's sharded kernel's, shard for shard; a step seed
  keeps its ``fold_in`` path through the offset (``utils.rng.add_offset``),
  so a CUDA graph of a rank's step recomputes it at every replay;
* ``global_draw`` draws a generator dropout's mask (the residual branches,
  the plain attention path) for the whole step and keeps this rank's part,
  so the ranks drop what one process drops;
* ``global_rows`` and the layers' global head count are what the dispatch
  rule is asked, as the JAX package traces global shapes;
* ``draw_events`` (``distributions``) draws the posterior noise for the
  global batch and keeps this rank's events.

The collectives are autograd functions: ``copy_to_model`` and
``reduce_from_model`` are Megatron's pair around a column- and a
row-parallel layer, ``gather_events`` assembles the ranks' event shards on
every rank with one all-reduce into a zeroed buffer (gloo on CUDA tensors
offers all-reduce and broadcast alone). ``collectives_reached`` counts them
by name, so a train step can tell whether a collective runs inside a part
of it that a CUDA graph would hold. A data-parallel train step that splits
its objective at the gather (``objectives.gathered``) runs the gather's
all-reduces itself, eagerly between its graphs, through ``sum_events``
(counted as ``gather_events``) in the gather's ``wide_dtype``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from ..utils.rng import add_offset

SEED_NAMESPACE = 1024  # the kernel's seed block per (row, head)


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place on a (data, model) mesh (``rank`` = data_rank·
    n_model + model_rank) and its two groups: ``data_group`` joins the
    ranks that hold one model shard (the gradient all-reduce's group),
    ``model_group`` those that hold one event shard (TP's group)."""

    data_rank: int
    n_data: int
    model_rank: int = 0
    n_model: int = 1
    data_group: Any = None
    model_group: Any = None
    rank: int = 0


_ACTIVE: Optional[Shard] = None


def active() -> Optional[Shard]:
    """The shard whose events run now, or None on one process."""
    return _ACTIVE


@contextlib.contextmanager
def sharded(shard: Optional[Shard]) -> Iterator[None]:
    """Run the body on ``shard``'s events (None: on the whole batch)."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, shard
    try:
        yield
    finally:
        _ACTIVE = before


def shard_seed(seed: int, data_rank: int, model_rank: int, n_model: int, local_rows: int,
               local_heads: int) -> int:
    """The kernel seed of the shard at (``data_rank``, ``model_rank``):
    ``seed + index·local_rows·local_heads·1024`` mod 2³², the index
    linearized with the batch axis before the head axis
    (``vaesne_tpu/ops/attention.py:572-607``). Pass ``model_rank`` 0 and
    ``n_model`` 1 where the heads are not split. A ``StepSeed`` gives a
    ``StepSeed`` of the same value."""
    index = data_rank * n_model + model_rank
    return add_offset(seed, index * local_rows * local_heads * SEED_NAMESPACE)


def kernel_seed(seed: Optional[int], rows: int, heads: int, heads_split: bool) -> Optional[int]:
    """``seed`` as the active shard's kernel takes it (``shard_seed``) for
    a local grid of ``rows`` rows and ``heads`` heads."""
    s = _ACTIVE
    if s is None or seed is None:
        return seed
    if heads_split:
        return shard_seed(seed, s.data_rank, s.model_rank, s.n_model, rows, heads)
    return shard_seed(seed, s.data_rank, 0, 1, rows, heads)


def global_draw(draw: Callable[[Tuple[int, ...]], torch.Tensor], shape: Tuple[int, ...],
                head_axis: Optional[int] = None) -> torch.Tensor:
    """``draw(shape)`` for a dropout mask of local ``shape``; on one of
    several shards the draw for the whole step, of which this rank keeps its
    part, so the ranks' masks are one process's, element for element.

    Dim 0 holds rows in event-major order (an encoder's B rows, a decoder's
    B·K rows with b·K + k), so this rank's rows are one block of the whole
    step's. Where ``head_axis`` is given and the heads are split, it keeps
    its model rank's heads there."""
    s = _ACTIVE
    rows_split = s is not None and s.n_data > 1
    heads_split = s is not None and head_axis is not None and s.n_model > 1
    if not (rows_split or heads_split):
        return draw(shape)
    full = list(shape)
    if rows_split:
        full[0] *= s.n_data
    if heads_split:
        head_axis %= len(shape)
        full[head_axis] *= s.n_model
    out = draw(tuple(full))
    if rows_split:
        out = out.narrow(0, s.data_rank * shape[0], shape[0])
    if heads_split:
        out = out.narrow(head_axis, s.model_rank * shape[head_axis], shape[head_axis])
    return out


def global_rows(rows: int) -> int:
    """The global count of a [rows, ...] grid sharded over the events."""
    return rows if _ACTIVE is None else rows * _ACTIVE.n_data


_REACHED: Dict[str, int] = {}


def collectives_reached() -> Dict[str, int]:
    """How often each of the layers' collectives has run in this process,
    by name: ``copy_to_model`` (its backward), ``reduce_from_model``,
    ``gather_events`` (forward and backward), ``gather_state_tp``."""
    return dict(_REACHED)


def _all_reduce(t: torch.Tensor, group, name: str) -> torch.Tensor:
    import torch.distributed as dist

    _REACHED[name] = _REACHED.get(name, 0) + 1
    dist.all_reduce(t, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce over the model group backward: the
    input of a column-parallel layer, whose gradient arrives split over
    the model ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.group, "copy_to_model"), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over the model group forward, identity backward: the sum
    of a row-parallel layer's partial products."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group, "reduce_from_model")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x, _ACTIVE.model_group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x, _ACTIVE.model_group)


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a collective sums ``dtype`` in: fp64 stays, other floats
    go to fp32, integers and booleans to int64."""
    if dtype == torch.float64:
        return dtype
    return torch.float32 if dtype.is_floating_point else torch.int64


def _assemble(t: torch.Tensor, axis: int, rank: int, n: int, group, name: str) -> torch.Tensor:
    shape = list(t.shape)
    size = shape[axis]
    shape[axis] = size * n
    out = torch.zeros(shape, dtype=wide_dtype(t.dtype), device=t.device)
    out.narrow(axis, rank * size, size).copy_(t)
    return _all_reduce(out, group, name).to(t.dtype)


class _GatherEvents(torch.autograd.Function):
    """The ranks' event shards side by side on every rank; the backward
    sums every rank's gradient of its copy and keeps this rank's slice, as
    each rank's loss is a function of the whole."""

    @staticmethod
    def forward(ctx, t, axis, shard):
        ctx.axis, ctx.shard = axis, shard
        return _assemble(t, axis, shard.data_rank, shard.n_data, shard.data_group,
                         "gather_events")

    @staticmethod
    def backward(ctx, grad):
        s, size = ctx.shard, grad.shape[ctx.axis] // ctx.shard.n_data
        total = _all_reduce(grad.to(wide_dtype(grad.dtype)).contiguous().clone(), s.data_group,
                            "gather_events")
        return total.narrow(ctx.axis, s.data_rank * size, size).to(grad.dtype), None, None


def gather_events(t: torch.Tensor, axis: int = 0, shard: Optional[Shard] = None) -> torch.Tensor:
    """``t`` ([..., local events, ...] on ``axis``) with every rank's
    events in rank order, on every rank of the data group (differentiable;
    assembled in fp32, fp64 or int64). ``t`` itself where no event axis is
    split. Its forward and its backward each run one all-reduce; the
    data-parallel CUDA graph of a step runs them between its graphs
    instead (``training._GatheredStep``, with ``sum_events``)."""
    s = _ACTIVE if shard is None else shard
    if s is None or s.n_data == 1:
        return t
    return _GatherEvents.apply(t, axis, s)


def sum_events(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``gather_events``' all-reduce of ``t`` over the data group, in place
    and counted as ``gather_events``: of the zeroed buffer holding this
    rank's events in the forward, of the gradient of the gathered tensor in
    the backward, each in ``wide_dtype``."""
    return _all_reduce(t, shard.data_group, "gather_events")
