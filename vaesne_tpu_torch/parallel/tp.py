"""Tensor parallelism over the mesh's model axis, Megatron style.

The counterpart of ``vaesne_tpu/parallel/tp.py``, over the port's module
names and torch's [out, in] Linear weights:

- attention ``q/k/v_proj`` and ``ffn_0``: output axis split (weight rows
  and bias), so each model rank computes its own heads end to end and the
  kernels see ``H/model`` heads of ``E/model`` packed width;
- attention ``out_proj`` and ``ffn_2``: contraction axis split (weight
  columns), with one all-reduce over the model group after; their bias
  stays whole and is added after the sum;
- everything else (LayerNorms, embeddings, heads, bottleneck tokens):
  replicated.

The layers put Megatron's two autograd operators around each split pair
(``ops.partition.copy_to_model`` before, ``reduce_from_model`` after), so
the replicated parameters take the same gradient on every model rank. The
gradient all-reduce of the data-parallel step then runs over the data group
alone. The AdamW moments of a split parameter are split with it;
``gather_state_tp`` reassembles the whole state for a checkpoint.

Divisibility: every split axis must divide by the model axis, and so must
every attention's head count (``num_heads % model == 0``): a head split in
the middle would break the per-head softmax.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..nn.layers import MultiHeadAttention, TransformerBlock
from ..ops.partition import Shard, _assemble
from .mesh import Mesh, shard_of

_COL_SHARDED = ("q_proj", "k_proj", "v_proj", "ffn_0")  # output axis split
_ROW_SHARDED = ("out_proj", "ffn_2")  # contraction axis split, all-reduce after
_OWNERS = {"q_proj": MultiHeadAttention, "k_proj": MultiHeadAttention,
           "v_proj": MultiHeadAttention, "out_proj": MultiHeadAttention,
           "ffn_0": TransformerBlock, "ffn_2": TransformerBlock}


def _axis_for(name: str, ndim: int) -> Optional[int]:
    parts = name.split(".")
    if any(frag in parts for frag in _COL_SHARDED):
        return 0
    if any(frag in parts for frag in _ROW_SHARDED):
        return 1 if ndim == 2 else None  # the bias adds after the all-reduce
    return None


def tensor_parallel_specs(model: nn.Module) -> Dict[str, Optional[int]]:
    """Every parameter name → the axis split over the model axis (None:
    replicated)."""
    return {name: _axis_for(name, p.dim()) for name, p in model.named_parameters()}


def _check_divisibility(model: nn.Module, m: int, num_heads: Optional[int] = None) -> None:
    if m == 1:
        return
    heads = {mod.num_heads for mod in model.modules() if isinstance(mod, MultiHeadAttention)}
    if num_heads is not None:
        heads.add(num_heads)
    for h in sorted(heads):
        if h % m != 0:
            raise ValueError(
                f"num_heads ({h}) not divisible by model axis {m}: q/k/v shards would split "
                f"mid-head, breaking per-head softmax locality")
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        axis = _axis_for(name, p.dim())
        if axis is None:
            continue
        owner_name, _, _ = name.rpartition(".")
        parent_name, _, leaf = owner_name.rpartition(".")
        if not isinstance(modules.get(parent_name), _OWNERS.get(leaf, ())):
            raise ValueError(f"param {name} is not a projection of a MultiHeadAttention or "
                             f"TransformerBlock, whose forward runs it split")
        if p.shape[axis] % m != 0:
            raise ValueError(f"param {name} axis {axis} ({p.shape[axis]}) not divisible by "
                             f"model axis {m}")


def _split(t: torch.Tensor, axis: int, m: int, rank: int) -> torch.Tensor:
    return t.chunk(m, dim=axis)[rank].contiguous().clone()


def shard_params_tp(model: nn.Module, mesh: Mesh, num_heads: Optional[int] = None) -> nn.Module:
    """Keep this rank's model-axis shard of ``model``'s split parameters
    (in place; the Parameter objects stay, so an optimizer built on them
    still holds them) and switch its attentions and blocks to their split
    forward. ``num_heads`` adds one more head count to the divisibility
    check. Returns ``model``."""
    return _shard(model, mesh, num_heads, None)


def shard_state_tp(state, mesh: Mesh, num_heads: Optional[int] = None):
    """``shard_params_tp`` on a TrainState's model, with the AdamW moments
    of each split parameter split alike. Returns ``state``."""
    _shard(state.model, mesh, num_heads, state.optimizer)
    return state


def _shard(model: nn.Module, mesh: Mesh, num_heads, optimizer) -> nn.Module:
    m = mesh.model
    _check_divisibility(model, m, num_heads)
    if m == 1:
        return model
    rank = shard_of(mesh).model_rank
    specs = {}
    for name, p in model.named_parameters():
        axis = _axis_for(name, p.dim())
        if axis is None:
            continue
        if optimizer is not None:
            for key, t in optimizer.state.get(p, {}).items():
                if torch.is_tensor(t) and t.shape == p.shape:
                    optimizer.state[p][key] = _split(t, axis, m, rank)
        p.data = _split(p.data, axis, m, rank)
        specs[name] = axis
    for mod in model.modules():
        if isinstance(mod, (MultiHeadAttention, TransformerBlock)):
            mod.tp_size = m
    model.tp_specs = specs
    return model


def _gather(t: torch.Tensor, axis: int, shard: Shard) -> torch.Tensor:
    return _assemble(t.detach(), axis, shard.model_rank, shard.n_model, shard.model_group,
                     "gather_state_tp")


def gather_state_tp(state, mesh: Mesh) -> dict:
    """The whole ``state.state_dict()`` of a tensor-parallel rank: every
    split parameter and its AdamW moments gathered over the model group
    (a collective: every rank of the group calls it). Other states are
    returned as they are."""
    specs = getattr(state.model, "tp_specs", None)
    full = state.state_dict()
    if not specs:
        return full
    shard = shard_of(mesh)
    full["model"] = {k: (_gather(v, specs[k], shard) if k in specs else v)
                     for k, v in full["model"].items()}
    names = {id(p): n for n, p in state.model.named_parameters()}
    index = {i: names[id(p)] for i, p in enumerate(state.trainable_parameters())}
    opt = full["optimizer"]
    opt["state"] = {i: {key: (_gather(t, specs[index[i]], shard)
                              if index[i] in specs and torch.is_tensor(t) and t.dim() > 0
                              else t)
                        for key, t in entry.items()}
                    for i, entry in opt["state"].items()}
    return full
