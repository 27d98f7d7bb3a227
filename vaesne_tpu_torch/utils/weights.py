"""Weights of the port: the bridge from the JAX package's parameter tree
and back, and a seeded initialisation.

The port names its submodules after the flax parameter tree, so the bridge
is mechanical: ``vaes_0`` ↔ ``vaes.0``, every other scope name as it is, and
per leaf

  Dense ``kernel`` [in, out]  → ``weight`` [out, in] (transposed)
  Conv ``kernel`` [kh, kw, in, out] → ``weight`` [out, in, kh, kw]
  Dense/Conv/LayerNorm ``bias`` → ``bias``
  LayerNorm ``scale``         → ``weight``
  Embed ``embedding``         → ``weight``
  ``initbottleneck``, ``pos_embed``, ``embeddings_table`` → themselves

A Dense without bias (``nn/extras.py``'s ``freq``) has a kernel alone.

A square conv kernel's ``.T`` would also pass the shape check, with kh and
kw swapped: conv kernels take their own permutation.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias", "initbottleneck": "initbottleneck", "pos_embed": "pos_embed",
         "embeddings_table": "embeddings_table"}
# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance_scaling divides by it so the truncated draw keeps its variance
_TRUNC_STD = 0.87962566103423978
_LIST_SCOPE = re.compile(r"^(vaes)_(\d+)$")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def torch_weight(kernel: np.ndarray) -> np.ndarray:
    """A flax ``kernel`` in the port's weight layout: Dense [in, out] →
    [out, in]; Conv [kh, kw, in, out] → [out, in, kh, kw]."""
    return kernel.T if kernel.ndim == 2 else np.transpose(kernel, (3, 2, 0, 1))


def flax_kernel(weight: np.ndarray) -> np.ndarray:
    """The inverse of ``torch_weight``."""
    return weight.T if weight.ndim == 2 else np.transpose(weight, (2, 3, 1, 0))


def torch_key(path: Tuple[str, ...]) -> Optional[str]:
    """The port's state_dict key for one flax parameter path (None for a
    leaf kind the port does not have)."""
    *scopes, leaf = path
    if leaf not in _LEAF:
        return None
    parts = []
    for s in scopes:
        m = _LIST_SCOPE.match(s)
        parts.append(f"{m.group(1)}.{m.group(2)}" if m else s)
    return ".".join(parts + [_LEAF[leaf]])


def load_jax_params(module: nn.Module, params: Mapping) -> None:
    """Fill ``module``'s parameters from the JAX package's ``{"params": …}``
    tree of numpy arrays. Raises on any port parameter left unfilled, any
    flax parameter left unused, and any shape mismatch."""
    flat = _flatten(params["params"])
    state = module.state_dict()
    new_state, unused = {}, []
    for path, value in flat.items():
        key = torch_key(path)
        if key not in state:
            unused.append("/".join(path))
            continue
        if path[-1] == "kernel":
            value = torch_weight(value)
        if tuple(value.shape) != tuple(state[key].shape):
            raise ValueError(f"{'/'.join(path)}: shape {value.shape} does not fit "
                             f"{key} {tuple(state[key].shape)}")
        new_state[key] = torch.tensor(np.array(value), dtype=state[key].dtype)
    missing = sorted(set(state) - set(new_state))
    if missing or unused:
        raise ValueError(f"parameter trees differ: port keys with no flax "
                         f"parameter {missing}; flax parameters with no port "
                         f"key {sorted(unused)}")
    module.load_state_dict(new_state, strict=True)


_TORCH_LEAF = {nn.Linear: {"weight": "kernel", "bias": "bias"},
               nn.Conv2d: {"weight": "kernel", "bias": "bias"},
               nn.LayerNorm: {"weight": "scale", "bias": "bias"},
               nn.Embedding: {"weight": "embedding"}}


def to_jax_params(module: nn.Module,
                  values: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Dict]:
    """The inverse of ``load_jax_params``: the flax ``{"params": …}`` tree
    of numpy arrays holding ``module``'s parameters, or ``values`` keyed by
    parameter name instead (gradients, say). Kernels come out in flax's
    layout (``flax_kernel``)."""
    values = dict(module.named_parameters()) if values is None else values
    tree: Dict[str, Dict] = {}
    for mod_name, mod in module.named_modules():
        leaves = next((v for k, v in _TORCH_LEAF.items() if isinstance(mod, k)), {})
        own = [n for n, _ in mod.named_parameters(recurse=False)]
        for name in own:
            leaf = leaves.get(name, name)
            if leaf not in _LEAF:
                raise ValueError(f"{mod_name}.{name}: no flax counterpart")
            key = f"{mod_name}.{name}" if mod_name else name
            value = values[key].detach().cpu().numpy()
            if leaf == "kernel":
                value = flax_kernel(value)
            node = tree
            for scope in (_list_scope(mod_name) if mod_name else []):
                node = node.setdefault(scope, {})
            node[leaf] = value
    return {"params": tree}


def _list_scope(name: str):
    """``vaes.0.enc.blocks`` → ``["vaes_0", "enc", "blocks"]``."""
    parts, out = name.split("."), []
    for p in parts:
        if p.isdigit() and out and _LIST_SCOPE.match(f"{out[-1]}_{p}"):
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return out


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter from ``generator`` (on the CPU), so a seed
    alone fixes the weights: Linear weight and bias ~ U(±1/√fan_in),
    Conv2d weight lecun-normal as flax's default (a normal truncated at ±2σ,
    rescaled to variance 1/fan_in, fan_in = kh·kw·in) and bias 0, LayerNorm
    1 and 0, Embedding and ``initbottleneck`` ~ N(0, 1), ``pos_embed`` 0,
    ``embeddings_table`` xavier-uniform (flax's default for it)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2.0 * std, b=2.0 * std,
                                  generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            for p in (m.weight, m.bias):
                if p is not None:
                    u = torch.rand(p.shape, generator=generator)
                    p.copy_((2.0 * u - 1.0) * bound)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        if isinstance(getattr(m, "initbottleneck", None), nn.Parameter):
            m.initbottleneck.copy_(torch.randn(m.initbottleneck.shape, generator=generator))
        if isinstance(getattr(m, "pos_embed", None), nn.Parameter):
            m.pos_embed.zero_()
        if isinstance(getattr(m, "embeddings_table", None), nn.Parameter):
            rows, units = m.embeddings_table.shape
            bound = math.sqrt(6.0 / (rows + units))
            u = torch.rand(m.embeddings_table.shape, generator=generator)
            m.embeddings_table.copy_((2.0 * u - 1.0) * bound)
    return module
