"""Weights of the port: the bridge from the JAX package's parameter tree,
and a seeded initialisation.

The port names its submodules after the flax parameter tree, so the bridge
is mechanical: ``vaes_0`` ↔ ``vaes.0``, every other scope name as it is, and
per leaf

  Dense ``kernel`` [in, out]  → ``weight`` [out, in] (transposed)
  Dense/LayerNorm ``bias``    → ``bias``
  LayerNorm ``scale``         → ``weight``
  Embed ``embedding``         → ``weight``
  ``initbottleneck``          → ``initbottleneck``
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias", "initbottleneck": "initbottleneck"}
_LIST_SCOPE = re.compile(r"^(vaes)_(\d+)$")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


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
            value = value.T
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


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter from ``generator`` (on the CPU), so a seed
    alone fixes the weights: Linear weight and bias ~ U(±1/√fan_in),
    LayerNorm 1 and 0, Embedding and ``initbottleneck`` ~ N(0, 1)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            for p in (m.weight, m.bias):
                u = torch.rand(p.shape, generator=generator)
                p.copy_((2.0 * u - 1.0) * bound)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        if isinstance(getattr(m, "initbottleneck", None), nn.Parameter):
            m.initbottleneck.copy_(torch.randn(m.initbottleneck.shape, generator=generator))
    return module
