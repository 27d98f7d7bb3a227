"""Integer seeds for the port's random draws.

The JAX package splits and folds PRNG keys; the port passes plain integer
seeds instead and derives every child seed with ``fold_in``, a pure function
of (seed, data). A dropout site inside a block that ``torch.utils.checkpoint``
re-runs in the backward therefore sees the same seed on the re-run, which a
``torch.Generator`` advanced inside the block would not give.
"""

from __future__ import annotations

from typing import Optional

import torch

_MASK64 = (1 << 64) - 1
SEED_BOUND = 1 << 31  # seeds are non-negative int32, as the JAX layer draws them


def _mix64(x: int) -> int:
    """splitmix64's finaliser: a bijection on 64-bit integers."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new seed in [0, 2³¹) from ``seed`` and ``data`` (the counterpart of
    ``jax.random.fold_in``)."""
    return (_mix64((_mix64(seed & _MASK64) + data + 1) & _MASK64) % SEED_BOUND)


def maybe_fold_in(seed: Optional[int], data: int) -> Optional[int]:
    """``fold_in`` that passes None through (no seed: dropout is off)."""
    return None if seed is None else fold_in(seed, data)


def draw_seed(generator: torch.Generator) -> int:
    """One seed in [0, 2³¹) from a CPU generator (no device sync)."""
    return int(torch.randint(SEED_BOUND, (1,), generator=generator))


def device_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(seed)
