"""The random draws of the system under test, worked out from the seed.

The program draws every random number from an integer seed: posterior
noise and residual or weight dropout from a ``torch.Generator`` seeded with
a derived seed, the dropout of the large attention grids from a counter
hash of a seed. These are part of what a step or a request computes, so
the reference derives them again from the same seeds, by the same rules,
written out here: ``fold_in`` (splitmix64's finaliser), the hash and its
keep threshold. Nothing here is imported from the program.
"""

from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1
M32 = 0xFFFFFFFF
SEED_BOUND = 1 << 31

# the counter hash of the attention kernels' dropout
Q_TILE = 1024
DROPOUT_BITS = 8
_C_SEED, _C_ROW, _C_COL = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_C_MIX1, _C_MIX2 = 0x7FEB352D, 0x846CA68B

# the rule that sends an attention grid to the kernels (and so to the hash)
GRID_THRESHOLD = 1 << 16
LOGIT_BYTES_THRESHOLD = 1 << 28


def _mix64(x: int) -> int:
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A child seed in [0, 2**31) of ``seed`` and ``data``."""
    return _mix64((_mix64(seed & MASK64) + data + 1) & MASK64) % SEED_BOUND


def maybe_fold_in(seed, data: int):
    return None if seed is None else fold_in(seed, data)


def draw_seed(generator: torch.Generator) -> int:
    """A step's seed from the run's CPU generator."""
    return int(torch.randint(SEED_BOUND, (1,), generator=generator))


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def routes_to_hash(rows: int, heads: int, lq: int, lk: int) -> bool:
    """True where the attention grid's dropout is the counter hash: a large
    Lq·Lk, or 256 MiB of fp32 logits over the whole batch's rows."""
    return lq * lk >= GRID_THRESHOLD or rows * heads * lq * lk * 4 >= LOGIT_BYTES_THRESHOLD


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    hi = ((x >> 16) * c) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * c) & M32


def hash_keep(seed: int, row0: int, rows: int, heads: int, lq: int, lk: int, rate: float,
              device) -> torch.Tensor:
    """The hash dropout's keep mask, bool [rows, H, Lq, Lk], for the rows
    row0 .. row0 + rows of the batch: for row r, head h, query q, key j,
    with qt = min(1024, Lq rounded up to 128),
    block_seed = seed + (r·H + h)·1024 + (q // qt)·(qt / 128) mod 2**32,
    x = the hash of (block_seed, q mod qt, j), keep iff x >> 24 >= round(256·rate)."""
    qt = min(Q_TILE, max(128, -(-lq // 128) * 128))
    i64 = dict(dtype=torch.int64, device=device)
    r = torch.arange(row0, row0 + rows, **i64).view(-1, 1, 1)
    h = torch.arange(heads, **i64).view(1, -1, 1)
    q = torch.arange(lq, **i64).view(1, 1, -1)
    block_seed = ((seed & M32) + (r * heads + h) * 1024 + (q // qt) * (qt // 128)) & M32
    row = _mul32(block_seed, _C_SEED) ^ _mul32(q % qt + 1, _C_ROW)
    col = _mul32(torch.arange(1, lk + 1, **i64), _C_COL)
    x = row[..., None] ^ col
    x = x ^ (x >> 16)
    x = _mul32(x, _C_MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C_MIX2)
    x = x ^ (x >> 16)
    threshold = min(round(rate * 2 ** DROPOUT_BITS), 2 ** DROPOUT_BITS - 1)
    return (x >> (32 - DROPOUT_BITS)) >= threshold
