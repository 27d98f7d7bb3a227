"""Integer seeds for the port's random draws.

The JAX package splits and folds PRNG keys; the port passes plain integer
seeds instead and derives every child seed with ``fold_in``, a pure function
of (seed, data). A dropout site inside a block that ``torch.utils.checkpoint``
re-runs in the backward therefore sees the same seed on the re-run, which a
``torch.Generator`` advanced inside the block would not give.

A CUDA graph of the train step (``training.make_scan_epoch``) freezes every
integer it was captured with, so a step seed is a ``StepSeed``: an int that
also carries its ``fold_in`` path from the step's seed. Under a ``SeedTape``
(``recording``) every draw site of the step is recorded with its path, in
the order the step reaches it: each posterior or dropout generator
(``device_generator``) and each dropout seed of the attention kernels
(``seed_word``). Before a replay the host recomputes every site's seed from
the replayed step's seed (``SeedTape.values``), re-seeds the graph's own
generators and writes the kernels' seeds into the device words the graph
reads, so each replay draws what the eager step would draw with its seed.
A rank's kernel seed is the step's plus its shard's offset (``add_offset``),
which the path records too.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

_MASK64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
SEED_BOUND = 1 << 31  # seeds are non-negative int32, as the JAX layer draws them

# a path's steps: an int is fold_in's data, ("+", k) adds k mod 2³² (add_offset)
Path = Tuple[Union[int, Tuple[str, int]], ...]


def _mix64(x: int) -> int:
    """splitmix64's finaliser: a bijection on 64-bit integers."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _MASK64
    return x ^ (x >> 31)


class StepSeed(int):
    """A train step's seed, or a seed folded from one: the integer, and
    ``path``, the ``fold_in`` data (and ``add_offset`` offsets) that lead
    from the step's seed to it. Other arithmetic gives a plain int."""

    path: Path

    def __new__(cls, value: int, path: Path = ()):
        seed = super().__new__(cls, value)
        seed.path = path
        return seed


def fold_in(seed: int, data: int) -> int:
    """A new seed in [0, 2³¹) from ``seed`` and ``data`` (the counterpart of
    ``jax.random.fold_in``); a ``StepSeed`` in, a ``StepSeed`` out."""
    value = _mix64((_mix64(seed & _MASK64) + data + 1) & _MASK64) % SEED_BOUND
    path = getattr(seed, "path", None)
    return value if path is None else StepSeed(value, path + (data,))


def add_offset(seed: int, offset: int) -> int:
    """``(seed + offset) mod 2³²``, an event or head shard's kernel seed
    (``ops.partition.shard_seed``); a ``StepSeed`` in, a ``StepSeed`` out,
    whose path ends in the offset, so a replay recomputes it."""
    value = (int(seed) + offset) & _M32
    path = getattr(seed, "path", None)
    return value if path is None else StepSeed(value, path + (("+", offset),))


def _follow(seed: int, step) -> int:
    """One step of a path from ``seed``: ``fold_in`` or ``add_offset``."""
    return add_offset(seed, step[1]) if isinstance(step, tuple) else fold_in(seed, step)


def maybe_fold_in(seed: Optional[int], data: int) -> Optional[int]:
    """``fold_in`` that passes None through (no seed: dropout is off)."""
    return None if seed is None else fold_in(seed, data)


def draw_seed(generator: torch.Generator) -> int:
    """One seed in [0, 2³¹) from a CPU generator (no device sync)."""
    return int(torch.randint(SEED_BOUND, (1,), generator=generator))


class SeedTape:
    """The draw sites of one train step, in the order the step reaches them.

    Recording an eager step (no arguments) keeps each site's kind, path and
    seed. Recording a capture (``generators``, ``words``) also hands the
    graph its draws: the k-th generator site gets ``generators[k]``, created
    and registered with the graph before the capture, and each distinct
    kernel seed a word of ``words``, an int32 buffer on the card."""

    def __init__(self, generators: Optional[Sequence[torch.Generator]] = None,
                 words: Optional[torch.Tensor] = None):
        self.generators = generators
        self.words = words
        self.sites: List[Tuple[str, Optional[Path], int]] = []  # (kind, path, seed)
        self._n_generators = 0
        self._slots: Dict[Path, int] = {}
        self._plan: Optional[Tuple[List[Path], List[Path]]] = None

    @property
    def capturing(self) -> bool:
        return self.generators is not None

    def _path(self, kind: str, seed: int) -> Optional[Path]:
        path = getattr(seed, "path", None)
        if path is None and self.capturing:
            raise RuntimeError(
                f"a {kind} seed that does not derive from the step's seed by fold_in would be "
                f"frozen into the CUDA graph: every replay would draw the same numbers")
        self.sites.append((kind, path, int(seed)))
        return path

    def generator(self, seed: int, device) -> torch.Generator:
        path = self._path("generator", seed)
        if not self.capturing:
            return torch.Generator(device=torch.device(device)).manual_seed(seed)
        k, self._n_generators = self._n_generators, self._n_generators + 1
        if k >= len(self.generators):
            raise RuntimeError(f"the captured step draws from more than the {len(self.generators)} "
                               f"generators its warm-up step drew from")
        return self.generators[k]

    def word(self, seed: int, device) -> torch.Tensor:
        path = self._path("word", seed)
        if not self.capturing:
            return _make_word(seed, device)
        slot = self._slots.setdefault(path, len(self._slots))
        if slot >= self.words.numel():
            raise RuntimeError(f"the captured step takes more than the {self.words.numel()} "
                               f"kernel seeds its warm-up step took")
        return self.words[slot:slot + 1]

    def paths(self, kind: str) -> List[Path]:
        """The paths of the ``kind`` sites ("generator" or "word"), in order;
        a word's path once, at its first use."""
        seen, out = set(), []
        for k, path, _ in self.sites:
            if k == kind and (kind == "generator" or path not in seen):
                seen.add(path)
                out.append(path)
        return out

    def values(self, seed: int) -> Tuple[List[int], List[int]]:
        """(each generator site's seed, each kernel word's seed) of the step
        whose seed is ``seed``: host integer work only. Call it once the
        step is recorded."""
        if self._plan is None:
            self._plan = (self.paths("generator"), self.paths("word"))
        memo: Dict[Path, int] = {(): int(seed)}

        def at(path: Path) -> int:
            value = memo.get(path)
            if value is None:
                value = memo[path] = _follow(at(path[:-1]), path[-1])
            return value

        return [at(p) for p in self._plan[0]], [at(p) for p in self._plan[1]]


_TAPE: Optional[SeedTape] = None


@contextlib.contextmanager
def recording(tape: SeedTape) -> Iterator[SeedTape]:
    """Record the draw sites reached inside the block on ``tape``."""
    global _TAPE
    before, _TAPE = _TAPE, tape
    try:
        yield tape
    finally:
        _TAPE = before


def device_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (under a capture's
    tape, the graph's generator for this site)."""
    if _TAPE is not None:
        return _TAPE.generator(seed, device)
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def word_value(seed: int) -> int:
    """``seed`` mod 2³² as the int32 with its bits (a kernel reads the word
    as uint32)."""
    v = int(seed) & _M32
    return v - (1 << 32) if v >= 1 << 31 else v


def _make_word(seed: int, device) -> torch.Tensor:
    # a fill on the device's current stream: no host memory to wait for (a
    # pinned staging buffer would be reused only once its copy, queued
    # behind the card's work, had run)
    return torch.full((1,), word_value(seed), dtype=torch.int32, device=device)


def seed_word(seed: Union[int, torch.Tensor], device) -> torch.Tensor:
    """The attention kernels' dropout seed as a uint32 word in device
    memory: an int32 tensor [1] on ``device`` holding ``seed`` mod 2³². A
    word passes through; under a capture's tape it is the graph's word for
    this seed, which the host rewrites before each replay."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int32 or seed.numel() != 1:
            raise ValueError(f"a seed word is an int32 tensor of one element, got "
                             f"{seed.dtype} {tuple(seed.shape)}")
        if seed.device != torch.device(device):
            raise ValueError(f"the seed word lies on {seed.device}, not {device}")
        return seed
    if _TAPE is not None:
        return _TAPE.word(seed, device)
    return _make_word(seed, device)


def seed_of(seed: Union[int, torch.Tensor], device=None) -> Union[int, torch.Tensor]:
    """``seed`` mod 2³² for the plain versions' int64 arithmetic: an int,
    or a 0-d int64 tensor on ``device`` from a seed word (no host sync)."""
    if isinstance(seed, torch.Tensor):
        return seed.reshape(()).to(device=device, dtype=torch.int64) & _M32
    return int(seed) & _M32
