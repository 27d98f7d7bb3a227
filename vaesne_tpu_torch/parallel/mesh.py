"""The device mesh over ``torch.distributed``: mesh specs, process groups,
the launch of one process per rank, and each rank's slice of a batch.

The counterpart of ``vaesne_tpu/parallel/mesh.py``. The JAX package runs
one program over a ``jax.sharding.Mesh``; the port runs one process per
rank of a (data, model) mesh, rank = d·model + m, the JAX mesh's row-major
device order. Data parallelism is "the same program on a sharded batch":
every rank applies the same permutation, augmentation and posterior-noise
draws to the global batch and takes its slice (``shard_batch``), so a
data-parallel step gives the one-process loss to reduction noise.

    mesh = resolve_mesh("2", batch_size=16, device="cpu")  # two gloo ranks
    result = launch(fn, mesh, *args)  # fn on every rank; rank 0's result

Backends: NCCL where the ranks hold distinct CUDA devices; gloo on the CPU
and where ranks share a card (NCCL refuses two ranks on one device), as
``make_mesh(devices=["cuda:0", "cuda:0"])`` asks.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import tempfile
import time
import warnings
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..ops.partition import Shard
from ..training import _tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"
# Deadlines in seconds. GROUP_TIMEOUT: how long a collective waits for its
# peers (None: torch's default for the backend, 30 min for gloo).
# LAUNCH_TIMEOUT: how long a spawned launch waits for its ranks (None:
# as long as they run). A run that trains for hours needs both as they are;
# a test sets short ones, so that a hang fails it.
GROUP_TIMEOUT: Optional[float] = None
LAUNCH_TIMEOUT: Optional[float] = None


def _group_timeout(seconds: Optional[float]) -> Optional[datetime.timedelta]:
    return None if seconds is None else datetime.timedelta(seconds=seconds)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh: its sizes, the device of each rank
    (rank = d·model + m) and the process-group backend."""

    data: int
    model: int
    devices: Tuple[str, ...]
    backend: str

    @property
    def shape(self):
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model


def _backend(devices: Sequence[torch.device]) -> str:
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"a mesh holds CPU ranks or CUDA ranks, not both: {list(devices)}")
    return "nccl" if len(set(devices)) == len(devices) else "gloo"


def make_mesh(devices: Optional[Sequence[Any]] = None, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible card),
    all of them on the data axis unless ``data`` says otherwise. A device
    may repeat: its ranks then share it over gloo."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d
               for d in devices]
    n = len(devices)
    if data is None:
        data = n // model
    if data * model != n or n == 0:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(data, model, tuple(str(d) for d in devices), _backend(devices))


def parse_mesh_spec(spec) -> Optional[Tuple[int, int]]:
    """(data, model) of an explicit spec ``"N"`` or ``"DxM"``; None for
    ``none``/``off``/``1``/``""``; ``"auto"`` stays ``"auto"``."""
    s = str(spec).strip().lower()
    if s in ("none", "off", "1", ""):
        return None
    if s == "auto":
        return "auto"
    if "x" in s:
        data, model = (int(v) for v in s.split("x", 1))
    else:
        data, model = int(s), 1
    return data, model


def torchrun_world() -> int:
    """The world size of a process group set up around this process
    (``torchrun``'s environment or an initialized group), else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def resolve_mesh(spec: str = "auto", batch_size: Optional[int] = None,
                 device=None) -> Optional[Mesh]:
    """A config-level mesh spec as a Mesh, or None for one process:

      * ``"none"``/``"off"``/``"1"`` — one process;
      * ``"auto"`` — the ``torchrun`` world where one is set up, else every
        visible card (on ``device="cpu"``: one process). With
        ``batch_size`` the data axis is gcd(batch_size, that count), with a
        ``RuntimeWarning`` where that leaves ranks out;
      * ``"4"`` — four ranks on the data axis; ``"4x2"`` — (data=4,
        model=2), data parallelism times Megatron tensor parallelism.

    On ``device="cpu"`` an explicit spec gives that many gloo ranks on the
    CPU; on the card it needs as many cards and raises otherwise. Inside a
    rank (``launch``) a spec of that rank's mesh gives the rank's mesh."""
    parsed = parse_mesh_spec(spec)
    if parsed is None:
        return None
    cpu = device is not None and torch.device(device).type == "cpu"
    current = current_mesh()
    if parsed == "auto":
        world = torchrun_world()
        visible = world if world > 1 or cpu else torch.cuda.device_count()
        n = visible
        if batch_size is not None:
            n = math.gcd(int(batch_size), visible)
            if n < visible:
                warnings.warn(
                    f"mesh='auto': batch size {batch_size} does not divide the {visible} "
                    f"visible devices; training on {max(n, 1)} chip(s). Pick a batch "
                    f"divisible by the device count (or an explicit mesh spec) to use them "
                    f"all.", RuntimeWarning, stacklevel=2)
        if n <= 1:
            return None
        parsed = (n, 1)
    data, model = parsed
    if current is not None and (current.data, current.model) == (data, model):
        return current
    n = data * model
    if cpu:
        return make_mesh(["cpu"] * n, data, model)
    avail = torch.cuda.device_count()
    if n > avail:
        raise ValueError(f"mesh spec {spec!r} needs {n} devices, only {avail} visible")
    return make_mesh([f"cuda:{i}" for i in range(n)], data, model)


# -- this process's rank ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Rank:
    mesh: Mesh
    shard: Shard


_CURRENT: Optional[_Rank] = None


def current_mesh() -> Optional[Mesh]:
    """The mesh this process is a rank of (inside ``launch``), else None."""
    return None if _CURRENT is None else _CURRENT.mesh


def rank() -> int:
    """This process's rank on its mesh (0 outside ``launch``)."""
    return 0 if _CURRENT is None else _CURRENT.shard.rank


def shard_of(mesh: Mesh) -> Shard:
    """This rank's place on ``mesh``; raises outside a rank of it."""
    if _CURRENT is None or _CURRENT.mesh != mesh:
        raise ValueError(
            f"this process is not a rank of the {mesh.data}x{mesh.model} mesh: run the "
            f"mesh's work through parallel.launch (or under torchrun)")
    return _CURRENT.shard


def data_group(mesh: Mesh):
    """The group of this rank's model shard over the data axis (the
    gradient all-reduce's)."""
    return shard_of(mesh).data_group


def model_group(mesh: Mesh):
    """The group of this rank's event shard over the model axis (TP's)."""
    return shard_of(mesh).model_group


def rank_device(mesh: Mesh) -> torch.device:
    """The device of this rank."""
    return torch.device(mesh.devices[shard_of(mesh).rank])


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's slice of dim 0 of every array of ``batch`` (a nested
    tuple of tensors or numpy arrays): the d-th of ``data`` equal parts.
    Batch sizes must divide the data axis."""
    n_data = mesh.data

    def place(a):
        if a.shape[0] % n_data != 0:
            raise ValueError(f"batch dim {a.shape[0]} not divisible by data axis {n_data}")
        return a

    _tree_map(place, batch)
    d = shard_of(mesh).data_rank

    def take(a):
        size = a.shape[0] // n_data
        return a[d * size:(d + 1) * size]

    return _tree_map(take, batch)


def _groups(mesh: Mesh, r: int) -> Shard:
    """Build every data and model group (each rank builds all of them, in
    one order) and return rank ``r``'s shard."""
    import torch.distributed as dist

    d, m = divmod(r, mesh.model)
    world = dist.group.WORLD
    data_groups = [world if mesh.model == 1 else
                   dist.new_group([i * mesh.model + j for i in range(mesh.data)])
                   for j in range(mesh.model)]
    model_groups = [world if mesh.data == 1 else
                    dist.new_group([i * mesh.model + j for j in range(mesh.model)])
                    for i in range(mesh.data)]
    return Shard(d, mesh.data, m, mesh.model, data_groups[m], model_groups[d], r)


def _run_rank(r: int, fn: Callable, mesh: Mesh, args) -> Any:
    global _CURRENT
    _CURRENT = _Rank(mesh, _groups(mesh, r))
    try:
        return fn(*args)
    finally:
        _CURRENT = None


def _rank_entry(r: int, payload: bytes, mesh: Mesh, workdir: str,
                group_timeout: Optional[float]) -> None:
    """A spawned rank: join the group through a file store in ``workdir``,
    run the pickled ``(fn, args)`` and, on rank 0, save its result there.
    The arguments come pickled by value: torch.multiprocessing would hand
    every rank one shared-memory copy of each tensor, and the ranks' in-place
    updates would then meet."""
    import pickle

    import torch.distributed as dist

    fn, args = pickle.loads(payload)
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):  # the ranks share this host
        os.environ.setdefault(var, "lo")
    device = torch.device(mesh.devices[r])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // mesh.size)))
    dist.init_process_group(mesh.backend, init_method="file://" + os.path.join(workdir, "store"),
                            rank=r, world_size=mesh.size,
                            timeout=_group_timeout(group_timeout))
    try:
        result = _run_rank(r, fn, mesh, args)
        if r == 0:
            torch.save(result, os.path.join(workdir, "result.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, mesh: Mesh, *args) -> Any:
    """Run ``fn(*args)`` on every rank of ``mesh`` and return rank 0's
    result. Inside a rank of ``mesh``, or under ``torchrun`` with a world
    of the mesh's size, the current process runs its own rank in place
    (and gets its own result). Otherwise one process per rank is spawned
    (``torch.multiprocessing``, ``spawn``): ``fn`` and ``args`` must
    pickle, and the ranks join one group through a file store. A rank that
    raises, or ranks still running after ``LAUNCH_TIMEOUT`` seconds (where
    it is set), fail the launch; nothing is retried. Every group's
    collectives wait ``GROUP_TIMEOUT`` for their peers."""
    import torch.distributed as dist

    if _CURRENT is not None:
        if _CURRENT.mesh != mesh:
            raise ValueError(f"this process is already a rank of a {_CURRENT.mesh.data}x"
                             f"{_CURRENT.mesh.model} mesh, not of {mesh.data}x{mesh.model}")
        return fn(*args)
    world = torchrun_world()
    if world > 1:
        if world != mesh.size:
            raise ValueError(f"the process group has {world} ranks, the mesh "
                             f"{mesh.data}x{mesh.model} needs {mesh.size}")
        if not dist.is_initialized():
            dist.init_process_group(mesh.backend, timeout=_group_timeout(GROUP_TIMEOUT))
        r = dist.get_rank()
        if torch.device(mesh.devices[r]).type == "cuda":
            torch.cuda.set_device(torch.device(mesh.devices[r]))
        return _run_rank(r, fn, mesh, args)
    import pickle

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="vaesne_ranks_") as workdir:
        payload = pickle.dumps((fn, args))
        ctx = mp.start_processes(_rank_entry, args=(payload, mesh, workdir, GROUP_TIMEOUT),
                                 nprocs=mesh.size, join=False, start_method="spawn")
        timeout = LAUNCH_TIMEOUT
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"the {mesh.size} ranks of the {mesh.data}x{mesh.model} "
                                       f"mesh did not finish within {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return torch.load(os.path.join(workdir, "result.pt"), weights_only=False)


def to_host(tree):
    """A nest of dicts, lists and tuples with every tensor on the CPU (what
    a spawned rank is handed, and hands back), other leaves as they are."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree.cpu() if torch.is_tensor(tree) else tree


def replicate_state(state, mesh: Mesh):
    """Broadcast ``state``'s parameters and AdamW moments from rank 0 over
    the world, so every rank starts from rank 0's (a collective). Returns
    ``state``."""
    import torch.distributed as dist

    shard_of(mesh)
    for p in state.model.parameters():
        dist.broadcast(p.data, src=0)
    for entry in state.optimizer.state.values():
        for t in entry.values():
            if torch.is_tensor(t):
                dist.broadcast(t, src=0)
    return state


def shard_data_parallel(data: Any, state, mesh: Mesh):
    """(this rank's slice of ``data``, ``state`` replicated from rank 0)."""
    return shard_batch(data, mesh), replicate_state(state, mesh)
