"""Low-latency serving of a trained (MM)VAE on the card: bucketed batches.

The counterpart of ``vaesne_tpu/serving.py``. A request of B events is
padded on the host (by repeating its first event) up to the nearest bucket of
an ascending ladder, runs at that bucket's batch size, and the pad rows are
sliced off. Every op is per-event independent, so pad rows cannot perturb
real outputs. Requests of one size class therefore run at one fixed shape
per (task, static configuration, bucket); ``stats()`` counts the first run
of each such program as a compile and every later one as a hit.

    server = InferenceServer(model)                        # on "cuda"
    server = InferenceServer.from_checkpoint(ckpt_dir)     # a driver's checkpoint
    spec = server.crossmodal(photo_batch, spec_grids)      # LC → spectrum
    mean, lo, hi = server.crossmodal_ci(photo, grids, K=100)
    z = server.embed(photo_batch, modality=0)

The server runs on the card unless it is given ``device="cpu"``; it never
moves to the CPU by itself. Sampling draws from a per-call generator seeded
from a server-held chain (``seed``); pass ``generator=`` for a reproducible
call.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import partition

DEFAULT_BUCKETS = (8, 32, 128, 512)

# checkpoint ``_config_class`` tag → the driver whose build_model rebuilds
# its architecture; crossmodal and reconstruct need an MMVAE, embed serves
# any of them
_RESTORE_DISPATCH = {
    "PhotoSpectraMMVAEConfig": "train_photospectra",
    "ZTFMMVAEConfig": "train_ztf_photospect",
    "SpectraVAEConfig": "train_spectra",
    "ZTFSpectraConfig": "train_ztf_spectra",
    "PhotometryVAEConfig": "train_photometry",
}


def _pad_to(batch, size: int):
    """Pad every array's event axis up to ``size`` by repeating event 0, on
    the host (numpy)."""

    def pad(a):
        a_np = np.asarray(a)
        n = a_np.shape[0]
        if n == size:
            return a_np
        reps = np.broadcast_to(a_np[:1], (size - n,) + a_np.shape[1:])
        return np.concatenate([a_np, reps], axis=0)

    return tuple(pad(a) for a in batch)


def _quantile(x: torch.Tensor, qs: Sequence[float], dim: int = 0):
    """Quantiles along ``dim`` with linear interpolation between order
    statistics (``jnp.quantile``'s default), without ``torch.quantile``'s
    input-size limit."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    out = []
    for q in qs:
        pos = q * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        a, b = s.select(dim, lo), s.select(dim, hi)
        out.append(a + frac * (b - a))
    return out


class InferenceServer:
    """Serve a (MM)VAE ``model`` with bucketed batch shapes.

    The model is moved to ``device`` (default ``"cuda"``; raises where no
    CUDA device is present) and put in eval mode. ``precision`` is None or
    ``"fp32"`` (float32 throughout) or ``"bf16"`` (bfloat16 autocast over
    the float32 weights, scoped to each call).

    ``mesh`` (a ``parallel`` mesh this process is a rank of, on its device
    unless ``device`` says otherwise): every rank builds the server and
    takes every request. The parameters are broadcast from rank 0, each
    rank runs its event shard of the padded bucket (its draws its part of
    the whole bucket's), and the result is assembled on every rank. Every
    bucket must divide the data axis."""

    def __init__(self, model: torch.nn.Module, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, seed: int = 0,
                 precision: Optional[str] = None, device=None, mesh=None):
        if not buckets or sorted(buckets) != list(buckets):
            raise ValueError(f"buckets must be ascending, got {buckets}")
        if precision not in (None, "fp32", "bf16"):
            raise ValueError(
                f"precision must be None, 'fp32' or 'bf16', got {precision!r}")
        self._mesh, self._shard = mesh, None
        if mesh is not None:
            from .parallel.mesh import rank_device, shard_of

            bad = [b for b in buckets if b % mesh.data]
            if bad:
                raise ValueError(
                    f"buckets {bad} not divisible by the mesh data axis ({mesh.data}); every "
                    f"padded request must shard evenly over the event axis")
            self._shard = shard_of(mesh)
            if device is None:
                device = rank_device(mesh)
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceServer runs on a CUDA device and none is available; "
                "pass device='cpu' to serve on the CPU")
        self._device = device
        self._precision = precision
        self._model = model.to(device).eval()
        if mesh is not None:
            import torch.distributed as dist

            with torch.no_grad():
                for t in (*self._model.parameters(), *self._model.buffers()):
                    dist.broadcast(t, src=0)
        self._buckets = tuple(int(b) for b in buckets)
        self._programs: set = set()
        self._seeds = torch.Generator().manual_seed(seed)
        # concurrent requests: drawing a call's seed and the check-then-insert
        # on the program table must both be atomic
        self._lock = threading.Lock()
        self.hits = 0
        self.compiles = 0

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "InferenceServer":
        """Serve a checkpoint directory written by a training driver: its
        ``config.json``'s ``_config_class`` tag (the flagship's class where
        there is none) picks the driver whose ``build_model`` rebuilds the
        exact architecture, and the trained parameters are loaded into it.
        ``kwargs`` go to the constructor (``device``, ``buckets``, ...)."""
        import importlib

        from .utils.checkpoint import load_config, restore_config, restore_params
        from .utils.config import CONFIG_CLASSES

        name = (load_config(path) or {}).get("_config_class", "PhotoSpectraMMVAEConfig")
        if name not in _RESTORE_DISPATCH:
            raise ValueError(
                f"checkpoint at {path} was trained as {name}, which has no serving "
                f"dispatch entry; servable: {sorted(_RESTORE_DISPATCH)}")
        cfg = restore_config(path, CONFIG_CLASSES[name]) or CONFIG_CLASSES[name]()
        driver = importlib.import_module(f".experiments.{_RESTORE_DISPATCH[name]}",
                                         __package__)
        return cls(restore_params(path, driver.build_model(cfg)), **kwargs)

    @property
    def device(self) -> torch.device:
        return self._device

    # -- internals ---------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        raise ValueError(
            f"request of {n} events exceeds the largest serving bucket "
            f"{self._buckets[-1]}; split the request or construct the "
            f"server with larger buckets")

    def _program(self, name: str, static: tuple) -> None:
        """Count one run of the (task, static-config, bucket) program."""
        key = (name,) + static
        with self._lock:
            if key in self._programs:
                self.hits += 1
            else:
                self._programs.add(key)
                self.compiles += 1

    def _next_generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        if generator is not None:
            return generator
        with self._lock:
            seed = int(torch.randint(0, 2**62, (1,), generator=self._seeds))
        return torch.Generator(self._device).manual_seed(seed)

    def _place(self, batch, bucket: int):
        """Pad to the bucket on the host, keep this rank's events under a
        mesh, and move to the device: floats as float32, integers as int64
        (embedding indices), masks as bool."""

        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if t.dtype.is_floating_point:
                t = t.to(torch.float32)
            elif t.dtype != torch.bool:
                t = t.to(torch.int64)
            return t.to(self._device)

        padded = _pad_to(batch, bucket)
        if self._mesh is not None:
            from .parallel.mesh import shard_batch

            padded = shard_batch(padded, self._mesh)
        return tuple(put(a) for a in padded)

    def _run(self):
        """The model's scope for one call: inference, the precision and,
        under a mesh, this rank's shard."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        stack.enter_context(self._autocast())
        stack.enter_context(partition.sharded(self._shard))
        return stack

    def _whole(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """Every rank's events of ``t`` along ``axis`` (``t`` itself on one
        process)."""
        return partition.gather_events(t, axis, self._shard)

    def _autocast(self):
        return torch.autocast(self._device.type, dtype=torch.bfloat16,
                              enabled=self._precision == "bf16")

    def _require_mmvae(self, task: str):
        if not hasattr(self._model, "vaes"):
            raise ValueError(
                f"{task} needs a multimodal (MMVAE) model; this server holds "
                f"a unimodal {type(self._model).__name__}")

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    # -- tasks -------------------------------------------------------------

    def crossmodal(self, x_in, x_out, direction: Tuple[int, int] = (0, 1),
                   K: int = 1, generator: Optional[torch.Generator] = None,
                   predictive: bool = False) -> torch.Tensor:
        """Cross-modal generation (e.g. LC → spectrum): ``[K, B, grid]``
        decoder means on ``x_out``'s grids, or with ``predictive`` draws
        from the observed-point likelihood."""
        self._require_mmvae("crossmodal")
        n = np.shape(x_in[0])[0]
        g = self._next_generator(generator)
        bucket = self._bucket_for(n)
        self._program("crossmodal", (tuple(direction), K, bucket, predictive))
        with self._run():
            out = self._model.crossmodgen(
                self._place(x_in, bucket), self._place(x_out, bucket),
                direction=direction, K=K, predictive=predictive, generator=g)
            out = self._whole(out, 1)
        return out[:, :n]

    def crossmodal_ci(self, x_in, x_out, direction: Tuple[int, int] = (0, 1),
                      K: int = 100, alpha: float = 0.1,
                      generator: Optional[torch.Generator] = None,
                      predictive: bool = False):
        """(mean, lo, hi) over K draws: the mean and the alpha/2, 1 − alpha/2
        quantiles. ``predictive=False`` is the latent-only band (spread of
        decoder means); ``True`` samples each draw from the observed-point
        likelihood, a calibrated predictive band. Statistics are taken in
        float32 and returned in the draws' dtype."""
        self._require_mmvae("crossmodal_ci")
        n = np.shape(x_in[0])[0]
        g = self._next_generator(generator)
        bucket = self._bucket_for(n)
        self._program("crossmodal_ci", (tuple(direction), K, alpha, bucket, predictive))
        with self._run():
            draws = self._model.crossmodgen(
                self._place(x_in, bucket), self._place(x_out, bucket),
                direction=direction, K=K, predictive=predictive, generator=g)
            d32 = draws.float()
            lo, hi = _quantile(d32, (alpha / 2, 1 - alpha / 2), dim=0)
            mean = d32.mean(0)
            stats = [self._whole(t, 0) for t in (mean, lo, hi)]
        return tuple(t[:n].to(draws.dtype) for t in stats)

    def embed(self, x, modality: int = 0) -> torch.Tensor:
        """Posterior-mean embeddings ``[B, latent_len, latent_dim]`` of one
        modality."""
        n = np.shape(x[0])[0]
        bucket = self._bucket_for(n)
        self._program("embed", (modality, bucket))
        vae = self._model.vaes[modality] if hasattr(self._model, "vaes") else self._model
        with self._run():
            return self._whole(vae.encode(self._place(x, bucket)), 0)[:n]

    def reconstruct(self, x, K: int = 1, generator: Optional[torch.Generator] = None):
        """M×M matrix of posterior-mean reconstructions, numpy [K, B, ...]."""
        self._require_mmvae("reconstruct")
        n = np.shape(x[0][0])[0]
        g = self._next_generator(generator)
        bucket = self._bucket_for(n)
        self._program("reconstruct", (K, bucket))
        with self._run():
            out = self._model.reconstruct(tuple(self._place(m, bucket) for m in x),
                                          K, generator=g)
            out = [[self._whole(col, 1) for col in row] for row in out]
        return [[col[:, :n].float().cpu().numpy() for col in row] for row in out]

    def prewarm(self, example, tasks: Optional[Sequence[str]] = None,
                buckets: Optional[Sequence[int]] = None, Ks: Sequence[int] = (100,),
                directions: Sequence[Tuple[int, int]] = ((0, 1), (1, 0)),
                alpha: float = 0.1, predictive: Sequence[bool] = (False,),
                log: bool = False) -> Dict[str, float]:
        """Run every (task × bucket × K × direction) program once before the
        first real request (this builds the kernels and warms the caching
        allocator). ``example`` is a multimodal batch ``(photo, spec)`` (a
        unimodal tuple for a unimodal model) with ≥ 1 event; event 0 is
        repeated to every bucket size. Returns {program label: seconds},
        each timed to device completion."""
        multimodal = hasattr(self._model, "vaes")
        if tasks is None:
            tasks = (("crossmodal", "crossmodal_ci", "embed", "reconstruct")
                     if multimodal else ("embed",))
        bad = [t for t in tasks
               if t in ("crossmodal", "crossmodal_ci", "reconstruct") and not multimodal]
        if bad:
            raise ValueError(
                f"tasks {bad} need an MMVAE; this server holds a unimodal "
                f"{type(self._model).__name__}")
        buckets = self._buckets if buckets is None else tuple(buckets)
        unknown = [b for b in buckets if b not in self._buckets]
        if unknown:
            raise ValueError(
                f"prewarm buckets {unknown} are not server buckets "
                f"{self._buckets}; an off-ladder program would never be hit")
        if multimodal:
            one = tuple(tuple(np.asarray(a)[:1] for a in m) for m in example)
        else:
            one = tuple(np.asarray(a)[:1] for a in example)
        modalities = range(len(self._model.vaes)) if multimodal else (0,)
        timings: Dict[str, float] = {}

        def run(label, fn):
            t0 = time.perf_counter()
            fn()
            self._sync()
            timings[label] = round(time.perf_counter() - t0, 3)
            if log:
                print(f"prewarm {label}: {timings[label]:.3f}s")

        for b in buckets:
            padded = (tuple(_pad_to(m, b) for m in one) if multimodal
                      else _pad_to(one, b))
            for task in tasks:
                if task == "embed":
                    for m in modalities:
                        x = padded[m] if multimodal else padded
                        run(f"embed[m={m},b={b}]",
                            lambda x=x, m=m: self.embed(x, modality=m))
                elif task == "reconstruct":
                    for K in Ks:
                        run(f"reconstruct[K={K},b={b}]",
                            lambda K=K: self.reconstruct(padded, K=K))
                elif task in ("crossmodal", "crossmodal_ci"):
                    fn = self.crossmodal if task == "crossmodal" else self.crossmodal_ci
                    extra = {} if task == "crossmodal" else {"alpha": alpha}
                    for e, d in directions:
                        for K in Ks:
                            for p in predictive:
                                run(f"{task}[{e}->{d},K={K},b={b},pred={p}]",
                                    lambda e=e, d=d, K=K, p=p: fn(
                                        padded[e], padded[d], direction=(e, d),
                                        K=K, predictive=p, **extra))
                else:
                    raise ValueError(f"unknown prewarm task {task!r}")
        return timings

    def stats(self) -> Dict[str, int]:
        return {"programs": len(self._programs), "compiles": self.compiles,
                "hits": self.hits}
