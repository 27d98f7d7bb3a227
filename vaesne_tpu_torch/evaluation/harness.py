"""Quantitative evaluation harness of the port: the test set in fixed-size
chunks on the card, or split over the ranks of a mesh.

The counterpart of ``vaesne_tpu/evaluation/harness.py``, mirroring the
reference's ``cannon/test/goldstein/`` scripts:
  * ``spect_cond_LC.py`` — full-test-set K=100 reconstructions (self + cross
    modal + unimodal baselines), denormalized (``mmvae_reconstruction_suite``)
  * ``evaluation.py``    — aggregation → ``avg_metrics.npz`` (``evaluate_mmvae``)
  * ``gradual_masking.py`` — robustness sweep masking 0–90 % of the light
    curve before cross-modal spectra reconstruction (``masking_sweep``)

Each chunk runs the model under ``torch.inference_mode`` on the device and
brings its outputs back as host numpy arrays, so the whole table (K = 100
draws of every test event) never has to stay on the card. Chunk i draws its
posterior noise from ``fold_in(seed, i)``: the K-sample bands are not
correlated across the test set. Every entry point runs on ``device``, by
default the card (it raises without one unless ``device="cpu"``). Under a
``mesh`` (inside ``parallel.launch``) each chunk's events are split over
the ranks and the outputs assembled on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import partition
from ..parallel.mesh import Mesh, rank_device, shard_batch, shard_of
from ..training import resolve_device, to_device
from ..utils.rng import device_generator, fold_in
from .metrics import aggregate_metrics


def _map(fn, *trees):
    """``fn`` over the leaves of equally structured dicts, tuples and lists."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, (tuple, list)):
        tree = tree[0]
    return tree


def _cat(parts, axis: int):
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts, axis=axis)
    return torch.cat(parts, dim=axis)


def _gather(leaf, axis: int, mesh: Mesh):
    """A rank's output leaf with every rank's events along ``axis``, as
    numpy where it came as numpy."""
    host = isinstance(leaf, np.ndarray)
    t = torch.from_numpy(leaf) if host else leaf
    if mesh.backend == "nccl":
        t = t.to(rank_device(mesh))
    out = partition.gather_events(t, axis, shard_of(mesh))
    return out.cpu().numpy() if host else out.to(leaf.device)


def batched_apply(
    fn: Callable,
    data,
    chunk_size: int,
    out_axes=0,
    mesh: Optional[Mesh] = None,
    unpad_to: Optional[int] = None,
    seed: Optional[int] = None,
):
    """Run ``fn`` over ``data`` (a nested tuple of tensors or numpy arrays
    with one leading event axis) in chunks of ``chunk_size`` events and
    concatenate each output leaf on its declared event axis.

    The last chunk is padded by repeating the last event, and the pad is cut
    from the result (to ``unpad_to`` events where given). ``out_axes`` states
    where the chunk's event axis sits in fn's outputs: an int for every leaf
    (0 for ``[chunk, ...]``, 1 for K-sample ``[K, chunk, ...]``), or a dict
    or tuple of ints matching fn's output. It is checked against each leaf,
    never guessed.

    With ``seed``, fn is called as ``fn(chunk, fold_in(seed, chunk_index))``
    so every chunk draws its own sample stream. ``mesh`` (a ``parallel``
    Mesh this process is a rank of; the drivers resolve their specs): each
    chunk's events are split over the data axis, which must divide
    ``chunk_size`` (``shard_batch``), fn runs this rank's part (its draws the
    rank's part of the whole chunk's, ``distributions.draw_events``), and
    the outputs are assembled on every rank."""
    shard = None
    n = _first_leaf(data).shape[0]
    rem = (-n) % chunk_size
    if rem:
        data = _map(lambda a: _cat([a, a[[n - 1] * rem]], 0), data)
    outs = []
    for ci, start in enumerate(range(0, n + rem, chunk_size)):
        chunk = _map(lambda a: a[start:start + chunk_size], data)
        if mesh is not None:
            chunk, shard = shard_batch(chunk, mesh), shard_of(mesh)
        with partition.sharded(shard):
            out = fn(chunk) if seed is None else fn(chunk, fold_in(seed, ci))
        if mesh is not None:
            axes = _map(lambda _: out_axes, out) if isinstance(out_axes, int) else out_axes
            out = _map(lambda axis, leaf: _gather(leaf, axis, mesh), axes, out)
        outs.append(out)

    if isinstance(out_axes, int):
        axis = out_axes
        out_axes = _map(lambda _: axis, outs[0])
    limit = n if unpad_to is None else unpad_to

    def cat(axis, *leaves):
        if leaves[0].shape[axis] != chunk_size:
            raise ValueError(
                f"batched_apply: out_axes declares batch axis {axis}, but output leaf has "
                f"shape {tuple(leaves[0].shape)} with size {leaves[0].shape[axis]} there "
                f"(chunk_size={chunk_size})")
        return _cat(list(leaves), axis)[(slice(None),) * axis + (slice(0, limit),)]

    return _map(cat, out_axes, *outs)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _unimodal(model, K: int, predictive: bool, device: torch.device):
    """The chunk function of a unimodal baseline: K reconstructions per
    event, as host numpy [K, chunk, ...]."""
    model = model.to(device).eval()

    def run(chunk, chunk_seed):
        with torch.inference_mode():
            return _host(model.reconstruct(chunk, K, predictive=predictive,
                                           generator=device_generator(chunk_seed, device)))
    return run


def mmvae_reconstruction_suite(
    mm_model,
    test_batch,  # (photometry tuple, spectra tuple), full test set
    K: int = 100,
    chunk_size: int = 64,
    seed: Optional[int] = None,
    mesh=None,
    photo_only=None,  # optional unimodal baseline models
    spec_only=None,
    norm: Optional[Dict[str, float]] = None,
    predictive: bool = False,
    device=None,
) -> Dict[str, np.ndarray]:
    """The spect_cond_LC.py output table in one pass over the test set.

    Returns the reference's npz-shard key layout (spect_cond_LC.py:114-137):
    LC2LC / spec2LC / LC2spec / spec2spec [K, B, ...] (+ LConly / speconly
    when the unimodal baselines are given) and the posterior means LCencode
    / specencode [B, ...], as numpy; the reconstructions are denormalized
    when ``norm`` provides {flux,photoflux}_mean/std.

    ``predictive=False`` holds K decoder MEANS per cell, whose spread is
    latent-only (the reference's semantics); ``predictive=True`` draws each
    from the observed-point likelihood instead. ``seed`` (default 0) seeds
    chunk i with ``fold_in(seed, i)``; the baselines take ``fold_in(seed,
    1)`` and ``fold_in(seed, 2)`` as theirs. The models move to ``device``
    in eval mode."""
    device = resolve_device(device)
    seed = 0 if seed is None else seed
    mm_model = mm_model.to(device).eval()
    test_batch = to_device(test_batch, device)

    def full_chunk(chunk, chunk_seed):
        with torch.inference_mode():
            recons = mm_model.reconstruct(chunk, K, predictive=predictive,
                                          generator=device_generator(chunk_seed, device))
            out = {"LC2LC": recons[0][0], "LC2spec": recons[0][1],
                   "spec2LC": recons[1][0], "spec2spec": recons[1][1],
                   "LCencode": mm_model.vaes[0].encode(chunk[0], mean=True),
                   "specencode": mm_model.vaes[1].encode(chunk[1], mean=True)}
            return {k: _host(v) for k, v in out.items()}

    # recon cells are [K, chunk, ...]; posterior means are [chunk, ...]
    axes = {"LC2LC": 1, "LC2spec": 1, "spec2LC": 1, "spec2spec": 1,
            "LCencode": 0, "specencode": 0}
    results = batched_apply(full_chunk, test_batch, chunk_size, out_axes=axes, mesh=mesh,
                            seed=seed)
    for name, model, m, offset in (("LConly", photo_only, 0, 1), ("speconly", spec_only, 1, 2)):
        if model is not None:
            results[name] = batched_apply(_unimodal(model, K, predictive, device),
                                          test_batch[m], chunk_size, out_axes=1, mesh=mesh,
                                          seed=fold_in(seed, offset))

    if norm:
        # spectra-valued outputs → flux stats; LC-valued → photoflux stats;
        # posterior means stay raw (spect_cond_LC.py:128-136)
        for k in ("LC2spec", "spec2spec", "speconly"):
            if k in results:
                results[k] = results[k] * norm.get("flux_std", 1.0) + norm.get("flux_mean", 0.0)
        for k in ("LC2LC", "spec2LC", "LConly"):
            if k in results:
                results[k] = (results[k] * norm.get("photoflux_std", 1.0)
                              + norm.get("photoflux_mean", 0.0))
    return results


def evaluate_mmvae(
    mm_model,
    test_batch,
    phase_physical: np.ndarray,
    gt_spectra: np.ndarray,
    gt_photometry: Optional[np.ndarray] = None,
    K: int = 100,
    chunk_size: int = 64,
    seed: Optional[int] = None,
    mesh=None,
    spec_only=None,
    recs: Optional[Dict[str, np.ndarray]] = None,
    predictive: bool = False,
    device=None,
) -> Dict[str, np.ndarray]:
    """Reconstructions → per-phase residual/coverage/width/MSE, the
    single-pass equivalent of spect_cond_LC.py + evaluation.py. ``gt_*``
    are in the same (physical or normalized) units as the reconstructions
    (``gt_photometry`` is unused, as in the JAX package). Pass ``recs`` (a
    prior ``mmvae_reconstruction_suite`` result) to skip the inference
    pass; ``predictive=True`` computes the coverage/width metrics over
    predictive draws (likelihood noise included)."""
    if recs is None:
        recs = mmvae_reconstruction_suite(
            mm_model, test_batch, K=K, chunk_size=chunk_size, seed=seed, mesh=mesh,
            spec_only=spec_only, predictive=predictive, device=device)
    sets = {"mm": recs["LC2spec"]}
    gts = {"mm": gt_spectra}
    if "speconly" in recs:
        sets["speconly"] = recs["speconly"]
        gts["speconly"] = gt_spectra
    return aggregate_metrics(sets, gts, phase_physical)


def mask_light_curve(photo, missing: float, seed: int):
    """``photo`` with each OBSERVED light-curve point flipped to masked
    with probability ``missing``, the draws from ``seed`` on the mask's
    device (gradual_masking.py:67-114)."""
    flux, time, band, mask = photo
    u = torch.rand(mask.shape, device=mask.device,
                   generator=device_generator(seed, mask.device))
    return flux, time, band, mask | (~mask & (u < missing))


def masking_sweep(
    mm_model,
    test_batch,
    missing_portions: Sequence[float] = (0.0, 0.1, 0.3, 0.5, 0.7, 0.9),
    K: int = 100,
    seed: Optional[int] = None,
    chunk_size: int = 32,
    mesh=None,
    device=None,
) -> Dict[float, np.ndarray]:
    """Robustness to light-curve masking (gradual_masking.py:67-114): flip
    an extra ``missing`` fraction of *observed* LC points to masked, then
    cross-reconstruct spectra (LC→spec). Returns {portion: [K, B, N]}
    decoder means, normalized, as numpy.

    ``seed`` defaults to 42 (gradual_masking.py:83); portion i flips from
    ``fold_in(fold_in(seed, i), 0)`` and reconstructs chunk j from
    ``fold_in(fold_in(fold_in(seed, i), 1), j)``."""
    device = resolve_device(device)
    seed = 42 if seed is None else seed
    mm_model = mm_model.to(device).eval()
    photo, spec = to_device(test_batch, device)

    def recon(batch, chunk_seed):
        with torch.inference_mode():
            return _host(mm_model.reconstruct(
                batch, K, generator=device_generator(chunk_seed, device))[0][1])

    out = {}
    for i, missing in enumerate(missing_portions):
        portion_seed = fold_in(seed, i)
        masked_photo = mask_light_curve(photo, missing, fold_in(portion_seed, 0))
        out[float(missing)] = batched_apply(recon, (masked_photo, spec), chunk_size,
                                            out_axes=1, mesh=mesh,
                                            seed=fold_in(portion_seed, 1))
    return out
