"""The plain reference of the evaluation suite and its metrics.

The suite runs the test set in chunks of ``chunk`` events (the last padded
by repeating the last event); chunk i draws from a generator seeded with
``fold_in(seed, i)``: K latents per event from the light-curve posterior,
then K from the spectrum posterior (a uniform draw of the chunk's shape
each); both decoders decode all 2K latents of an event. ``LC2spec`` is the
spectra decoder's means over the light curve's K latents, ``spec2spec``
over the spectrum's, ``LC2LC`` and ``spec2LC`` the light-curve decoder's;
the spectra are denormalised with the flux statistics and the light curves
with the photometric flux statistics. ``reconstruct`` computes these for a
few chosen events, ``lc2spec`` the ``LC2spec`` cell for the whole test
set; ``aggregate`` is the metrics' arithmetic (the reference's
``evaluation.py``) in numpy.
"""

from __future__ import annotations

import warnings
from typing import Dict, Sequence

import numpy as np
import torch

from . import rng
from .model import Net, flatten_latents, laplace_sample

PHASE_BUCKETS = (-10.0, 0.0, 10.0, 20.0, 30.0)
CELLS = ("LC2LC", "LC2spec", "spec2LC", "spec2spec")


def reconstruct(net: Net, photo, spec, events: Sequence[int], K: int, chunk: int, seed: int,
                norm: Dict[str, float], block_rows: int = 200) -> Dict[str, np.ndarray]:
    """{cell: [K, len(events), N]} of the test-set events ``events``
    (tensors photo, spec on the device hold the whole test set), float64."""
    if photo[0].shape[0] <= max(events):
        raise ValueError("an event outside the test set")
    d, device = net.d, photo[0].device
    out = {c: [] for c in CELLS}
    with torch.no_grad():
        for e in events:
            ci, j = divmod(e, chunk)
            g = rng.generator(rng.fold_in(seed, ci), device)
            shape = (K, chunk, d.latent_len, d.latent_dim)
            u = [torch.rand(shape, generator=g, device=device) for _ in range(2)]
            idx = torch.tensor([e], device=device)
            posts = [net.encode_photometry(*(a[idx] for a in photo)),
                     net.encode_spectrum(*(a[idx] for a in spec))]
            z = torch.cat([laplace_sample(loc, scale, ui[:, j:j + 1])
                           for (loc, scale), ui in zip(posts, u)], 0)  # [2K, 1, L, D]
            z = flatten_latents(z)
            for m, x in enumerate((photo, spec)):
                means = torch.cat([net.decode(m, x, zb, idx, zb.shape[0])
                                   for zb in z.split(block_rows)], 0)  # [2K, N]
                means = means.double().cpu().numpy()
                key = "flux" if m == 1 else "photoflux"
                means = means * norm[f"{key}_std"] + norm[f"{key}_mean"]
                name = "spec" if m == 1 else "LC"
                out[f"LC2{name}"].append(means[:K])
                out[f"spec2{name}"].append(means[K:])
    return {c: np.stack(v, 1) for c, v in out.items()}


def lc2spec(net: Net, photo, spec, K: int, chunk: int, seed: int, norm: Dict[str, float],
            block_rows: int = 200) -> np.ndarray:
    """``LC2spec`` [K, n, N] of every test-set event, float64: the spectra
    decoder's means over K latents from each light curve's posterior."""
    d, device = net.d, photo[0].device
    n = photo[0].shape[0]
    per_block = max(1, block_rows // K)
    out = []
    with torch.no_grad():
        for c0 in range(0, n, chunk):
            g = rng.generator(rng.fold_in(seed, c0 // chunk), device)
            u = torch.rand((K, chunk, d.latent_len, d.latent_dim), generator=g, device=device)
            for e0 in range(c0, min(n, c0 + chunk), per_block):
                idx = torch.arange(e0, min(n, c0 + chunk, e0 + per_block), device=device)
                loc, scale = net.encode_photometry(*(a[idx] for a in photo))
                j = e0 - c0
                z = laplace_sample(loc, scale, u[:, j:j + len(idx)])  # [K, b, L, D]
                means = net.decode(1, spec, flatten_latents(z), idx, K)  # row b·K + k
                out.append(means.double().cpu().numpy().reshape(len(idx), K, -1))
    means = np.concatenate(out, 0).transpose(1, 0, 2)
    return means * norm["flux_std"] + norm["flux_mean"]


def _metric(spectra, gt, alpha):
    mean = np.nanmean(spectra, axis=0)
    quantile = np.nanquantile if np.isnan(spectra).any() else np.quantile
    lw = quantile(spectra, q=alpha / 2, axis=0)
    hi = quantile(spectra, q=1.0 - alpha / 2, axis=0)
    return gt - mean, np.logical_and((gt - lw) > 0, (hi - gt) > 0), hi - lw


def aggregate(recon: np.ndarray, gt: np.ndarray, phase: np.ndarray, name: str = "mm",
              alpha: float = 0.1) -> Dict[str, np.ndarray]:
    """Per phase bucket (the phase rounded): residual mean and sd, coverage
    of the 1 − α band, width mean and sd (over all phases, as the
    published aggregation has it) and the MSE."""
    resi, cover, width = _metric(np.asarray(recon), np.asarray(gt), alpha)
    phase = np.round(np.asarray(phase))
    cols = {k: [] for k in ("resi_mean", "resi_sd", "coverage_mean", "width_mean", "width_sd",
                            "mse")}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for p in PHASE_BUCKETS:
            sel = phase == p
            cols["resi_mean"].append(np.nanmean(resi[sel, :], 0))
            cols["resi_sd"].append(np.nanstd(resi[sel, :], 0))
            cols["coverage_mean"].append(np.nanmean(1.0 * cover[sel, :], 0))
            cols["width_mean"].append(np.nanmean(width, 0))
            cols["width_sd"].append(np.nanstd(width, 0))
            cols["mse"].append(np.nanmean(resi[sel, :] ** 2))
    return {f"{name}_{k}": np.asarray(v) for k, v in cols.items()}
