"""Evaluation metrics of the port: residual / CI coverage / CI width / MSE
per phase.

The port's own copy of ``vaesne_tpu/evaluation/metrics.py``, which is numpy
only (the port imports nothing of the JAX package). Mirrored from the
reference's ``cannon/test/goldstein/evaluation.py``:
  * ``get_metric``  (evaluation.py:4-13): over the K posterior-sample axis,
    mean / α-quantile band (α = 0.1 → 90 % CI) vs ground truth →
    (residual, coverage, width)
  * ``aggr_phase``  (evaluation.py:16-37): bucket by phase ∈ {−10,0,10,20,30} d
    and aggregate (including the reference's width_mean aggregation over ALL
    phases — evaluation.py:32 uses the unbucketed ``width`` — preserved).

NaN-aware reductions match the reference's np.nanmean/np.nanquantile. One
departure from the JAX module, for speed and not for value: on a table
without NaNs the band comes from np.quantile, which gives np.nanquantile's
bits there without its Python loop over every (event, bin) column (seconds
for a K = 100 test set). These run on the host (numpy) over the arrays ``harness.py`` brings back
from the device, chunk by chunk.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np

PHASE_BUCKETS = (-10.0, 0.0, 10.0, 20.0, 30.0)  # evaluation.py:17


def get_metric(
    spectra: np.ndarray,  # [K, B, N] posterior-sample reconstructions
    gt: np.ndarray,  # [B, N]
    alpha_level: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    spectra = np.asarray(spectra)
    gt = np.asarray(gt)
    mean = np.nanmean(spectra, axis=0)
    quantile = np.nanquantile if np.isnan(spectra).any() else np.quantile
    lw = quantile(spectra, q=alpha_level / 2, axis=0)
    hi = quantile(spectra, q=1.0 - alpha_level / 2, axis=0)
    residual = gt - mean
    cover = np.logical_and((gt - lw) > 0, (hi - gt) > 0)
    width = hi - lw
    return residual, cover, width


def aggr_phase(
    resi: np.ndarray,
    cover: np.ndarray,
    width: np.ndarray,
    phase: np.ndarray,
    phases: Sequence[float] = PHASE_BUCKETS,
):
    """Returns (resi_mean, resi_sd, cover_mean, width_mean, width_sd, mse),
    each a list with one entry per phase bucket."""
    resi_mean, resi_sd, cover_mean, width_mean, width_sd, mse = ([] for _ in range(6))
    with warnings.catch_warnings():
        # An empty phase bucket yields NaN aggregates — the reference's
        # behavior for a test shard with no events at that phase; the
        # "Mean of empty slice" RuntimeWarning is just noise.
        warnings.filterwarnings("ignore", "Mean of empty slice")
        warnings.filterwarnings("ignore", "Degrees of freedom <= 0")
        for phase_i in phases:
            sel = phase == phase_i
            resi_ = resi[sel, :]
            cover_ = cover[sel, :]
            resi_mean.append(np.nanmean(resi_, 0))
            resi_sd.append(np.nanstd(resi_, 0))
            cover_mean.append(np.nanmean(1.0 * cover_, 0))
            # reference aggregates width over ALL phases (evaluation.py:32-33)
            width_mean.append(np.nanmean(width, 0))
            width_sd.append(np.nanstd(width, 0))
            mse.append(np.nanmean(resi_**2))
    return resi_mean, resi_sd, cover_mean, width_mean, width_sd, mse


def aggregate_metrics(
    recon_sets: Dict[str, np.ndarray],
    gts: Dict[str, np.ndarray],
    phase: np.ndarray,
    alpha_level: float = 0.1,
    phases: Sequence[float] = PHASE_BUCKETS,
) -> Dict[str, np.ndarray]:
    """The single-process replacement of the reference's 400-shard aggregator
    (evaluation.py:40-97): for each named reconstruction set compute
    per-phase residual/coverage/width/MSE and return one dict with the
    ``avg_metrics.npz`` key naming convention (``{name}_resi_mean`` etc.)."""
    out: Dict[str, np.ndarray] = {}
    phase_r = np.round(np.asarray(phase))
    for name, recon in recon_sets.items():
        resi, cover, width = get_metric(recon, gts[name], alpha_level)
        rm, rs, cm, wm, ws, mse = aggr_phase(resi, cover, width, phase_r, phases)
        out[f"{name}_resi_mean"] = np.asarray(rm)
        out[f"{name}_resi_sd"] = np.asarray(rs)
        out[f"{name}_coverage_mean"] = np.asarray(cm)
        out[f"{name}_width_mean"] = np.asarray(wm)
        out[f"{name}_width_sd"] = np.asarray(ws)
        out[f"{name}_mse"] = np.asarray(mse)
    return out


def regression_abs_error_in_sigma(
    pred: np.ndarray, target: np.ndarray, label_std: np.ndarray
) -> np.ndarray:
    """|error| in label-σ units, the parameter-regression metric
    (eval_paramregression.py:62-69)."""
    return np.abs(np.asarray(pred) - np.asarray(target)) / np.asarray(label_std)
