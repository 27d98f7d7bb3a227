"""Quantitative Goldstein evaluation: residual / CI coverage / CI width / MSE
per phase bucket, in one chunked pass over the test set on the card.

The counterpart of ``vaesne_tpu/experiments/eval_goldstein.py``, replacing
the reference's 400-job SLURM array + aggregator
(cannon/test/goldstein/spect_cond_LC.py + evaluation.py + plot_metric.py):
the same ``reconstructions.npz`` and ``avg_metrics.npz`` layout and the 3x5
metric figure (best effort: without matplotlib it is skipped).

Usage:
  python -m vaesne_tpu_torch.experiments.eval_goldstein \\
      [data=/path.npz] [mm_ckpt=artifacts/ckpt_torch/goldstein_photospec_...] \\
      [spec_ckpt=...] [K=100] [out=./res] [predictive=1] [mesh=auto]

``mm_ckpt`` and ``spec_ckpt`` are the port's checkpoints (a JAX Orbax
checkpoint is refused; bridge it first, as ``artifacts/ckpt_torch/`` holds
the flagship's). In Python, ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..data import multimodal_tuple
from ..evaluation import evaluate_mmvae, mmvae_reconstruction_suite
from ..parallel.mesh import rank
from ..utils.checkpoint import restore_config, restore_params
from ..utils.config import PhotoSpectraMMVAEConfig, SpectraVAEConfig
from ..utils.weights import init_params
from .common import parse_cli, resolve_dataset, run_evaluation
from .train_photospectra import build_model as build_mmvae
from .train_spectra import build_model as build_specvae


CHUNK = 64  # events per chunk of the suite


def _restore(ckpt, model):
    """``model`` holding the parameters of the port checkpoint ``ckpt``,
    or, without one, seeded initial weights."""
    if ckpt:
        return restore_params(ckpt, model)
    return init_params(model, torch.Generator().manual_seed(0))


def _config_for(ckpt, default_cls):
    """The config a checkpoint was trained with (its ``config.json``), or
    the driver default when no checkpoint or no saved config is given: eval
    rebuilds the exact architecture, and raises ("trained as") for a
    checkpoint of another config class."""
    cfg = restore_config(ckpt, default_cls) if ckpt else None
    return cfg if cfg is not None else default_cls()


def main(argv=None, device=None):
    """Evaluate on ``device`` (default: the card), or on the ranks of
    ``mesh=`` (chunks of 64 events split over its data axis; rank 0 writes
    ``out``); returns the metrics."""
    argv = list(sys.argv[1:] if argv is None else argv)
    return run_evaluation(_run, argv, device, _parse(argv)["mesh"], CHUNK)


def _parse(argv):
    mm_ckpt = spec_ckpt = None
    K, out_dir, mesh_spec = 100, "./res", "auto"
    predictive = False
    rest = []
    for a in argv:
        if a.startswith("mm_ckpt="):
            mm_ckpt = a.split("=", 1)[1]
        elif a.startswith("spec_ckpt="):
            spec_ckpt = a.split("=", 1)[1]
        elif a.startswith("predictive="):
            # predictive=1: K draws sample the observed-point likelihood, so
            # coverage/width evaluate the model's calibrated predictive band
            # instead of the reference's latent-only spread
            predictive = a.split("=", 1)[1].lower() in ("1", "true", "yes")
        elif a.startswith("K="):
            K = int(a.split("=", 1)[1])
        elif a.startswith("out="):
            out_dir = a.split("=", 1)[1]
        elif a.startswith("mesh="):
            mesh_spec = a.split("=", 1)[1]
        else:
            rest.append(a)
    data_path, rest = parse_cli(rest)
    return dict(mm_ckpt=mm_ckpt, spec_ckpt=spec_ckpt, K=K, out=out_dir, mesh=mesh_spec,
                predictive=predictive, data=data_path)


def _run(argv, device, mesh):
    opts = _parse(argv)
    mm_ckpt, spec_ckpt, K, out_dir = opts["mm_ckpt"], opts["spec_ckpt"], opts["K"], opts["out"]
    predictive, data_path = opts["predictive"], opts["data"]
    data = resolve_dataset(data_path, "goldstein")
    te_idx = np.asarray(data["testing_idx"])
    test_batch = multimodal_tuple(data, idx=te_idx, device=device)

    mm_model = _restore(mm_ckpt, build_mmvae(_config_for(mm_ckpt, PhotoSpectraMMVAEConfig)))
    spec_only = None
    if spec_ckpt is not None:
        spec_only = _restore(spec_ckpt, build_specvae(_config_for(spec_ckpt, SpectraVAEConfig)))

    # physical phase + ground truth for metric bucketing (evaluation.py:16-37)
    phase_phys = (np.asarray(data["phase"])[te_idx] * float(data["phase_std"])
                  + float(data["phase_mean"]))
    gt_spectra = (np.asarray(data["flux"])[te_idx] * float(data["flux_std"])
                  + float(data["flux_mean"]))
    norm = {k: float(data[k]) for k in
            ("flux_mean", "flux_std", "photoflux_mean", "photoflux_std")}

    recs = mmvae_reconstruction_suite(
        mm_model, test_batch, K=K, seed=0, spec_only=spec_only, norm=norm, mesh=mesh,
        predictive=predictive, device=device)
    # reuse the (denormalized) reconstructions: one inference pass in all,
    # and the metrics in physical units
    metrics = evaluate_mmvae(mm_model, test_batch, phase_phys, gt_spectra, recs=recs)
    if rank() != 0:
        return metrics

    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "reconstructions.npz"), **recs)
    np.savez(os.path.join(out_dir, "avg_metrics.npz"), **metrics)
    for k, v in sorted(metrics.items()):
        if np.asarray(v).size <= 10:
            print(f"{k}: {np.asarray(v).ravel()}")
    try:
        from ..utils.plotting import plot_metric_grid

        plot_metric_grid(metrics, path=os.path.join(out_dir, "metrics.png"))
    except Exception as e:  # plotting is best effort (no matplotlib on the card's host)
        print(f"(metric figure skipped: {e})")
    print(f"wrote {out_dir}/avg_metrics.npz")
    return metrics


if __name__ == "__main__":
    main()
