"""Evaluate parameter-regression heads: |error| in label-sigma units.

The counterpart of ``vaesne_tpu/experiments/eval_regression.py``
(reference: cannon/test/goldstein/eval_paramregression.py): the residuals
of a head on the test split, in units of the training labels' standard
deviation, written as ``avg_absdiff_{modality}2goldstein_param_{backbone}.npz``
(``absdiff`` [N, 4], its ``mean`` and ``per_param`` over events).

Usage:
  python -m vaesne_tpu_torch.experiments.eval_regression modality=photometry \\
      backbone=mmvae head_ckpt=artifacts/ckpt_torch/goldstein_photometry2param_mmvae \\
      [train.ckpt_dir=artifacts/ckpt_torch] [data=...] [out=./res] [mesh=auto]

``head_ckpt`` is a port checkpoint of the whole head (``train_regression``
writes one; a parameters-only bridged one serves as well); without it a
freshly initialised head over a fresh backbone is evaluated. The label
standardisation is read from ``{train.ckpt_dir}/goldstein_normalizing.json``
where it exists, else recomputed from the training split. In Python,
``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..data import goldstein_labels, photometry_tuple, spectra_tuple
from ..evaluation.harness import batched_apply
from ..parallel.mesh import rank
from ..utils.checkpoint import restore_params
from ..utils.config import RegressionConfig, parse_overrides
from ..utils.weights import init_params
from .common import parse_cli, resolve_dataset, run_evaluation
from .train_regression import (
    NORMALIZING_FILE,
    build_head,
    label_normalization,
    parse_regression_cli,
)

CHUNK = 256  # events per call of the head


def main(argv=None, device=None):
    """Evaluate on ``device`` (default: the card), or on the ranks of
    ``mesh=`` (chunks of 256 events split over its data axis; rank 0 writes
    ``out``); returns absdiff [N, P]."""
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, _ = parse_regression_cli(argv, "modality", "backbone", "head_ckpt", "out", "mesh")
    return run_evaluation(_run, argv, device, opts.get("mesh", "auto"), CHUNK)


def _run(argv, device, mesh):
    opts, rest = parse_regression_cli(argv, "modality", "backbone", "head_ckpt", "out", "mesh")
    modality = opts.get("modality", "photometry")
    backbone = opts.get("backbone", "mmvae")
    head_ckpt, out_dir = opts.get("head_ckpt"), opts.get("out", "./res")
    data_path, rest = parse_cli(rest)
    cfg = parse_overrides(RegressionConfig(), rest)

    data = resolve_dataset(data_path, "goldstein")
    tr_idx = np.asarray(data["training_idx"])
    te_idx = np.asarray(data["testing_idx"])
    norm_file = os.path.join(cfg.train.ckpt_dir, NORMALIZING_FILE)
    if os.path.exists(norm_file):
        with open(norm_file) as f:
            d = json.load(f)
        mean, std = np.asarray(d["mean"]), np.asarray(d["std"])
    else:
        mean, std = label_normalization(goldstein_labels(data, tr_idx))
    te_labels = (goldstein_labels(data, te_idx) - mean) / std

    builder = photometry_tuple if modality == "photometry" else spectra_tuple
    x_test = builder(data, idx=te_idx, device=device)
    head, frozen = build_head(modality, backbone, None, 0, cfg)
    if head_ckpt:
        # the train driver checkpoints the whole head, backbone included
        restore_params(head_ckpt, head)
    else:
        # smoke mode: a fresh head over the fresh backbone
        init_params(head, torch.Generator().manual_seed(0))
        head.load_state_dict(frozen or {}, strict=False)
    head = head.to(device).eval()

    with torch.inference_mode():
        pred = batched_apply(head, x_test, chunk_size=CHUNK, out_axes=0, mesh=mesh)
    absdiff = np.abs(pred.float().cpu().numpy() - te_labels)  # already in sigma units
    if rank() != 0:
        return absdiff

    os.makedirs(out_dir, exist_ok=True)
    out_name = f"avg_absdiff_{modality}2goldstein_param_{backbone}.npz"
    np.savez(os.path.join(out_dir, out_name),
             absdiff=absdiff, mean=absdiff.mean(0), per_param=absdiff.mean(0))
    print(f"|error|/sigma per param: {absdiff.mean(0)}")
    print(f"wrote {out_dir}/{out_name}")
    return absdiff


if __name__ == "__main__":
    main()
