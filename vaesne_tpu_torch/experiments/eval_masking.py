"""Robustness sweep: mask 0-90% of the light curve, cross-reconstruct spectra.

The counterpart of ``vaesne_tpu/experiments/eval_masking.py`` (reference:
cannon/test/goldstein/gradual_masking.py, missing portions {0,10,30,50,70,90}%
at :67, seed 42 at :83, and plot_masking.py), as one chunked pass per
portion on the card. Writes ``masking_sweep.npz`` (``portions``, ``mse``:
the LC→spectrum MSE over observed spectrum bins in physical units) and,
where matplotlib is installed, ``masking_sweep.png``.

Usage:
  python -m vaesne_tpu_torch.experiments.eval_masking [data=...] [mm_ckpt=...]
      [K=100] [out=./res] [mesh=auto] [model.latent_len=2 ...]

Config overrides apply on top of the checkpoint's config (for runs without
a checkpoint). In Python, ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..data import multimodal_tuple
from ..evaluation import masking_sweep
from ..parallel.mesh import rank
from ..utils.config import PhotoSpectraMMVAEConfig, parse_overrides
from .common import parse_cli, resolve_dataset, run_evaluation
from .eval_goldstein import _config_for, _restore
from .train_photospectra import build_model as build_mmvae


CHUNK = 32  # events per chunk of the sweep


def main(argv=None, device=None):
    """Sweep on ``device`` (default: the card), or on the ranks of
    ``mesh=`` (chunks of 32 events split over its data axis; rank 0 writes
    ``out``); returns {portion: MSE}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    return run_evaluation(_run, argv, device, _parse(argv)[3], CHUNK)


def _parse(argv):
    mm_ckpt, K, out_dir, mesh_spec = None, 100, "./res", "auto"
    rest = []
    for a in argv:
        if a.startswith("mm_ckpt="):
            mm_ckpt = a.split("=", 1)[1]
        elif a.startswith("K="):
            K = int(a.split("=", 1)[1])
        elif a.startswith("out="):
            out_dir = a.split("=", 1)[1]
        elif a.startswith("mesh="):
            mesh_spec = a.split("=", 1)[1]
        else:
            rest.append(a)
    data_path, rest = parse_cli(rest)
    return mm_ckpt, K, out_dir, mesh_spec, data_path, rest


def _run(argv, device, mesh):
    mm_ckpt, K, out_dir, _, data_path, rest = _parse(argv)
    data = resolve_dataset(data_path, "goldstein")
    te_idx = np.asarray(data["testing_idx"])
    test_batch = multimodal_tuple(data, idx=te_idx, device=device)

    # the config comes from the checkpoint's config.json (a latent-2 model,
    # say, the analog of the reference's --latlen sweep arm in
    # more_masking.sh); the remaining CLI overrides apply on top
    mm_cfg = parse_overrides(_config_for(mm_ckpt, PhotoSpectraMMVAEConfig), rest)
    mm_model = _restore(mm_ckpt, build_mmvae(mm_cfg))

    sweep = masking_sweep(mm_model, test_batch, K=K, chunk_size=CHUNK, mesh=mesh, device=device)

    flux_mean, flux_std = float(data["flux_mean"]), float(data["flux_std"])
    gt = np.asarray(data["flux"])[te_idx] * flux_std + flux_mean
    obs = ~test_batch[1][3].cpu().numpy()  # the mask is True where missing
    mses = {}
    for portion, recs in sweep.items():
        rec = recs * flux_std + flux_mean
        mses[portion] = float((((rec.mean(0) - gt) ** 2) * obs).sum() / obs.sum())
    if rank() != 0:
        return mses
    os.makedirs(out_dir, exist_ok=True)
    for portion, mse in mses.items():
        print(f"masking {int(portion * 100):2d}%: LC->spec MSE {mse:.6f}")
    np.savez(os.path.join(out_dir, "masking_sweep.npz"),
             portions=np.array(sorted(mses)),
             mse=np.array([mses[p] for p in sorted(mses)]))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        ps = sorted(mses)
        ax.plot([100 * p for p in ps], [mses[p] for p in ps], marker="o")
        ax.set_xlabel("% of observed light-curve points masked")
        ax.set_ylabel("LC->spec reconstruction MSE")
        ax.set_title("Cross-modal robustness to light-curve masking")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "masking_sweep.png"), dpi=120)
        plt.close(fig)
    except Exception as e:  # plotting is best effort (plot_masking.py analog)
        print(f"(masking figure skipped: {e})")
    print(f"wrote {out_dir}/masking_sweep.npz")
    return mses


if __name__ == "__main__":
    main()
