"""Validate an npz file against the Goldstein/ZTF data contract.

The port's own copy of ``vaesne_tpu/data/validate.py``: the same checks and
the same problem messages, so a file is accepted or refused alike by both
packages. From the shell::

    python -m vaesne_tpu_torch.data.validate /path/to/file.npz [--kind ztf]

prints a report and exits non-zero on a violation; from Python::

    problems = validate_npz(np.load(path), kind="goldstein")

The checks are numpy on the host; nothing touches a device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# measurement arrays every loader indexes, and the normalisation scalars
# the evaluation drivers denormalise with
REQUIRED_KEYS = (
    "training_idx", "testing_idx",
    "flux", "wavelength", "mask", "phase",
    "photoflux", "phototime", "photomask", "photowavelength",
)
NORM_KEYS = tuple(
    f"{k}_{s}"
    for k in ("flux", "wavelength", "phase", "phototime", "photoflux")
    for s in ("mean", "std")
)
# extra normalisation scalars only the ZTF drivers read
ZTF_NORM_KEYS = tuple(
    f"{k}_{s}"
    for k in ("spectime", "combined", "combined_time")
    for s in ("mean", "std")
)


def _check_grid(problems, data, flux_key, grid_key, mask_key):
    """flux/grid/mask triple: same [N, L] shape, {0,1} stored mask, finite
    values wherever the mask says observed."""
    flux, grid, mask = data[flux_key], data[grid_key], data[mask_key]
    if flux.ndim != 2:
        problems.append(f"{flux_key}: expected [N, L], got shape {flux.shape}")
        return
    for k, a in ((grid_key, grid), (mask_key, mask)):
        if a.shape != flux.shape:
            problems.append(
                f"{k}: shape {a.shape} != {flux_key} shape {flux.shape}")
    if mask.shape == flux.shape:
        vals = np.unique(mask)
        if not np.isin(vals, (0, 1)).all():
            problems.append(
                f"{mask_key}: stored mask must be 0/1 (1 = observed, the "
                f"reference convention at test_photospectra.py:36); found "
                f"values {vals[:8].tolist()}")
        else:
            observed = np.asarray(mask) == 1
            for k, a in ((flux_key, flux), (grid_key, grid)):
                if a.shape == flux.shape and not np.isfinite(
                        np.asarray(a, np.float64)[observed]).all():
                    problems.append(
                        f"{k}: non-finite values at observed (mask==1) "
                        "positions")
            if not observed.any():
                problems.append(f"{mask_key}: no observed points anywhere")


def validate_npz(data: Dict[str, np.ndarray], kind: str = "goldstein") -> List[str]:
    """The list of contract violations (empty: valid). ``kind`` is
    ``"goldstein"`` or ``"ztf"`` (which adds the ZTF normalisation
    scalars); ``data`` is any mapping of names to arrays."""
    if kind not in ("goldstein", "ztf"):
        raise ValueError(f"kind must be 'goldstein' or 'ztf', got {kind!r}")
    problems: List[str] = []
    required = REQUIRED_KEYS + NORM_KEYS + (ZTF_NORM_KEYS if kind == "ztf" else ())
    missing = [k for k in required if k not in data]
    if missing:
        problems.append(f"missing keys: {missing}")
    if any(k not in data for k in REQUIRED_KEYS):
        return problems  # the shape checks below need the measurement arrays

    _check_grid(problems, data, "flux", "wavelength", "mask")
    _check_grid(problems, data, "photoflux", "phototime", "photomask")

    n = data["flux"].shape[0]
    for k in ("photoflux", "phase"):
        if data[k].shape[0] != n:
            problems.append(
                f"{k}: {data[k].shape[0]} events but flux has {n} — all "
                "modalities must be index-aligned (multimodalDataset zips "
                "them positionally, data_util.py:10-20)")
    if data["phase"].ndim != 1:
        problems.append(f"phase: expected [N], got shape {data['phase'].shape}")

    band = data["photowavelength"]
    if band.shape != data["photoflux"].shape:
        problems.append(
            f"photowavelength: shape {band.shape} != photoflux shape "
            f"{data['photoflux'].shape} (band index per photometry point, "
            "test_photospectra.py:46)")
    if not np.issubdtype(band.dtype, np.integer):
        if not np.array_equal(band, np.round(band)):
            problems.append(
                "photowavelength: band indices must be integral (int64 class "
                "indices into the band embedding, PhotometricVAE.py:158)")
    if band.size and int(np.asarray(band).min()) < 0:
        problems.append("photowavelength: negative band index")

    for idx_key in ("training_idx", "testing_idx"):
        idx = np.asarray(data[idx_key])
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            problems.append(
                f"{idx_key}: indices out of range [0, {n}) "
                f"(min {idx.min()}, max {idx.max()})")
        if len(np.unique(idx)) != idx.size:
            problems.append(f"{idx_key}: duplicate indices")
    tr = set(np.asarray(data["training_idx"]).tolist())
    te = set(np.asarray(data["testing_idx"]).tolist())
    if tr & te:
        problems.append(
            f"training_idx/testing_idx overlap on {len(tr & te)} events")

    for k in NORM_KEYS + (ZTF_NORM_KEYS if kind == "ztf" else ()):
        if k in data:
            v = np.asarray(data[k])
            if v.size != 1:
                problems.append(f"{k}: expected a scalar, got shape {v.shape}")
            elif not np.isfinite(float(v)):
                # NaN passes a plain `<= 0` check and would NaN every
                # denormalised output
                problems.append(f"{k}: non-finite value {float(v)}")
            elif k.endswith("_std") and not (float(v) > 0):
                problems.append(f"{k}: std must be positive, got {float(v)}")
    return problems


def _num_bands(data) -> int:
    return int(np.asarray(data["photowavelength"]).max()) + 1


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="Validate an npz against the VAESNe data contract")
    p.add_argument("path")
    p.add_argument("--kind", choices=("goldstein", "ztf"), default="goldstein")
    args = p.parse_args(argv)

    with np.load(args.path) as f:
        data = {k: f[k] for k in f.files}
    problems = validate_npz(data, kind=args.kind)
    if problems:
        print(f"INVALID ({len(problems)} problem(s)):")
        for msg in problems:
            print(f"  - {msg}")
        return 1
    n = data["flux"].shape[0]
    print(
        f"OK: {n} events ({len(data['training_idx'])} train / "
        f"{len(data['testing_idx'])} test), spectra [{n}, "
        f"{data['flux'].shape[1]}], photometry [{n}, "
        f"{data['photoflux'].shape[1]}] over {_num_bands(data)} bands")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
