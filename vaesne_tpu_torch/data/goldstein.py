"""Goldstein/ZTF npz data as batch tuples of tensors on one device.

The counterpart of ``vaesne_tpu/data/goldstein.py``. The whole standardised
dataset is placed on the device once (a few hundred MB at most), and each
training step gathers its batch there.

  spectra tuple    = (flux [N, 982] f32, wavelength [N, 982] f32,
                      phase [N] f32, mask [N, 982] bool)   True == missing
  photometry tuple = (flux [N, 60] f32, time [N, 60] f32,
                      band [N, 60] int64, mask [N, 60] bool)

The npz stores masks with 1 == observed; the builders convert with
``stored == 0``. Band indices become int64, the index type of
``nn.Embedding``. The builders put the tensors on ``device``, by default
the card (they raise without one unless ``device="cpu"``).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..training import resolve_device

Batch = Tuple

# the arrays of a Goldstein npz file
GOLDSTEIN_KEYS = (
    "training_idx", "testing_idx", "flux", "wavelength", "mask", "phase",
    "photoflux", "phototime", "photomask", "photowavelength", "identity",
)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _put(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def spectra_tuple(data: Dict[str, np.ndarray], idx: Optional[np.ndarray] = None,
                  device=None) -> Batch:
    """The spectra modality tuple on ``device``, mask converted to True ==
    missing."""
    device = resolve_device(device)
    sl = slice(None) if idx is None else idx
    return (
        _put(data["flux"][sl], torch.float32, device),
        _put(data["wavelength"][sl], torch.float32, device),
        _put(data["phase"][sl], torch.float32, device),
        _put(data["mask"][sl] == 0, torch.bool, device),
    )


def photometry_tuple(data: Dict[str, np.ndarray], idx: Optional[np.ndarray] = None,
                     device=None) -> Batch:
    """The photometry modality tuple on ``device``, mask converted to True
    == missing."""
    device = resolve_device(device)
    sl = slice(None) if idx is None else idx
    return (
        _put(data["photoflux"][sl], torch.float32, device),
        _put(data["phototime"][sl], torch.float32, device),
        _put(data["photowavelength"][sl], torch.int64, device),
        _put(data["photomask"][sl] == 0, torch.bool, device),
    )


def multimodal_tuple(data: Dict[str, np.ndarray], idx: Optional[np.ndarray] = None,
                     device=None) -> Batch:
    """(photometry, spectra): the MMVAE's modality order."""
    return (photometry_tuple(data, idx, device), spectra_tuple(data, idx, device))


def train_test_split(data: Dict[str, np.ndarray]):
    """(train_idx, test_idx) from the stored split."""
    return np.asarray(data["training_idx"]), np.asarray(data["testing_idx"])


def denormalize(a, mean, std):
    """Undo the standardisation, for metrics in physical units."""
    return a * std + mean


_SCI_FLOAT = re.compile(r"[-+]?\d*\.\d+e[-+]?\d+")


def get_goldstein_params(filename: str) -> np.ndarray:
    """The physical simulation parameters a Goldstein filename encodes as
    scientific-notation floats."""
    return np.array([float(v) for v in _SCI_FLOAT.findall(str(filename))])


def goldstein_labels(data: Dict[str, np.ndarray],
                     idx: Optional[np.ndarray] = None) -> np.ndarray:
    """[N, P] float32 labels parsed from ``data['identity']``; the
    per-column standardisation is left to the caller."""
    ids = data["identity"] if idx is None else data["identity"][idx]
    return np.stack([get_goldstein_params(i) for i in ids]).astype(np.float32)
