"""Data of the port: npz loaders into tensors on a device, augmentation on
the device, the synthetic Goldstein/ZTF and image generators, image files
and the npz validator."""

from .augment import (
    affine_warp,
    augment_images,
    augment_multimodal,
    augment_photometry,
    augment_spectra,
    random_affine,
    repeat_dataset,
)
from .goldstein import (
    denormalize,
    get_goldstein_params,
    goldstein_labels,
    load_npz,
    multimodal_tuple,
    photometry_tuple,
    spectra_tuple,
    train_test_split,
)
from .images import ImagePathDataset, image_tuple
from .synthetic import (
    LSST_BANDS,
    PHOTOMETRY_LENGTH,
    SPECTRUM_BINS,
    ZTF_BANDS,
    make_goldstein_like,
    make_images,
    make_ztf_like,
)
from .validate import validate_npz

__all__ = [
    "ImagePathDataset",
    "affine_warp",
    "augment_images",
    "image_tuple",
    "make_images",
    "random_affine",
    "augment_multimodal",
    "augment_photometry",
    "augment_spectra",
    "repeat_dataset",
    "denormalize",
    "get_goldstein_params",
    "goldstein_labels",
    "load_npz",
    "multimodal_tuple",
    "photometry_tuple",
    "spectra_tuple",
    "train_test_split",
    "validate_npz",
    "make_goldstein_like",
    "make_ztf_like",
    "LSST_BANDS",
    "PHOTOMETRY_LENGTH",
    "SPECTRUM_BINS",
    "ZTF_BANDS",
]
