"""Modality VAEs, the multimodal VAE, the contrastive towers and the
regression heads of the port."""

from .base_vae import BaseVAE, tile_leading
from .contrastive import ContraPhotSpec
from .image import HostImgVAE
from .mmvae import MMVAE, PhotoSpecMMVAE
from .photometric import BrightPhotometricVAE, PhotometricVAE
from .regression import (
    ContraPhotoRegressionHead,
    ContraSpecRegressionHead,
    PhotoEnd2EndRegression,
    SpecEnd2EndRegression,
    VAERegressionHead,
)
from .spectra import BrightSpectraVAE, SpectraVAE

__all__ = ["BaseVAE", "BrightPhotometricVAE", "BrightSpectraVAE", "ContraPhotSpec",
           "ContraPhotoRegressionHead", "ContraSpecRegressionHead", "HostImgVAE", "MMVAE",
           "PhotoEnd2EndRegression", "PhotoSpecMMVAE", "PhotometricVAE", "SpecEnd2EndRegression",
           "SpectraVAE", "VAERegressionHead", "tile_leading"]
