"""Modality VAEs and the multimodal VAE of the port."""

from .base_vae import BaseVAE, tile_leading
from .image import HostImgVAE
from .mmvae import MMVAE, PhotoSpecMMVAE
from .photometric import BrightPhotometricVAE, PhotometricVAE
from .spectra import BrightSpectraVAE, SpectraVAE

__all__ = ["BaseVAE", "BrightPhotometricVAE", "BrightSpectraVAE", "HostImgVAE", "MMVAE",
           "PhotoSpecMMVAE", "PhotometricVAE", "SpectraVAE", "tile_leading"]
