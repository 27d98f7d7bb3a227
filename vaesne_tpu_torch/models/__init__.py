"""Modality VAEs and the multimodal VAE of the port."""

from .base_vae import BaseVAE, tile_leading
from .mmvae import MMVAE, PhotoSpecMMVAE
from .photometric import PhotometricVAE
from .spectra import SpectraVAE

__all__ = ["BaseVAE", "MMVAE", "PhotoSpecMMVAE", "PhotometricVAE", "SpectraVAE",
           "tile_leading"]
