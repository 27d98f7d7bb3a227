"""Data augmentation on the device, drawn from an explicit generator.

The counterpart of ``vaesne_tpu/data/augment.py``'s light-curve and
spectra transforms:

  * additive flux noise, σ = 0.02;
  * one time shift per light curve, σ = 0.1, broadcast along the curve;
  * extra random masking with probability 0.05.

Each function draws from the ``torch.Generator`` it is given, which lives on
the data's device, never from torch's global generator; ``train_loop``
seeds one per epoch. The draws differ from the JAX package's (another
RNG); their distributions are the same, and at zero rates the output is
the input.
"""

from __future__ import annotations

from typing import Tuple

import torch

FLUX_NOISE = 0.02
TIME_SHIFT = 0.1
EXTRA_MASK_PROB = 0.05

Quad = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _normal(generator: torch.Generator, like: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.randn(like.shape if shape is None else shape, generator=generator,
                       dtype=like.dtype, device=like.device)


def _extra_mask(generator: torch.Generator, mask: torch.Tensor, prob: float) -> torch.Tensor:
    draw = torch.rand(mask.shape, generator=generator, device=mask.device)
    return mask | (draw < prob)


def augment_spectra(generator: torch.Generator, batch: Quad,
                    flux_noise: float = FLUX_NOISE,
                    extra_mask_prob: float = EXTRA_MASK_PROB) -> Quad:
    """(flux, wavelength, phase, mask) → noised flux, extra masking."""
    flux, wavelength, phase, mask = batch
    flux = flux + flux_noise * _normal(generator, flux)
    return flux, wavelength, phase, _extra_mask(generator, mask, extra_mask_prob)


def augment_photometry(generator: torch.Generator, batch: Quad,
                       flux_noise: float = FLUX_NOISE, time_shift: float = TIME_SHIFT,
                       extra_mask_prob: float = EXTRA_MASK_PROB) -> Quad:
    """(flux, time, band, mask) → noised flux, one time shift per curve,
    extra masking."""
    flux, time, band, mask = batch
    flux = flux + flux_noise * _normal(generator, flux)
    time = time + time_shift * _normal(generator, time, (time.shape[0], 1))
    return flux, time, band, _extra_mask(generator, mask, extra_mask_prob)


def augment_multimodal(generator: torch.Generator, batch, **kwargs):
    """((photometry), (spectra)), photometry drawn first."""
    return (augment_photometry(generator, batch[0], **kwargs),
            augment_spectra(generator, batch[1], **kwargs))


def repeat_dataset(batch, factor: int):
    """×factor repetition along the sample axis (the ZTF drivers'
    augmentation; the per-epoch draws make the copies differ). The copies
    are materialised on the data's device: ×10 for ZTF, a few hundred MB at
    most."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(repeat_dataset(b, factor) for b in batch)
    return torch.cat([batch] * factor, dim=0)
