"""Data augmentation on the device, drawn from an explicit generator.

The counterpart of ``vaesne_tpu/data/augment.py``:

  * light curves and spectra: additive flux noise, σ = 0.02; one time
    shift per light curve, σ = 0.1, broadcast along the curve; extra random
    masking with probability 0.05;
  * images (NCHW): random horizontal and vertical flips, then a random
    rotation (±15°), scale (0.75–1.25) and whole-pixel translation (±5%)
    about the centre, resampled bilinearly with out-of-frame samples at
    ``fill`` (``affine_warp``).

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


AFFINE_DEGREES = 15.0
AFFINE_TRANSLATE = 0.05
AFFINE_SCALE = (0.75, 1.25)


def affine_warp(images: torch.Tensor, theta: torch.Tensor, scale: torch.Tensor,
                tx: torch.Tensor, ty: torch.Tensor, fill: float = -1.0) -> torch.Tensor:
    """Inverse-affine bilinear warp of an NCHW batch: rotation ``theta``
    (radians) and ``scale`` about the pixel centre ((H−1)/2, (W−1)/2), then
    a translation (``tx``, ``ty``) in pixels, all per image [B].

    Output pixel p samples the input at centre + R(−θ)(p − centre − t)/s,
    from the four neighbours of that point; each neighbour outside the frame
    contributes ``fill`` at its weight, as the JAX package's
    ``map_coordinates(order=1, mode="constant", cval=fill)`` does (the
    neighbours are summed in its order). ``grid_sample`` would pad with
    zeros and sample on another pixel grid, so the gather is written out."""
    b, c, h, w = images.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=images.device),
                            torch.arange(w, dtype=torch.float32, device=images.device),
                            indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    th, sc, dx, dy = (a.to(torch.float32)[:, None, None] for a in (theta, scale, tx, ty))
    cos, sin = torch.cos(th), torch.sin(th)
    xo, yo = xx - cx - dx, yy - cy - dy
    xi = cx + (cos * xo + sin * yo) / sc
    yi = cy + (-sin * xo + cos * yo) / sc
    flat = images.reshape(b, c, h * w)
    out = None
    for y_idx, wy in _linear_nodes(yi):
        for x_idx, wx in _linear_nodes(xi):
            valid = (y_idx >= 0) & (y_idx < h) & (x_idx >= 0) & (x_idx < w)
            idx = y_idx.clamp(0, h - 1) * w + x_idx.clamp(0, w - 1)
            vals = flat.gather(2, idx.reshape(b, 1, h * w).expand(b, c, h * w))
            vals = torch.where(valid[:, None], vals.reshape(b, c, h, w), fill)
            term = (wy * wx)[:, None] * vals
            out = term if out is None else out + term
    return out.to(images.dtype)


def _linear_nodes(coord: torch.Tensor):
    """[(floor index, its weight), (index + 1, its weight)] of linear
    interpolation at ``coord``."""
    lower = torch.floor(coord)
    upper_weight = coord - lower
    index = lower.to(torch.int64)
    return [(index, 1.0 - upper_weight), (index + 1, upper_weight)]


def _uniform(generator: torch.Generator, shape, low: float, high: float, device) -> torch.Tensor:
    return low + (high - low) * torch.rand(shape, generator=generator, device=device)


def random_affine(generator: torch.Generator, images: torch.Tensor,
                  degrees: float = AFFINE_DEGREES, translate: float = AFFINE_TRANSLATE,
                  scale: Tuple[float, float] = AFFINE_SCALE,
                  fill: float = -1.0) -> torch.Tensor:
    """A random rotation in ±``degrees``, scale in ``scale`` and translation
    in ±``translate`` of the image size, rounded to whole pixels, per image
    of an NCHW batch (torchvision's ``RandomAffine(degrees=15,
    translate=(0.05, 0.05), scale=(0.75, 1.25))``). ``fill`` −1 is black in
    the [−1, 1] range the images live in."""
    b, _, h, w = images.shape
    dev = images.device
    theta = torch.deg2rad(_uniform(generator, (b,), -degrees, degrees, dev))
    s = _uniform(generator, (b,), scale[0], scale[1], dev)
    t = _uniform(generator, (b, 2), -translate, translate, dev)
    return affine_warp(images, theta, s, torch.round(t[:, 0] * w), torch.round(t[:, 1] * h),
                       fill)


def augment_images(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Random horizontal and vertical flips (each with probability 0.5),
    then ``random_affine``, of an NCHW batch."""
    b = images.shape[0]
    do_h = torch.rand(b, generator=generator, device=images.device) < 0.5
    do_v = torch.rand(b, generator=generator, device=images.device) < 0.5
    flipped = torch.where(do_h[:, None, None, None], images.flip(-1), images)
    flipped = torch.where(do_v[:, None, None, None], flipped.flip(-2), flipped)
    return random_affine(generator, flipped)
