"""Synthetic Goldstein- and ZTF-shaped data, in numpy.

The port's own copy of ``vaesne_tpu/data/synthetic.py`` (its
``make_goldstein_like``, ``make_ztf_like`` and ``make_images``): the same
seed gives bitwise-equal arrays in both packages. The dict honours the npz key
contract the loaders read:

  Goldstein keys: training_idx, testing_idx, flux, wavelength, mask, phase,
    photoflux, phototime, photomask, photowavelength (= band), identity,
    {flux,wavelength,phase,phototime,photoflux}_{mean,std}
  Stored masks: 1 = observed (``goldstein`` converts to True = missing).

Spectra have 982 wavelength bins, light curves 60 points in 6 LSST bands
(2 for ZTF), all standardised like the preprocessed data.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

SPECTRUM_BINS = 982
PHOTOMETRY_LENGTH = 60
LSST_BANDS = 6
ZTF_BANDS = 2
PHASES = np.array([-10.0, 0.0, 10.0, 20.0, 30.0])


def _light_curve(rng, t, band, num_bands, stretch_scale=1.0):
    """SN-Ia-like rise/decline pulse, band-dependent amplitude and stretch."""
    t0 = rng.normal(0.0, 5.0)
    stretch = rng.uniform(8.0, 15.0) * stretch_scale
    amp = 1.0 + 0.2 * rng.standard_normal(num_bands)
    color = np.linspace(-0.3, 0.3, num_bands)
    tt = (t - t0) / stretch
    rise = np.exp(-np.clip(-tt, 0, 50) * 3.0)
    decline = np.exp(-np.clip(tt, 0, 50) * 0.7)
    return amp[band] * rise * decline + color[band] * 0.1


def _spectrum(rng, wl_grid, phase, temp=None):
    """Continuum + a few absorption features drifting with phase."""
    if temp is None:
        temp = rng.uniform(0.6, 1.4)
    cont = np.exp(-0.5 * ((wl_grid - 0.2 * temp) / (0.8 + 0.1 * phase / 30)) ** 2)
    spec = cont.copy()
    for _ in range(4):
        center = rng.uniform(-1.5, 1.5) + 0.01 * phase
        width = rng.uniform(0.02, 0.08)
        depth = rng.uniform(0.1, 0.5)
        spec -= depth * cont * np.exp(-0.5 * ((wl_grid - center) / width) ** 2)
    return spec


def make_goldstein_like(
    n: int = 256,
    seed: int = 0,
    spectrum_bins: int = SPECTRUM_BINS,
    photometry_length: int = PHOTOMETRY_LENGTH,
    num_bands: int = LSST_BANDS,
    train_fraction: float = 0.8,
    noise: float = 0.02,
) -> Dict[str, np.ndarray]:
    """An in-memory dict with the Goldstein npz key contract: per event one
    spectrum at a phase drawn around {−10, 0, 10, 20, 30} d and one
    multi-band light curve with an observation mask."""
    rng = np.random.default_rng(seed)
    wl_grid = np.linspace(-2.0, 2.0, spectrum_bins)

    flux = np.zeros((n, spectrum_bins), np.float32)
    wavelength = np.tile(wl_grid[None], (n, 1)).astype(np.float32)
    mask = np.zeros((n, spectrum_bins), np.int8)
    phase = np.zeros(n, np.float32)

    photoflux = np.zeros((n, photometry_length), np.float32)
    phototime = np.zeros((n, photometry_length), np.float32)
    photomask = np.zeros((n, photometry_length), np.int8)
    photoband = np.zeros((n, photometry_length), np.int64)
    # unicode, not object: np.savez of an object array would need
    # allow_pickle to load again
    identity = np.empty(n, "<U96")

    # per-event physical parameters, encoded in the identity filename as the
    # regression labels, and driving the curves
    n_events = (n + 4) // 5
    ev_mass = rng.uniform(0.8, 1.4, n_events)
    ev_energy = rng.uniform(0.5, 2.0, n_events)
    ev_kinetic = rng.uniform(0.05, 0.5, n_events)
    ev_radius = rng.uniform(0.1, 3.0, n_events)

    for i in range(n):
        ev = i // 5  # ~5 spectra per event
        identity[i] = (
            f"goldstein_m{ev_mass[ev]:.4e}_e{ev_energy[ev]:.4e}"
            f"_k{ev_kinetic[ev]:.4e}_r{ev_radius[ev]:.4e}.h5"
        )
        p = PHASES[i % len(PHASES)] + rng.normal(0, 0.5)
        phase[i] = p
        spec = _spectrum(rng, wl_grid, p, temp=0.7 + 0.5 * ev_energy[ev])
        flux[i] = spec + noise * rng.standard_normal(spectrum_bins)
        # observed wavelength window (instrument coverage)
        lo, hi = sorted(rng.uniform(0, spectrum_bins, size=2).astype(int))
        hi = max(hi, lo + spectrum_bins // 2)
        obs = np.zeros(spectrum_bins, bool)
        obs[lo:hi] = True
        mask[i] = obs.astype(np.int8)  # stored 1 = observed

        t = np.sort(rng.uniform(-30, 60, photometry_length))
        band = rng.integers(0, num_bands, photometry_length)
        photoflux[i] = ev_mass[ev] * _light_curve(
            rng, t, band, num_bands, stretch_scale=ev_radius[ev] * 0.3 + 0.9
        ) + noise * rng.standard_normal(photometry_length)
        phototime[i] = t
        photoband[i] = band
        photomask[i] = (rng.uniform(size=photometry_length) < 0.8).astype(np.int8)

    def standardize(a):
        mean, std = float(a.mean()), float(a.std()) + 1e-8
        return ((a - mean) / std).astype(np.float32), np.float32(mean), np.float32(std)

    flux, flux_mean, flux_std = standardize(flux)
    wavelength, wavelength_mean, wavelength_std = standardize(wavelength)
    phase, phase_mean, phase_std = standardize(phase)
    photoflux, photoflux_mean, photoflux_std = standardize(photoflux)
    phototime, phototime_mean, phototime_std = standardize(phototime)

    perm = rng.permutation(n)
    n_train = int(n * train_fraction)

    return {
        "training_idx": perm[:n_train],
        "testing_idx": perm[n_train:],
        "flux": flux,
        "wavelength": wavelength,
        "mask": mask,
        "phase": phase,
        "photoflux": photoflux,
        "phototime": phototime,
        "photomask": photomask,
        "photowavelength": photoband,
        "identity": identity,
        "flux_mean": flux_mean,
        "flux_std": flux_std,
        "wavelength_mean": wavelength_mean,
        "wavelength_std": wavelength_std,
        "phase_mean": phase_mean,
        "phase_std": phase_std,
        "phototime_mean": phototime_mean,
        "phototime_std": phototime_std,
        "photoflux_mean": photoflux_mean,
        "photoflux_std": photoflux_std,
    }


def make_ztf_like(n: int = 128, seed: int = 0, **kwargs) -> Dict[str, np.ndarray]:
    """ZTF-shaped variant: 2 photometric bands plus the extra normalisation
    keys the ZTF drivers read."""
    d = make_goldstein_like(n=n, seed=seed, num_bands=ZTF_BANDS, **kwargs)
    for k in ("spectime", "combined", "combined_time"):
        d[f"{k}_mean"] = np.float32(0.0)
        d[f"{k}_std"] = np.float32(1.0)
    return d


def make_images(n: int = 64, img_size: int = 60, channels: int = 3, seed: int = 0):
    """Synthetic host-galaxy-like images in [−1, 1], NCHW float32: one
    rotated elliptical Gaussian per image, a brightness per channel, and
    noise of σ 0.05 before the map to [−1, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:img_size, 0:img_size]
    imgs = np.zeros((n, channels, img_size, img_size), np.float32)
    for i in range(n):
        cx, cy = rng.uniform(0.3, 0.7, 2) * img_size
        sx, sy = rng.uniform(3, 12, 2)
        theta = rng.uniform(0, np.pi)
        xr = (xx - cx) * np.cos(theta) + (yy - cy) * np.sin(theta)
        yr = -(xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
        g = np.exp(-0.5 * ((xr / sx) ** 2 + (yr / sy) ** 2))
        for c in range(channels):
            imgs[i, c] = g * rng.uniform(0.5, 1.0) + 0.05 * rng.standard_normal(
                (img_size, img_size)
            )
    return np.clip(imgs * 2.0 - 1.0, -1.0, 1.0).astype(np.float32)
