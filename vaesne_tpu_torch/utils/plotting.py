"""Plots of the port: light curves, spectra samples, the per-epoch loss
curve ``train_loop`` saves, and the evaluation's metric grid.

The counterpart of ``vaesne_tpu/utils/plotting.py`` (mirrored from the
reference's ``plot_util.py`` and ``plot_metric.py``), with the same lazy
import: ``matplotlib`` is imported at the call, so a host without it
imports the port all the same and the call raises ImportError.
  * ``plot_lsst_lc``          6 LSST bands with the fixed band→color map,
    inverted magnitude axis, masked points dropped
  * ``plot_spectra_samples``  mean + quantile band over the posterior-sample
    axis
  * ``plot_loss_curve``       the per-epoch loss
  * ``plot_metric_grid``      residual / coverage / width × phase bucket
"""

from __future__ import annotations

import numpy as np

LSST_BANDS = ["u", "g", "r", "i", "z", "y"]
LSST_COLORS = ["purple", "blue", "darkgreen", "lime", "orange", "red"]


def plot_lsst_lc(photoband, photomag, phototime, photomask, ax=None, label=False,
                 s=5, lw=2, alpha=1.0):
    import matplotlib.pyplot as plt

    photoband = np.asarray(photoband)[~np.asarray(photomask)]
    photomag = np.asarray(photomag)[~np.asarray(photomask)]
    phototime = np.asarray(phototime)[~np.asarray(photomask)]
    fig = None
    if ax is None:
        fig, ax = plt.subplots()
    for bnd in range(len(LSST_BANDS)):
        idx = np.where(photoband == bnd)[0]
        if len(idx) > 0:
            kwargs = {"label": LSST_BANDS[bnd]} if label else {}
            ax.scatter(phototime[idx], photomag[idx], s=s, color=LSST_COLORS[bnd],
                       alpha=alpha, **kwargs)
            ax.plot(phototime[idx], photomag[idx], color=LSST_COLORS[bnd],
                    alpha=0.5 * alpha, lw=lw)
    ax.invert_yaxis()
    return fig


def plot_spectra_samples(spectra, wavelength, mask, alpha_level=0.1, ax=None,
                         color="blue", label=None):
    import matplotlib.pyplot as plt

    spectra = np.asarray(spectra)
    wavelength = np.asarray(wavelength)
    mask = np.asarray(mask)
    fig = None
    if ax is None:
        fig, ax = plt.subplots()
    mean = np.nanmean(spectra, axis=0)
    lw_ = np.nanquantile(spectra, q=alpha_level / 2, axis=0)
    hi = np.nanquantile(spectra, q=1.0 - alpha_level / 2, axis=0)
    ax.plot(wavelength[~mask], mean[~mask], label=label, color=color)
    ax.fill_between(wavelength[~mask], lw_[~mask], hi[~mask], color=color,
                    alpha=0.3)
    return fig


def plot_loss_curve(losses, path=None, ax=None):
    import matplotlib.pyplot as plt

    fig = None
    if ax is None:
        fig, ax = plt.subplots()
    ax.plot(np.arange(len(losses)), np.asarray(losses))
    ax.set_xlabel("training epochs")
    ax.set_ylabel("loss")
    if path is not None and fig is not None:
        fig.savefig(path)
        plt.close(fig)
    return fig


def plot_metric_grid(metrics, path=None, phases=(-10.0, 0.0, 10.0, 20.0, 30.0),
                     names=None):
    """Residual / coverage / width x phase-bucket grid — the reference's 3x5
    metric figure (plot_metric.py:5-101). ``metrics`` is the dict produced by
    ``aggregate_metrics``; every named reconstruction set present is drawn."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if names is None:
        names = sorted({k.rsplit("_resi_mean", 1)[0] for k in metrics
                        if k.endswith("_resi_mean")})
    fig, axes = plt.subplots(3, len(phases), figsize=(4 * len(phases), 9),
                             sharex=True)
    rows = ("resi", "coverage", "width")
    for col, ph in enumerate(phases):
        for row, what in enumerate(rows):
            ax = axes[row, col]
            for name in names:
                mean = np.asarray(metrics[f"{name}_{what}_mean"])[col]
                ax.plot(mean, label=name)
                if f"{name}_{what}_sd" in metrics:
                    sd = np.asarray(metrics[f"{name}_{what}_sd"])[col]
                    x = np.arange(len(mean))
                    ax.fill_between(x, mean - sd, mean + sd, alpha=0.2)
            if row == 0:
                ax.set_title(f"phase {ph:+.0f} d")
            if row == 1:
                ax.axhline(0.9, color="k", ls="--", lw=0.8)  # 90% target line
            if col == 0:
                ax.set_ylabel(what)
    axes[0, 0].legend(fontsize=8)
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=120)
        plt.close(fig)
    return fig
