"""Qualitative evaluation: reconstruction / cross-modal / generation figures.

The counterpart of ``vaesne_tpu/experiments/try_models.py`` (reference:
cannon/try_photometry_model.py, try_spectra_model.py,
try_photospectra_model.py; K posterior samples, matplotlib CI-band figures;
cross matrix convention ``[0][0]`` LC→LC, ``[0][1]`` LC→spec, ...,
try_photospectra_model.py:78). Every figure needs matplotlib, which the
H100 host does not have, so these drivers run where matplotlib is
installed, on the CPU: ``main(argv, device="cpu")``; ``model=image``
also runs on the card, where it writes its reconstructions as .npy and
skips its figure. Without a ``device`` they run on the card, as every
entry point of the port does.

Usage:
  python -m vaesne_tpu_torch.experiments.try_models \\
      [model=mmvae|photometry|spectra|image|ztf_spectra|ztf_mmvae|latent_swap]
      [data=...] [mm_ckpt=...] [photo_ckpt=...] [spec_ckpt=...]
      [K=100] [n=4] [out=./figs]

``model=ztf_spectra`` and ``model=ztf_mmvae`` (try_ZTF_spectonly.py,
try_ZTF_photospect.py) take bands and normalization from the ZTF data keys
and the checkpoint's config.json. ``model=latent_swap`` reproduces the
unimodal-VAE latent-swap cross-decode (try_photospectra_model.py:82-85): pass
``photo_ckpt=`` and ``spec_ckpt=`` pointing at unimodal checkpoints with
matching latent shapes. ``model=image`` (try_img_model.py) reconstructs
synthetic images with an image VAE checkpoint. Checkpoints are the port's
(``state.pt``); bridge a JAX one first.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

from ..data import multimodal_tuple, photometry_tuple, spectra_tuple
from ..nn.layers import autocast, resolve_precision
from ..training import resolve_device
from ..utils.config import PhotoSpectraMMVAEConfig
from ..utils.plotting import plot_lsst_lc, plot_spectra_samples
from ..utils.rng import device_generator
from .common import parse_cli, resolve_dataset
from .eval_goldstein import _config_for, _restore
from .train_photospectra import build_model as build_mmvae


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _inference(device):
    """Inference on ``device`` at the precision ``VAESNE_BF16`` asks for,
    as the JAX package's figures are drawn in bf16 under it."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.inference_mode())
    stack.enter_context(autocast(resolve_precision(None), device))
    return stack


def _np(tree):
    """Tensors (nested in lists and tuples) as host numpy arrays."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(t) for t in tree)
    if tree.dtype == torch.bfloat16:  # a VAESNE_BF16 output; numpy has no bfloat16
        tree = tree.float()
    return tree.detach().cpu().numpy()


def _save(fig, plt, out_dir, name):
    fig.tight_layout()
    path = os.path.join(out_dir, name)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"wrote {path}")


def try_unimodal(which, data_path, ckpt, K, n_show, out_dir, device=None):
    """Qualitative reconstructions for a single-modality VAE
    (try_photometry_model.py / try_spectra_model.py)."""
    plt = _pyplot()
    from ..utils.config import PhotometryVAEConfig, SpectraVAEConfig
    from .train_photometry import build_model as build_photo
    from .train_spectra import build_model as build_spec

    device = resolve_device(device)
    data = resolve_dataset(data_path, "goldstein")
    te_idx = np.asarray(data["testing_idx"])[:n_show]
    if which == "photometry":
        batch = photometry_tuple(data, idx=te_idx, device=device)
        model = _restore(ckpt, build_photo(_config_for(ckpt, PhotometryVAEConfig)))
    else:
        batch = spectra_tuple(data, idx=te_idx, device=device)
        model = _restore(ckpt, build_spec(_config_for(ckpt, SpectraVAEConfig)))
    model = model.to(device).eval()
    with _inference(device):
        recon = _np(model.reconstruct(batch, K, generator=device_generator(0, device)))
    x = _np(batch)
    os.makedirs(out_dir, exist_ok=True)
    fig, axes = plt.subplots(1, n_show, figsize=(4.5 * n_show, 3.5))
    for i, ax in enumerate(np.atleast_1d(axes)):
        rec = recon[:, i]
        if which == "photometry":
            plot_lsst_lc(x[2][i], rec.mean(0), x[1][i], x[3][i], ax=ax)
            plot_lsst_lc(x[2][i], x[0][i], x[1][i], x[3][i], ax=ax, alpha=0.3)
        else:
            plot_spectra_samples(rec, x[1][i], x[3][i], ax=ax)
            ax.plot(x[1][i], x[0][i], color="k", lw=0.5, alpha=0.5)
    _save(fig, plt, out_dir, f"{which}_reconstructions.png")


def try_image(data_path, ckpt, K, n_show, out_dir, device=None):
    """Qualitative image reconstructions (try_img_model.py): ``n_show``
    images of ``make_images`` and the mean of their K posterior-draw
    reconstructions. The reconstructions ([K, n_show, C, H, W]) go to
    ``image_reconstructions.npy`` and are returned; the figure
    ``image_reconstructions.png`` is drawn where matplotlib is installed
    (not on the H100 host). ``data_path`` is not read, as in the JAX
    driver."""
    from ..data import image_tuple, make_images
    from ..utils.config import ImageVAEConfig
    from .train_image import build_model as build_image

    device = resolve_device(device)
    cfg = _config_for(ckpt, ImageVAEConfig)
    model = _restore(ckpt, build_image(cfg)).to(device).eval()
    images = make_images(n=n_show, img_size=cfg.img_size, channels=cfg.in_channels)
    with _inference(device):
        recon = _np(model.reconstruct(image_tuple(images, device), K,
                                      generator=device_generator(0, device)))
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "image_reconstructions.npy"), recon)
    try:
        plt = _pyplot()
    except ImportError:
        print("matplotlib is not installed: no figure is written")
        return recon
    fig, axes = plt.subplots(2, n_show, figsize=(3 * n_show, 6), squeeze=False)
    for i in range(n_show):
        axes[0, i].imshow(np.moveaxis(images[i], 0, -1) * 0.5 + 0.5)
        axes[0, i].set_title("input")
        axes[1, i].imshow(np.clip(np.moveaxis(recon.mean(0)[i], 0, -1) * 0.5 + 0.5, 0, 1))
        axes[1, i].set_title("reconstruction")
        for ax in (axes[0, i], axes[1, i]):
            ax.axis("off")
    _save(fig, plt, out_dir, "image_reconstructions.png")
    return recon


def try_ztf_spectra(data_path, ckpt, K, n_show, out_dir, device=None):
    """ZTF spectra-only qualitative eval (try_ZTF_spectonly.py): posterior
    reconstruction with a 95% CI band on the observed wavelengths in
    physical units, plus prior-sample spectra."""
    plt = _pyplot()
    from ..utils.config import ZTFSpectraConfig
    from .train_ztf_spectra import build_model as build_ztf_spec

    device = resolve_device(device)
    data = resolve_dataset(data_path, "ztf")
    te_idx = np.asarray(data["testing_idx"])[:max(n_show, 1)]
    batch = spectra_tuple(data, idx=te_idx, device=device)
    model = _restore(ckpt, build_ztf_spec(_config_for(ckpt, ZTFSpectraConfig)))
    model = model.to(device).eval()
    wl_m, wl_s = float(data["wavelength_mean"]), float(data["wavelength_std"])
    fl_m, fl_s = float(data["flux_mean"]), float(data["flux_std"])

    N = 30
    with _inference(device):
        recon = _np(model.reconstruct(batch, K, generator=device_generator(0, device)))
        gens = _np(model.generate(N, batch, generator=device_generator(0, device)))
    x = _np(batch)
    os.makedirs(out_dir, exist_ok=True)
    fig, axes = plt.subplots(1, len(te_idx), figsize=(5 * len(te_idx), 4), squeeze=False)
    for i, ax in enumerate(axes[0]):
        obs = ~x[3][i]  # True == observed
        wl = x[1][i][obs] * wl_s + wl_m
        ax.plot(wl, x[0][i][obs] * fl_s + fl_m, color="red", label="ground truth")
        rec = recon[:, i][:, obs] * fl_s + fl_m
        ax.plot(wl, rec.mean(0), color="blue", label="Rec-spec")
        ax.fill_between(wl, np.quantile(rec, 0.025, axis=0),
                        np.quantile(rec, 0.975, axis=0), color="blue", alpha=0.3)
        ax.set_xlabel("wavelength (Å)")
        ax.set_ylabel("log Fnu")
        ax.legend()
    _save(fig, plt, out_dir, "ztf_spectra_reconstruction.png")

    fig, axs = plt.subplots(2, 1, figsize=(10, 5))
    obs0 = ~x[3][0]
    wl0 = x[1][0][obs0] * wl_s + wl_m
    for i in range(min(N, len(te_idx))):
        obs = ~x[3][i]
        axs[0].plot(x[1][i][obs] * wl_s + wl_m, x[0][i][obs] * fl_s + fl_m, alpha=0.5)
    for i in range(N):
        axs[1].plot(wl0, gens[i, 0][obs0] * fl_s + fl_m, alpha=0.5)
    axs[0].set_title("ground-truth spectra")
    axs[1].set_title("prior samples")
    for ax in axs:
        ax.set_ylabel("log Fnu")
        ax.set_xlabel("wavelength (Å)")
        ax.set_ylim(-2 * fl_s + fl_m, 2 * fl_s + fl_m)
    _save(fig, plt, out_dir, "ztf_spectra_priorsamples.png")


def try_ztf_mmvae(data_path, ckpt, K, n_show, out_dir, device=None):
    """ZTF photo+spectra MMVAE qualitative eval (try_ZTF_photospect.py):
    per-band light-curve panels (ground truth / self-recon / spec→LC), the
    spec→spec and LC→spec CI-band figures, and prior samples, in physical
    units via the ZTF normalization keys (try_ZTF_photospect.py:21-31)."""
    plt = _pyplot()
    from ..utils.config import ZTFMMVAEConfig
    from .train_ztf_photospect import build_model as build_ztf_mm

    device = resolve_device(device)
    data = resolve_dataset(data_path, "ztf")
    te_idx = np.asarray(data["testing_idx"])[:max(n_show, 1)]
    batch = multimodal_tuple(data, idx=te_idx, device=device)
    cfg = _config_for(ckpt, ZTFMMVAEConfig)
    model = _restore(ckpt, build_ztf_mm(cfg)).to(device).eval()
    wl_m, wl_s = float(data["wavelength_mean"]), float(data["wavelength_std"])
    fl_m, fl_s = float(data["flux_mean"]), float(data["flux_std"])
    pf_m, pf_s = float(data["combined_mean"]), float(data["combined_std"])
    pt_m, pt_s = float(data["combined_time_mean"]), float(data["combined_time_std"])

    N = 30
    with _inference(device):
        recons = _np(model.reconstruct(batch, K, generator=device_generator(0, device)))
        gens = _np(model.generate(N, batch, generator=device_generator(0, device)))
    photo, spec = _np(batch)
    os.makedirs(out_dir, exist_ok=True)

    # --- light curves: ground truth / LC→LC / spec→LC, per band ---------
    i = 0
    fig, axs = plt.subplots(1, 3, figsize=(12, 5))
    band, pobs = photo[2][i], ~photo[3][i]
    lc_rec = recons[0][0][:, i].mean(0)
    lc_cross = recons[1][0][:, i].mean(0)
    for b in range(cfg.num_bands):
        sel = (band == b) & pobs
        t = photo[1][i][sel] * pt_s + pt_m
        for ax, series, marker in ((axs[0], photo[0][i], "o"), (axs[1], lc_rec, "x"),
                                   (axs[2], lc_cross, "x")):
            v = series[sel] * pf_s + pf_m
            ax.plot(t, v)
            ax.scatter(t, v, s=20, marker=marker)
    ylow, yhigh = -2 * pf_s + pf_m, 6 * pf_s + pf_m
    for ax, title in zip(axs, ("Ground truth", "Reconstruction-LC", "Reconstruction-Spectra")):
        ax.set_ylim(ylow, yhigh)
        ax.invert_yaxis()
        ax.set_title(title)
    axs[0].set_ylabel("AbsMag")
    axs[1].set_xlabel("days")
    _save(fig, plt, out_dir, "ztf_lc_reconstruction.png")

    # --- spectra: spec→spec and LC→spec with CI bands -------------------
    sobs = ~spec[3][i]
    wl = spec[1][i][sobs] * wl_s + wl_m
    gt = spec[0][i][sobs] * fl_s + fl_m
    fig, axs = plt.subplots(2, 1, figsize=(10, 8))
    for ax, (e, color, label) in zip(axs, ((1, "blue", "Rec-spec"), (0, "green", "Rec-LC"))):
        rec = recons[e][1][:, i][:, sobs] * fl_s + fl_m
        ax.plot(wl, gt, color="red", label="ground truth" if e == 1 else None)
        ax.plot(wl, rec.mean(0), color=color, label=label)
        ax.fill_between(wl, np.quantile(rec, 0.05, axis=0), np.quantile(rec, 0.95, axis=0),
                        color=color, alpha=0.3)
        if e == 0:  # LC→spec: individual posterior-sample traces
            for k in range(min(30, rec.shape[0])):
                ax.plot(wl, rec[k], alpha=0.3)
        ax.set_ylabel("log Fnu")
        ax.legend()
    axs[1].set_xlabel("wavelength (Å)")
    _save(fig, plt, out_dir, "ztf_spectra_reconstruction.png")

    # --- prior samples --------------------------------------------------
    fig, axs = plt.subplots(2, 1, figsize=(8, 6))
    for j in range(min(N, len(te_idx))):
        o = ~spec[3][j]
        axs[0].plot(spec[1][j][o] * wl_s + wl_m, spec[0][j][o] * fl_s + fl_m, alpha=0.5)
    for j in range(N):
        axs[1].plot(wl, gens[1][j, i][sobs] * fl_s + fl_m, alpha=0.5)
    axs[0].set_title("ground-truth spectra")
    axs[1].set_title("prior samples")
    for ax in axs:
        ax.set_ylabel("log Fnu")
        ax.set_xlabel("wavelength (Å)")
        ax.set_ylim(-2 * fl_s + fl_m, 2 * fl_s + fl_m)
    _save(fig, plt, out_dir, "ztf_spectra_priorsamples.png")


def try_latent_swap(data_path, photo_ckpt, spec_ckpt, K, n_show, out_dir, device=None):
    """Unimodal-VAE latent-swap cross-decode (try_photospectra_model.py:82-85):
    encode each modality with its own UNIMODAL VAE (posterior mean), swap the
    latents, and decode: LC latents through the spectra decoder and spectra
    latents through the LC decoder. The two VAEs were never trained
    together; the figure shows how far their latent spaces happen to align."""
    plt = _pyplot()
    from ..utils.config import PhotometryVAEConfig, SpectraVAEConfig
    from .train_photometry import build_model as build_photo
    from .train_spectra import build_model as build_spec

    if not photo_ckpt or not spec_ckpt:
        # without checkpoints the figure would show freshly initialised weights
        raise ValueError(
            "model=latent_swap needs trained unimodal checkpoints: pass "
            "photo_ckpt=<path> spec_ckpt=<path> (port checkpoints, e.g. bridged from "
            "the shipped artifacts/ckpt/goldstein_{photometry,spectra}_4-4)")
    pcfg = _config_for(photo_ckpt, PhotometryVAEConfig)
    scfg = _config_for(spec_ckpt, SpectraVAEConfig)
    if (pcfg.model.latent_len, pcfg.model.latent_dim) != (
            scfg.model.latent_len, scfg.model.latent_dim):
        raise ValueError(
            "latent_swap needs matching latent shapes: photometry ckpt has "
            f"{pcfg.model.latent_len}x{pcfg.model.latent_dim}, spectra ckpt "
            f"{scfg.model.latent_len}x{scfg.model.latent_dim}")
    device = resolve_device(device)
    data = resolve_dataset(data_path, "goldstein")
    te_idx = np.asarray(data["testing_idx"])[:n_show]
    photo = photometry_tuple(data, idx=te_idx, device=device)
    spec = spectra_tuple(data, idx=te_idx, device=device)
    photo_model = _restore(photo_ckpt, build_photo(pcfg)).to(device).eval()
    spec_model = _restore(spec_ckpt, build_spec(scfg)).to(device).eval()

    with _inference(device):
        # posterior means [B, latent_len, latent_dim] with the K = 1 axis the
        # decoders expect (try_photospectra_model.py:83)
        z_photo = photo_model.encode(photo)[None]
        z_spec = spec_model.encode(spec)[None]
        lc2spec = _np(spec_model.decode(z_photo, spec).mean[0])
        spec2lc = _np(photo_model.decode(z_spec, photo).mean[0])
    photo, spec = _np(photo), _np(spec)

    os.makedirs(out_dir, exist_ok=True)
    fig, axes = plt.subplots(n_show, 2, figsize=(10, 3.2 * n_show))
    axes = np.atleast_2d(axes)
    for i in range(n_show):
        ax = axes[i, 0]
        plot_lsst_lc(photo[2][i], spec2lc[i], photo[1][i], photo[3][i], ax=ax)
        plot_lsst_lc(photo[2][i], photo[0][i], photo[1][i], photo[3][i], ax=ax, alpha=0.3)
        ax.set_title("spec latents → LC decoder")
        ax = axes[i, 1]
        obs = ~spec[3][i]
        ax.plot(spec[1][i][obs], spec[0][i][obs], color="k", lw=0.5, alpha=0.5,
                label="ground truth")
        ax.plot(spec[1][i][obs], lc2spec[i][obs], color="tab:blue",
                label="LC latents → spec decoder")
        ax.set_title("LC latents → spectra decoder")
        if i == 0:
            ax.legend()
    _save(fig, plt, out_dir, "latent_swap.png")


def main(argv=None, device=None):
    """Draw the figures of ``model=`` on ``device`` (default: the card)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    mm_ckpt, K, n_show, out_dir = None, 100, 4, "./figs"
    photo_ckpt = spec_ckpt = None
    which = "mmvae"
    rest = []
    for a in argv:
        if a.startswith("model="):
            which = a.split("=", 1)[1]
        elif a.startswith("mm_ckpt="):
            mm_ckpt = a.split("=", 1)[1]
        elif a.startswith("photo_ckpt="):
            photo_ckpt = a.split("=", 1)[1]
        elif a.startswith("spec_ckpt="):
            spec_ckpt = a.split("=", 1)[1]
        elif a.startswith("K="):
            K = int(a.split("=", 1)[1])
        elif a.startswith("n="):
            n_show = int(a.split("=", 1)[1])
        elif a.startswith("out="):
            out_dir = a.split("=", 1)[1]
        else:
            rest.append(a)
    data_path, rest = parse_cli(rest)

    if which in ("photometry", "spectra"):
        return try_unimodal(which, data_path, mm_ckpt, K, n_show, out_dir, device)
    if which == "image":
        return try_image(data_path, mm_ckpt, K, n_show, out_dir, device)
    if which == "ztf_spectra":
        return try_ztf_spectra(data_path, mm_ckpt, K, n_show, out_dir, device)
    if which == "ztf_mmvae":
        return try_ztf_mmvae(data_path, mm_ckpt, K, n_show, out_dir, device)
    if which == "latent_swap":
        return try_latent_swap(data_path, photo_ckpt, spec_ckpt, K, n_show, out_dir, device)

    plt = _pyplot()
    device = resolve_device(device)
    data = resolve_dataset(data_path, "goldstein")
    te_idx = np.asarray(data["testing_idx"])[:n_show]
    batch = multimodal_tuple(data, idx=te_idx, device=device)
    model = _restore(mm_ckpt, build_mmvae(_config_for(mm_ckpt, PhotoSpectraMMVAEConfig)))
    model = model.to(device).eval()

    # M x M reconstruction matrix, K posterior samples per cell; prior
    # generations conditioned on the first event's grids
    with _inference(device):
        recons = _np(model.reconstruct(batch, K, generator=device_generator(0, device)))
        gens = _np(model.generate(8, batch, generator=device_generator(0, device)))
    photo, spec = _np(batch)

    os.makedirs(out_dir, exist_ok=True)
    names = [["LC2LC", "spec2LC"], ["LC2spec", "spec2spec"]]
    fig, axes = plt.subplots(n_show, 4, figsize=(18, 3 * n_show))
    axes = np.atleast_2d(axes)
    for i in range(n_show):
        # LC→LC and spec→LC on light-curve axes
        for col, e in enumerate((0, 1)):
            ax = axes[i, col]
            plot_lsst_lc(photo[2][i], recons[e][0][:, i].mean(0), photo[1][i], photo[3][i],
                         ax=ax)
            plot_lsst_lc(photo[2][i], photo[0][i], photo[1][i], photo[3][i], ax=ax, alpha=0.3)
            ax.set_title(names[e][0])
        # LC→spec and spec→spec on spectrum axes
        for col, e in enumerate((0, 1), start=2):
            ax = axes[i, col]
            plot_spectra_samples(recons[e][1][:, i], spec[1][i], spec[3][i], ax=ax)
            ax.plot(spec[1][i], spec[0][i], color="k", lw=0.5, alpha=0.5)
            ax.set_title(names[e][1])
    _save(fig, plt, out_dir, "cross_reconstructions.png")

    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    plot_spectra_samples(gens[1][:, 0], spec[1][0], spec[3][0], ax=axes[1])
    plot_lsst_lc(photo[2][0], gens[0][:, 0].mean(0), photo[1][0], photo[3][0], ax=axes[0])
    axes[0].set_title("prior generation: light curve")
    axes[1].set_title("prior generation: spectra")
    _save(fig, plt, out_dir, "generations.png")


if __name__ == "__main__":
    main()
