"""Experiment drivers of the port, the counterparts of
``vaesne_tpu/experiments``:

Train:
  train_photospectra    — the flagship photometry + spectra MoE-MMVAE
  train_photometry      — Goldstein light-curve VAE
  train_spectra         — Goldstein spectra VAE
  train_ztf_photospect  — ZTF MMVAE
  train_ztf_spectra     — ZTF spectra VAE
  train_image           — host-galaxy image VAE (synthetic, MNIST or a
                          directory of image files)
  train_contrastive     — photometry/spectra contrastive towers (InfoNCE)
  train_regression      — Goldstein parameter heads over a frozen MMVAE or
                          contrastive backbone, or end to end

Evaluate:
  eval_goldstein        — residual/coverage/width/MSE per phase, one pass
                          (spect_cond_LC.py + evaluation.py + plot_metric.py)
  eval_masking          — LC-masking robustness sweep (gradual_masking.py)
  try_models            — qualitative figures (try_*.py; needs matplotlib)
  eval_regression       — a regression head's |error| in label sigma

Each runs as ``python -m vaesne_tpu_torch.experiments.<name> [data=/path.npz]
[key=value ...]`` on the card and takes synthetic data of the npz contract
when given no path (``train_image``: a directory of images); the train
drivers write their checkpoint under ``train.ckpt_dir``, which the eval
drivers read (``mm_ckpt=``, ``head_ckpt=``). In Python,
``main(argv, device="cpu")`` runs on the CPU.
"""
