"""Training drivers of the port, the counterparts of
``vaesne_tpu/experiments``:

  train_photospectra    — the flagship photometry + spectra MoE-MMVAE
  train_photometry      — Goldstein light-curve VAE
  train_spectra         — Goldstein spectra VAE
  train_ztf_photospect  — ZTF MMVAE
  train_ztf_spectra     — ZTF spectra VAE

Each runs as ``python -m vaesne_tpu_torch.experiments.<name> [data=/path.npz]
[key=value ...]`` on the card, takes synthetic data of the npz contract when
given no path, and writes its checkpoint under ``train.ckpt_dir``. In
Python, ``main(argv, device="cpu")`` runs on the CPU.
"""
