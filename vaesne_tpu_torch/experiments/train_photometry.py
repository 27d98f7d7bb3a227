"""Train the Goldstein photometry (light-curve) VAE.

The counterpart of ``vaesne_tpu/experiments/train_photometry.py``: latent
4×2, model_dim 32, the ELBO, AdamW lr 2.5e-4, batch 32.

Usage:
  python -m vaesne_tpu_torch.experiments.train_photometry [data=/path.npz]
      [train.epochs=50] [model.latent_dim=2] ...
"""

from __future__ import annotations

import sys

from .. import objectives
from ..data import augment_photometry, photometry_tuple
from ..models import BrightPhotometricVAE, PhotometricVAE
from ..utils.config import PhotometryVAEConfig, parse_overrides
from .common import parse_cli, resolve_dataset, split_tuples, train_loop


def build_model(cfg: PhotometryVAEConfig) -> PhotometricVAE:
    m = cfg.model
    cls = BrightPhotometricVAE if m.bright else PhotometricVAE
    return cls(num_bands=cfg.num_bands, latent_len=m.latent_len, latent_dim=m.latent_dim,
               model_dim=m.model_dim, num_heads=m.num_heads, ff_dim=m.ff_dim,
               num_layers=m.num_layers, dropout=m.dropout, selfattn=m.selfattn,
               concat=m.concat, beta=cfg.train.beta)


def main(argv=None, device=None):
    """Train on ``device`` (default: the card). Returns (state, losses)."""
    data_path, rest = parse_cli(list(sys.argv[1:] if argv is None else argv))
    cfg = parse_overrides(PhotometryVAEConfig(), rest)

    data = resolve_dataset(data_path, "goldstein", seed=cfg.train.seed)
    train_data, _ = split_tuples(data, photometry_tuple, device)
    model = build_model(cfg)

    state, losses = train_loop(
        model, train_data, objectives.as_loss(objectives.elbo, K=cfg.train.K), cfg.train,
        config=cfg, augment_fn=augment_photometry, device=device,
        ckpt_name=f"goldstein_photometry_{cfg.model.latent_len}-{cfg.model.latent_dim}",
    )
    print(f"final loss: {losses[-1]:.6f}")
    return state, losses


if __name__ == "__main__":
    main()
