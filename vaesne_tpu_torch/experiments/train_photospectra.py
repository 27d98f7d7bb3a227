"""Train the flagship Goldstein photometry + spectra MoE-MMVAE.

The counterpart of ``vaesne_tpu/experiments/train_photospectra.py``: two
latent-4×4, model_dim-32 modality VAEs in a ``PhotoSpecMMVAE`` (β = 1),
m-IWAE with K = 2, batch 16, AdamW lr 1e-4.

Usage:
  python -m vaesne_tpu_torch.experiments.train_photospectra [data=/path.npz]
      [train.K=2] [train.beta=1.0] ...
"""

from __future__ import annotations

import sys

from .. import objectives
from ..data import augment_multimodal, multimodal_tuple
from ..models import (
    BrightPhotometricVAE,
    BrightSpectraVAE,
    PhotometricVAE,
    PhotoSpecMMVAE,
    SpectraVAE,
)
from ..utils.config import PhotoSpectraMMVAEConfig, parse_overrides
from .common import parse_cli, resolve_dataset, split_tuples, train_loop


def build_model(cfg: PhotoSpectraMMVAEConfig) -> PhotoSpecMMVAE:
    m = cfg.model
    shared = dict(
        latent_len=m.latent_len, latent_dim=m.latent_dim, model_dim=m.model_dim,
        num_heads=m.num_heads, ff_dim=m.ff_dim, num_layers=m.num_layers,
        dropout=m.dropout, selfattn=m.selfattn, concat=m.concat,
    )
    photo_cls, spec_cls = ((BrightPhotometricVAE, BrightSpectraVAE) if m.bright
                           else (PhotometricVAE, SpectraVAE))
    return PhotoSpecMMVAE([photo_cls(num_bands=cfg.num_bands, **shared), spec_cls(**shared)],
                          beta=cfg.train.beta)


def main(argv=None, device=None, callback=None):
    """Train on ``device`` (default: the card); ``callback(epoch, state,
    loss)`` runs after each epoch. Returns (state, losses)."""
    data_path, rest = parse_cli(list(sys.argv[1:] if argv is None else argv))
    cfg = parse_overrides(PhotoSpectraMMVAEConfig(), rest)

    data = resolve_dataset(data_path, "goldstein", seed=cfg.train.seed)
    train_data, _ = split_tuples(data, multimodal_tuple, device)
    model = build_model(cfg)

    state, losses = train_loop(
        model, train_data, objectives.as_loss(objectives.m_iwae, K=cfg.train.K), cfg.train, config=cfg,
        augment_fn=augment_multimodal, callback=callback, device=device,
        ckpt_name=(f"goldstein_photospec_{cfg.model.latent_len}-{cfg.model.latent_dim}"
                   f"_K{cfg.train.K}_beta{cfg.train.beta}"),
    )
    print(f"final loss: {losses[-1]:.6f}")
    return state, losses


if __name__ == "__main__":
    main()
