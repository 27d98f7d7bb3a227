"""Train the photometry + spectra MoE-MMVAE on ZTF data (2 bands).

The counterpart of ``vaesne_tpu/experiments/train_ztf_photospect.py``: the
training set repeated ×``repeat_factor`` (10) with fresh augmentation of
every copy each epoch, m-IWAE with K = 8, β = 0.5, AdamW lr 1e-3.

Usage: python -m vaesne_tpu_torch.experiments.train_ztf_photospect [data=/path.npz] [k=v ...]
"""

from __future__ import annotations

import sys

from .. import objectives
from ..data import augment_multimodal, multimodal_tuple, repeat_dataset
from ..models import (
    BrightPhotometricVAE,
    BrightSpectraVAE,
    PhotometricVAE,
    PhotoSpecMMVAE,
    SpectraVAE,
)
from ..utils.config import ZTFMMVAEConfig, parse_overrides
from .common import parse_cli, resolve_dataset, split_tuples, train_loop


def build_model(cfg: ZTFMMVAEConfig) -> PhotoSpecMMVAE:
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


def main(argv=None, device=None):
    """Train on ``device`` (default: the card). Returns (state, losses)."""
    data_path, rest = parse_cli(list(sys.argv[1:] if argv is None else argv))
    cfg = parse_overrides(ZTFMMVAEConfig(), rest)

    data = resolve_dataset(data_path, "ztf", seed=cfg.train.seed)
    train_data, _ = split_tuples(data, multimodal_tuple, device)
    train_data = repeat_dataset(train_data, cfg.repeat_factor)
    model = build_model(cfg)

    def loss_fn(m, batch, seed):
        return objectives.m_iwae(m, batch, cfg.train.K, seed=seed)

    state, losses = train_loop(
        model, train_data, loss_fn, cfg.train, config=cfg,
        augment_fn=augment_multimodal, device=device,
        ckpt_name=(f"ztf_photospec_{cfg.model.latent_len}-{cfg.model.latent_dim}"
                   f"_K{cfg.train.K}_beta{cfg.train.beta}"),
    )
    print(f"final loss: {losses[-1]:.6f}")
    return state, losses


if __name__ == "__main__":
    main()
