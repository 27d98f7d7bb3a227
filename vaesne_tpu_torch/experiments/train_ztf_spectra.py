"""Train the spectra-only VAE on ZTF data.

The counterpart of ``vaesne_tpu/experiments/train_ztf_spectra.py``: the
training set repeated ×``repeat_factor`` (10), flux noise and extra masking
at ``extra_mask_prob`` (0.075), latent 4×4, β = 0.5, AdamW lr 1e-3.

Usage: python -m vaesne_tpu_torch.experiments.train_ztf_spectra [data=/path.npz] [k=v ...]
"""

from __future__ import annotations

import sys

from .. import objectives
from ..data import augment_spectra, repeat_dataset, spectra_tuple
from ..models import BrightSpectraVAE, SpectraVAE
from ..utils.config import ZTFSpectraConfig, parse_overrides
from .common import parse_cli, resolve_dataset, split_tuples, train_loop


def build_model(cfg: ZTFSpectraConfig) -> SpectraVAE:
    m = cfg.model
    cls = BrightSpectraVAE if m.bright else SpectraVAE
    return cls(latent_len=m.latent_len, latent_dim=m.latent_dim, model_dim=m.model_dim,
               num_heads=m.num_heads, ff_dim=m.ff_dim, num_layers=m.num_layers,
               dropout=m.dropout, selfattn=m.selfattn, concat=m.concat, beta=cfg.train.beta)


def main(argv=None, device=None):
    """Train on ``device`` (default: the card). Returns (state, losses)."""
    data_path, rest = parse_cli(list(sys.argv[1:] if argv is None else argv))
    cfg = parse_overrides(ZTFSpectraConfig(), rest)

    data = resolve_dataset(data_path, "ztf", seed=cfg.train.seed)
    train_data, _ = split_tuples(data, spectra_tuple, device)
    train_data = repeat_dataset(train_data, cfg.repeat_factor)
    model = build_model(cfg)

    def loss_fn(m, batch, seed):
        return objectives.elbo(m, batch, cfg.train.K, seed=seed)

    def augment(generator, batch):
        return augment_spectra(generator, batch, extra_mask_prob=cfg.extra_mask_prob)

    state, losses = train_loop(
        model, train_data, loss_fn, cfg.train, config=cfg, augment_fn=augment,
        device=device,
        ckpt_name=f"ztf_spectra_{cfg.model.latent_len}-{cfg.model.latent_dim}",
    )
    print(f"final loss: {losses[-1]:.6f}")
    return state, losses


if __name__ == "__main__":
    main()
