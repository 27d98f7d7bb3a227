"""Train the contrastive (InfoNCE) photometry/spectra two-tower network.

The counterpart of ``vaesne_tpu/experiments/train_contrastive.py``
(reference: cannon/test_photospectra_contrast.py): the two towers of
``ContraPhotSpec`` at latent 4x4, model_dim 32, projections of 8, the
symmetric InfoNCE at temperature 0.1, AdamW lr 2.5e-4, batch 32, the
multimodal augmentation drawn each epoch.

Usage:
  python -m vaesne_tpu_torch.experiments.train_contrastive [data=/path.npz]
      [model.selfattn=true] [train.epochs=...] [k=v ...]

``model.selfattn=true`` adds a context self-attention to every encoder
block; the spectra tower's, over 982 bins and the phase token, runs on the
fused attention kernels.
"""

from __future__ import annotations

import sys
import warnings

from .. import objectives
from ..data import augment_multimodal, multimodal_tuple
from ..models import ContraPhotSpec
from ..utils.config import ContrastiveConfig, parse_overrides
from .common import parse_cli, resolve_dataset, split_tuples, train_loop


def build_model(cfg: ContrastiveConfig) -> ContraPhotSpec:
    m = cfg.model
    return ContraPhotSpec(
        latent_len=m.latent_len, latent_dim=m.latent_dim, proj_dim=cfg.proj_dim,
        num_bands=cfg.num_bands, photo_model_dim=m.model_dim, photo_num_heads=m.num_heads,
        photo_ff_dim=m.ff_dim, photo_num_layers=m.num_layers, photo_dropout=m.dropout,
        spec_model_dim=m.model_dim, spec_num_heads=m.num_heads, spec_ff_dim=m.ff_dim,
        spec_num_layers=m.num_layers, spec_dropout=m.dropout, selfattn=m.selfattn)


def main(argv=None, device=None, callback=None):
    """Train on ``device`` (default: the card); ``callback(epoch, state,
    loss)`` runs after each epoch. Returns (state, losses)."""
    data_path, rest = parse_cli(list(sys.argv[1:] if argv is None else argv))
    cfg = parse_overrides(ContrastiveConfig(), rest)

    if cfg.train.accum_steps > 1:
        warnings.warn(
            "accum_steps > 1 with InfoNCE shrinks each anchor's negative "
            "pool to the microbatch: this optimizes a weaker contrastive "
            "objective than the whole-batch loss (InfoNCE is not "
            "microbatch-decomposable). Proceeding, but the result is NOT "
            "equivalent to accum_steps=1 at the same global batch.",
            stacklevel=1,
        )

    data = resolve_dataset(data_path, "goldstein", seed=cfg.train.seed)
    train_data, _ = split_tuples(data, multimodal_tuple, device)
    model = build_model(cfg)

    state, losses = train_loop(
        model, train_data,
        objectives.as_loss(objectives.neg_info_nce, temperature=cfg.temperature), cfg.train, config=cfg,
        augment_fn=augment_multimodal, callback=callback, device=device,
        ckpt_name=(f"goldstein_contrastive_{cfg.model.latent_len}-{cfg.model.latent_dim}"
                   f"_proj{cfg.proj_dim}"),
    )
    print(f"final loss: {losses[-1]:.6f}")
    return state, losses


if __name__ == "__main__":
    main()
