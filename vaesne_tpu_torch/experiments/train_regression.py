"""Train Goldstein physical-parameter regression heads (all 6 variants).

The counterpart of ``vaesne_tpu/experiments/train_regression.py``
(reference: cannon/photometry2goldstein_{mmvae,contrast,end2end}.py and
spec2goldstein_{...}.py): MLP heads mapping a light curve or a spectrum to
the 4 Goldstein simulation parameters, over (a) a frozen MMVAE backbone,
(b) a frozen contrastive tower, or (c) an encoder trained end to end. The
labels are parsed from the data's identities and standardised on the
training split (numpy's std, ddof 0, + 1e-8); the standardisation goes to
``{train.ckpt_dir}/goldstein_normalizing.json`` for the evaluation.

Usage:
  python -m vaesne_tpu_torch.experiments.train_regression modality=photometry \\
      backbone=mmvae [backbone_ckpt=artifacts/ckpt_torch/goldstein_photospec_...] \\
      [k=v ...]

``modality`` in {photometry, spec}; ``backbone`` in {mmvae, contrast,
end2end}. ``backbone_ckpt`` names a port checkpoint (a trained run's, or a
parameters-only bridged one); without it the backbone is freshly
initialised (untrained), which serves smoke runs. As in the JAX package the
backbone is built from the default ``PhotoSpectraMMVAEConfig()`` or
``ContrastiveConfig()``, whatever config the checkpoint carries. In Python,
``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .. import objectives
from ..data import goldstein_labels, photometry_tuple, spectra_tuple
from ..models import (
    ContraPhotoRegressionHead,
    ContraSpecRegressionHead,
    PhotoEnd2EndRegression,
    SpecEnd2EndRegression,
    VAERegressionHead,
)
from ..training import resolve_device
from ..utils.checkpoint import restore_params
from ..utils.config import (
    ContrastiveConfig,
    PhotoSpectraMMVAEConfig,
    RegressionConfig,
    parse_overrides,
)
from ..utils.rng import fold_in
from ..utils.weights import init_params
from .common import parse_cli, resolve_dataset, train_loop
from .train_contrastive import build_model as build_contrastive
from .train_photospectra import build_model as build_mmvae

MODALITIES = ("photometry", "spec")
BACKBONES = ("mmvae", "contrast", "end2end")
NORMALIZING_FILE = "goldstein_normalizing.json"


def frozen_param_mask(model: nn.Module, frozen: Optional[Mapping[str, torch.Tensor]]
                      ) -> Dict[str, bool]:
    """Parameter name → trainable: False for every parameter under a
    top-level submodule that ``frozen`` (parameter names to the installed
    backbone's tensors) fills, True for the head. ``train_loop``'s
    ``opt_mask``: AdamW never touches (not even weight-decays) the installed
    pretrained weights."""
    frozen_keys = {name.split(".", 1)[0] for name in (frozen or {})}
    return {name: name.split(".", 1)[0] not in frozen_keys
            for name, _ in model.named_parameters()}


def _load_backbone_params(ckpt_path: Optional[str], model: nn.Module, seed: int) -> nn.Module:
    """``model`` holding the parameters of the port checkpoint at
    ``ckpt_path`` (a whole train state or parameters alone), or, without
    one, fresh weights from ``fold_in(seed, 4)``."""
    init_params(model, torch.Generator().manual_seed(fold_in(seed, 4)))
    if ckpt_path:
        restore_params(ckpt_path, model)
    return model


def build_head(modality: str, backbone: str, ckpt: Optional[str] = None, seed: int = 0,
               cfg: RegressionConfig = RegressionConfig()):
    """(the regression module, the backbone parameters to install and
    freeze by name, or None for an end-to-end head). The backbone is built
    from its driver's default config and holds the checkpoint's weights."""
    if modality not in MODALITIES:
        raise ValueError(f"unknown modality {modality!r}: one of {MODALITIES}")
    mod_idx = MODALITIES.index(modality)
    if backbone == "mmvae":
        mm = _load_backbone_params(ckpt, build_mmvae(PhotoSpectraMMVAEConfig()), seed)
        head = VAERegressionHead(mm.vaes[mod_idx], cfg.outdim, mlp_hidden=cfg.mlp_hidden)
        prefix = "vae"
    elif backbone == "contrast":
        cn = _load_backbone_params(ckpt, build_contrastive(ContrastiveConfig()), seed)
        cls = ContraPhotoRegressionHead if mod_idx == 0 else ContraSpecRegressionHead
        head = cls(cn, cfg.outdim, mlp_hidden=cfg.mlp_hidden)
        prefix = "contrastnet"
    elif backbone == "end2end":
        cls = PhotoEnd2EndRegression if mod_idx == 0 else SpecEnd2EndRegression
        return cls(cfg.outdim, mlp_hidden=cfg.mlp_hidden), None
    else:
        raise ValueError(f"unknown backbone {backbone!r}: one of {BACKBONES}")
    frozen = {f"{prefix}.{k}": v.detach().clone()
              for k, v in getattr(head, prefix).state_dict().items()}
    return head, frozen


def parse_regression_cli(argv, *names):
    """Split ``name=value`` for each of ``names`` off ``argv``: ({name:
    value}, the rest)."""
    found, rest = {}, []
    for a in argv:
        key = a.split("=", 1)[0]
        if "=" in a and key in names:
            found[key] = a.split("=", 1)[1]
        else:
            rest.append(a)
    return found, rest


def label_normalization(labels: np.ndarray):
    """(mean, std) of the training labels per column: numpy's std (ddof 0)
    + 1e-8, as the JAX driver computes them."""
    return labels.mean(0), labels.std(0) + 1e-8


def paired_mse(model, batch, *, seed=None):
    """``objectives.mse`` of a batch ``(x, y)``."""
    x, y = batch
    return objectives.mse(model, x, y, seed=seed)


def main(argv=None, device=None, callback=None):
    """Train on ``device`` (default: the card); ``callback(epoch, state,
    loss)`` runs after each epoch. Returns (state, losses)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    opts, rest = parse_regression_cli(argv, "modality", "backbone", "backbone_ckpt")
    modality = opts.get("modality", "photometry")
    backbone = opts.get("backbone", "mmvae")
    data_path, rest = parse_cli(rest)
    cfg = parse_overrides(RegressionConfig(), rest)
    device = resolve_device(device)

    data = resolve_dataset(data_path, "goldstein", seed=cfg.train.seed)
    tr_idx = np.asarray(data["training_idx"])
    labels = goldstein_labels(data, tr_idx)
    mean, std = label_normalization(labels)
    labels = (labels - mean) / std
    os.makedirs(cfg.train.ckpt_dir, exist_ok=True)
    with open(os.path.join(cfg.train.ckpt_dir, NORMALIZING_FILE), "w") as f:
        json.dump({"mean": mean.tolist(), "std": std.tolist()}, f)

    builder = photometry_tuple if modality == "photometry" else spectra_tuple
    x_train = builder(data, idx=tr_idx, device=device)
    head, frozen = build_head(modality, backbone, opts.get("backbone_ckpt"), cfg.train.seed,
                              cfg)
    train_data = (x_train, torch.from_numpy(labels).to(device))

    # The backbone's weights are installed into the head's parameters and
    # masked out of the optimizer: the checkpoint then holds the whole
    # backbone (the evaluation restores everything from the head's
    # checkpoint alone), and AdamW's weight decay cannot move it.
    state, losses = train_loop(
        head, train_data, objectives.as_loss(paired_mse), cfg.train, config=cfg,
        install_params=frozen,
        opt_mask=(lambda m: frozen_param_mask(m, frozen)) if frozen else None,
        callback=callback, device=device, ckpt_name=f"goldstein_{modality}2param_{backbone}",
    )
    print(f"final loss: {losses[-1]:.6f}")
    return state, losses


if __name__ == "__main__":
    main()
