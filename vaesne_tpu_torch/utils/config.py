"""Experiment configuration of the port: one frozen dataclass per driver.

The port's own copy of ``vaesne_tpu/utils/config.py``: the same classes,
fields and defaults, ``parse_overrides`` with the same coercion from each
field's default, ``asdict``, ``from_dict`` and ``CONFIG_CLASSES``. A
``config.json`` written by either package therefore reads into the other,
key for key. The device a run uses is not a field (drivers take it as an
argument), so the files stay the JAX package's.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Sequence, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Shared transformer-VAE hyperparameters."""

    latent_len: int = 4
    latent_dim: int = 4
    model_dim: int = 32
    num_heads: int = 4
    ff_dim: int = 32
    num_layers: int = 4
    dropout: float = 0.1
    selfattn: bool = False
    concat: bool = True
    # the Bright* variants: the decoded mean recentred to a brightness read
    # from latent token 0, for every driver whose model has a Bright form
    bright: bool = False


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 2.5e-4
    epochs: int = 200
    batch_size: int = 32
    seed: int = 0
    K: int = 1
    beta: float = 1.0
    save_every: int = 5
    # the JAX package's choice of one lax.scan per epoch; the port's
    # train_loop runs make_scan_epoch's eager loop whatever its value
    scan_epoch: bool = True
    # "auto", "none" and "1" train on one card; a multi-device spec raises
    mesh: str = "auto"
    ckpt_dir: str = "./ckpt"
    log_dir: str = "./logs"
    weight_decay: float = 1e-2
    b1: float = 0.9
    b2: float = 0.999
    # global-norm clip ahead of AdamW; <= 0 disables it
    grad_clip: float = 10.0
    accum_steps: int = 1
    accum_reduction: str = "mean"  # "sum" for batch-sum objectives (m_iwae)
    resume: bool = False
    # the reference's dynamics: no clip, one augmentation draw before training
    parity: bool = False


@dataclass(frozen=True)
class PhotometryVAEConfig:
    """Goldstein photometry VAE."""

    model: ModelConfig = field(default_factory=lambda: ModelConfig(
        latent_len=4, latent_dim=2, model_dim=32, ff_dim=32))
    train: TrainConfig = field(default_factory=lambda: TrainConfig(
        lr=2.5e-4, epochs=200, batch_size=32, beta=0.5))
    num_bands: int = 6


@dataclass(frozen=True)
class SpectraVAEConfig:
    """Goldstein spectra VAE."""

    model: ModelConfig = field(default_factory=lambda: ModelConfig(
        latent_len=4, latent_dim=4, model_dim=32, ff_dim=32))
    train: TrainConfig = field(default_factory=lambda: TrainConfig(
        lr=2.5e-4, epochs=200, batch_size=32, beta=1.0))


@dataclass(frozen=True)
class PhotoSpectraMMVAEConfig:
    """Goldstein photometry + spectra MoE-MMVAE, the flagship."""

    model: ModelConfig = field(default_factory=lambda: ModelConfig(
        latent_len=4, latent_dim=4, model_dim=32, ff_dim=32))
    # m_iwae sums over the batch, so accumulated microbatch gradients sum
    train: TrainConfig = field(default_factory=lambda: TrainConfig(
        lr=1e-4, epochs=200, batch_size=16, K=2, beta=1.0,
        accum_reduction="sum"))
    num_bands: int = 6


@dataclass(frozen=True)
class ContrastiveConfig:
    """Goldstein contrastive two-tower network."""

    model: ModelConfig = field(default_factory=lambda: ModelConfig(
        latent_len=4, latent_dim=4, model_dim=32, ff_dim=32))
    train: TrainConfig = field(default_factory=lambda: TrainConfig(
        lr=2.5e-4, epochs=500, batch_size=32))
    proj_dim: int = 8
    temperature: float = 0.1
    num_bands: int = 6


@dataclass(frozen=True)
class ZTFMMVAEConfig:
    """ZTF photometry + spectra MMVAE."""

    model: ModelConfig = field(default_factory=lambda: ModelConfig(
        latent_len=4, latent_dim=4, model_dim=32, ff_dim=32))
    train: TrainConfig = field(default_factory=lambda: TrainConfig(
        lr=1e-3, epochs=200, batch_size=32, K=8, beta=0.5,
        accum_reduction="sum"))
    num_bands: int = 2
    repeat_factor: int = 10


@dataclass(frozen=True)
class ZTFSpectraConfig:
    """ZTF spectra-only VAE."""

    model: ModelConfig = field(default_factory=lambda: ModelConfig(
        latent_len=4, latent_dim=4, model_dim=32, ff_dim=32))
    train: TrainConfig = field(default_factory=lambda: TrainConfig(
        lr=1e-3, epochs=200, batch_size=32, beta=0.5))
    repeat_factor: int = 10
    extra_mask_prob: float = 0.075


@dataclass(frozen=True)
class ImageVAEConfig:
    """ZTF host-image VAE."""

    img_size: int = 60
    patch_size: int = 2
    in_channels: int = 3
    hybrid: bool = True
    focal_loc: bool = False
    model: ModelConfig = field(default_factory=lambda: ModelConfig(
        latent_len=4, latent_dim=4, model_dim=32, ff_dim=32))
    train: TrainConfig = field(default_factory=lambda: TrainConfig(
        lr=1e-3, epochs=150, batch_size=32, beta=0.5))
    aug_factor: int = 5


@dataclass(frozen=True)
class RegressionConfig:
    """Goldstein parameter regression."""

    outdim: int = 4
    mlp_hidden: Tuple[int, ...] = (128, 128, 128, 128)
    train: TrainConfig = field(default_factory=lambda: TrainConfig(
        lr=1e-3, epochs=100, batch_size=32))


def parse_overrides(cfg, argv: Sequence[str]):
    """Apply ``key=value`` / ``section.key=value`` overrides to a (nested)
    frozen dataclass, each value coerced to the type of the field's
    current value."""
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"override must be key=value, got {arg!r}")
        dotted, raw = arg.split("=", 1)
        cfg = _override(cfg, dotted.split("."), raw)
    return cfg


def _coerce(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    return raw


def _override(cfg, path, raw):
    name, rest = path[0], path[1:]
    current = getattr(cfg, name)
    if rest:
        return dataclasses.replace(cfg, **{name: _override(current, rest, raw)})
    return dataclasses.replace(cfg, **{name: _coerce(raw, current)})


def asdict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def from_dict(cls, d: Dict[str, Any]):
    """Rebuild a (nested) config dataclass from ``asdict`` output. Unknown
    keys (and the ``_config_class`` tag) are ignored, nested dataclass
    fields recurse, and lists become tuples (JSON has no tuples)."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        hint = hints.get(f.name)
        if dataclasses.is_dataclass(hint) and isinstance(v, dict):
            v = from_dict(hint, v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


# the ``_config_class`` tag a checkpoint's config.json carries names one of
# these (utils.checkpoint.restore_config)
CONFIG_CLASSES = {
    c.__name__: c
    for c in (
        PhotometryVAEConfig,
        SpectraVAEConfig,
        PhotoSpectraMMVAEConfig,
        ContrastiveConfig,
        ZTFMMVAEConfig,
        ZTFSpectraConfig,
        ImageVAEConfig,
        RegressionConfig,
    )
}
