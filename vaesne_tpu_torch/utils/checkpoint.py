"""Checkpoints of the port: the whole train state plus the run's config.

The counterpart of ``vaesne_tpu/utils/checkpoint.py``, with the directory
layout of the JAX package beside one file of its own:

  config.json     the config dict (with its ``_config_class`` tag), as the
                  JAX package writes it, so either package reads it
  losses.npy      per-epoch losses }  written by
  progress.json   epochs done      }  experiments.common.train_loop
  state.pt        ``TrainState.state_dict()`` (parameters, AdamW moments,
                  step, the step generator's state) in one ``torch.save``
                  file, written to a temporary name and then renamed; or,
                  from ``save_params``, the parameters alone, which can be
                  served and evaluated but not resumed

The JAX package keeps its state in an Orbax ``state/`` directory instead.
The port reads no such directory and writes into none: restoring from one,
or saving into a directory that holds one, raises an error that names the
format (bridge a JAX checkpoint's parameters with
``utils.weights.load_jax_params``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..training import TrainState

STATE_FILE = "state.pt"


def checkpoint_name(
    dataset: str,
    model: str,
    latent_len: int,
    latent_dim: int,
    lr: float,
    epochs: int,
    K: Optional[int] = None,
    beta: Optional[float] = None,
    model_dim: Optional[int] = None,
    **extra,
) -> str:
    """The reference's name:
    ``{dataset}_{model}_{len}-{dim}_{lr}_{epochs}[_K{K}][_beta{β}][_modeldim{D}]...``."""
    parts = [f"{dataset}_{model}_{latent_len}-{latent_dim}_{lr}_{epochs}"]
    if K is not None:
        parts.append(f"K{K}")
    if beta is not None:
        parts.append(f"beta{beta}")
    if model_dim is not None:
        parts.append(f"modeldim{model_dim}")
    parts.extend(f"{k}{v}" for k, v in extra.items())
    return "_".join(parts)


def has_state(path: str) -> bool:
    """True where ``path`` holds the port's state file."""
    return os.path.isfile(os.path.join(path, STATE_FILE))


def check_format(path: str) -> None:
    """Raise if ``path`` holds the JAX package's Orbax ``state/``
    directory: the port neither reads nor overwrites that checkpoint."""
    if os.path.isdir(os.path.join(path, "state")):
        raise ValueError(
            f"{path!r} holds a JAX (Orbax) checkpoint: a 'state/' directory, which the "
            f"PyTorch port neither restores nor overwrites. Restore it with "
            f"vaesne_tpu.utils.checkpoint and bridge its parameters with "
            f"vaesne_tpu_torch.utils.load_jax_params, or train under another "
            f"train.ckpt_dir or checkpoint name.")


def _save(path: str, state: Dict[str, Any], config: Optional[Dict[str, Any]]) -> None:
    path = os.path.abspath(path)
    check_format(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)


def save_checkpoint(path: str, state, config: Optional[Dict[str, Any]] = None) -> None:
    """Save the whole train state, a ``TrainState`` or its
    ``state_dict()`` (a tensor-parallel run's gathered one), and the config
    as JSON, into the directory ``path``."""
    _save(path, state.state_dict() if isinstance(state, TrainState) else state, config)


def save_params(path: str, model: nn.Module,
                config: Optional[Dict[str, Any]] = None) -> None:
    """Save ``model``'s parameters alone (and the config as JSON) into the
    directory ``path``: what a JAX checkpoint's bridged parameters become.
    ``restore_params`` and ``InferenceServer.from_checkpoint`` read it;
    ``restore_checkpoint`` refuses it, as it holds no optimizer state."""
    _save(path, {"model": model.state_dict()}, config)


def _load(path: str) -> Dict[str, Any]:
    path = os.path.abspath(path)
    check_format(path)
    if not has_state(path):
        raise FileNotFoundError(f"no {STATE_FILE} under {path!r}")
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def _check_architecture(path: str, saved: Dict[str, torch.Tensor], model: nn.Module) -> None:
    """Raise, naming the differences, where the saved parameters do not fit
    ``model``: the checkpoint was trained with another architecture."""
    own = model.state_dict()
    missing, unused = sorted(set(own) - set(saved)), sorted(set(saved) - set(own))
    shapes = [f"{k}: saved {tuple(saved[k].shape)} vs model {tuple(own[k].shape)}"
              for k in own if k in saved and saved[k].shape != own[k].shape]
    if missing or unused or shapes:
        raise ValueError(
            f"checkpoint at {path!r} holds another model architecture than the one "
            f"given (rebuild it through restore_config and the driver's build_model). "
            f"Parameters the model lacks: {unused[:3]}; parameters the checkpoint "
            f"lacks: {missing[:3]}; shapes that differ: {shapes[:3]}.")


def restore_params(path: str, model: nn.Module) -> nn.Module:
    """Load the parameters of the checkpoint at ``path`` into ``model``."""
    saved = _load(path)["model"]
    _check_architecture(path, saved, model)
    model.load_state_dict(saved)
    return model


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore the checkpoint at ``path`` into ``state`` (its model and
    optimizer built as for the run that saved it) and return it. A
    mismatch says whether the architecture or the optimizer differs."""
    saved = _load(path)
    if "optimizer" not in saved:
        raise ValueError(
            f"checkpoint at {path!r} holds parameters only (no AdamW moments, step or "
            f"generator state): serve or evaluate it through restore_params, but a run "
            f"cannot resume from it")
    _check_architecture(path, saved["model"], state.model)
    try:
        state.load_state_dict(saved)
    except (ValueError, KeyError) as e:
        raise ValueError(
            f"checkpoint at {path!r} fits the model but not the optimizer: it was "
            f"saved by another optimizer (a different set of parameter groups or "
            f"trainable parameters). Original error: {e}") from e
    return state


def load_config(path: str) -> Optional[Dict[str, Any]]:
    cfg = os.path.join(os.path.abspath(path), "config.json")
    if not os.path.exists(cfg):
        return None
    with open(cfg) as f:
        return json.load(f)


def restore_config(path: str, expected_cls=None):
    """Rebuild the config a checkpoint was trained with, from its
    ``config.json`` (its ``_config_class`` tag picks the class). None where
    the checkpoint has no config.json; raises where the tag names another
    class than ``expected_cls``, or names none and ``expected_cls`` is not
    given."""
    d = load_config(path)
    if d is None:
        return None
    from .config import CONFIG_CLASSES, from_dict

    name = d.get("_config_class")
    cls = CONFIG_CLASSES.get(name) if name else None
    if expected_cls is not None:
        if cls is not None and cls is not expected_cls:
            raise ValueError(
                f"checkpoint at {path!r} was trained as {name}, but this "
                f"driver expects {expected_cls.__name__}"
            )
        cls = expected_cls
    if cls is None:
        raise ValueError(
            f"checkpoint config at {path!r} has unknown _config_class "
            f"{name!r}; pass the matching driver or re-save the config"
        )
    return from_dict(cls, d)
