"""The system under test as a cell builds it: the port's configuration
class filled from the cell's configuration file at the file's precision,
the model its driver builds, the benchmark's weights, and the synthetic
data.
"""

from __future__ import annotations

import dataclasses
import importlib
import os


from . import core, datagen
from .reference.model import dims_of, parameter_shapes

EXPERIMENTS = "vaesne_tpu_torch.experiments."


def precision(config: dict) -> str:
    """Put the port in the configuration's ``precision`` (``VAESNE_BF16``,
    which the port reads) and return it. Only fp32 (TF32 off) is taken:
    the checks' limits and control are set for it, and a lower precision
    needs its own."""
    p = config["precision"]
    if p != "fp32":
        raise ValueError(f"precision {p!r}: the benchmark's checks are set for fp32 alone")
    os.environ["VAESNE_BF16"] = "0"
    return p


def port_config(config: dict, **train):
    """The port's configuration (``config["class"]``) with the file's model
    and training keys, and ``train`` on top."""
    from vaesne_tpu_torch.utils import config as port

    cfg = getattr(port, config["class"])()

    def fill(obj, values):
        names = {f.name for f in dataclasses.fields(obj)}
        return dataclasses.replace(obj, **{k: v for k, v in values.items() if k in names})

    cfg = dataclasses.replace(cfg, model=fill(cfg.model, config["model"]),
                              train=fill(cfg.train, {**config["train"], **train}))
    return fill(cfg, {k: v for k, v in config.items() if k not in ("model", "train")})


def build_model(config: dict, cfg):
    """The experiment module's ``build_model(cfg)``; its parameters must be the
    reference's, name for name and shape for shape."""
    model = importlib.import_module(EXPERIMENTS + config["experiment"]).build_model(cfg)
    have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = parameter_shapes(dims_of(config))
    if have != want:
        raise ValueError(f"the port's {config['experiment']} model and the reference differ: "
                         f"{sorted(set(have) ^ set(want))[:5]} "
                         f"{[k for k in have if k in want and have[k] != want[k]][:5]}")
    return model


def weights(config: dict, seed: int, device):
    """The run's initial weights, made on the card from the seed."""
    return core.make_weights(parameter_shapes(dims_of(config)), core.derive(seed, 3), device)


def data(config: dict, seed: int):
    """The run's raw synthetic data set (numpy, the npz key contract)."""
    make = datagen.make_ztf_like if config["data"] == "ztf" else datagen.make_goldstein_like
    return make(n=config["synthetic_events"], seed=core.derive(seed, 2),
                spectrum_bins=config["spectrum_bins"],
                photometry_length=config["photometry_points"])
