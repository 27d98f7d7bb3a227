"""Import PyTorch-reference weights straight into the port's modules.

The counterpart of ``vaesne_tpu/utils/torch_port.py``: a state dict of the
original PyTorch VAESNe (``torch.save(model.state_dict())``, or one taken
from a whole-module pickle) maps onto the state dict of the matching
``vaesne_tpu_torch`` model, which loads it with
``load_state_dict(strict=True)``. The result is the JAX package's
converter followed by ``utils.weights.load_jax_params``, without flax in
between: both sides keep torch's layouts, so no value is transposed (a
Linear's [out, in] weight and a Conv2d's [out, in, kh, kw] kernel stay as
they are).

Name rules (reference → port):
  * ``nn.Linear``, ``nn.Conv2d``, ``nn.LayerNorm``, ``nn.Embedding``:
    ``weight``/``bias`` as they are
  * ``nn.MultiheadAttention``: the packed ``in_proj_weight`` [3E, E] and
    ``in_proj_bias`` [3E] split by rows into ``q_proj``, ``k_proj``,
    ``v_proj``; ``out_proj`` as it is
  * reference ``MLP`` (Sequential ``mlp.{0,2,...}``, ReLUs in the odd slots,
    which hold no parameters) → ``hidden_i``/``out``
  * ``singlelayerMLP`` and ``SinusoidalMLPPositionalEmbedding``: ``fc1``,
    ``fc2``
  * ``TransformerBlock``: ``ffn.0``/``ffn.2`` → ``ffn_0``/``ffn_2``;
    ``transformerblocks.i`` → ``blocks.block_i``
  * the towers: ``enc.inference_transformer`` → ``enc``,
    ``dec.generativetransformer`` → ``dec``; the spectra encoder's
    ``phase_embd_layer``/``wavelength_embd_layer`` → ``phase_embd``/
    ``wavelength_embd``; the hybrid image decoder's ``final_refine.0``/
    ``.2`` → ``refine_0``/``refine_1``; the image encoder's learned
    ``pos_embed`` [1, N, D] → [N, D]

Every converter takes a state dict (torch tensors or numpy arrays) and a
name prefix, and returns ``{port name: torch.Tensor}`` relative to the
module it converts, on the CPU. ``to_reference_state_dict`` is the
inverse: a port model's state dict under the reference's names.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Dict, Mapping

import numpy as np
import torch

Flat = Dict[str, np.ndarray]
State = Dict[str, torch.Tensor]


def numpy_state_dict(state_dict) -> Flat:
    """torch state_dict → {name: np.ndarray} (detached, on host)."""
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in state_dict.items()}


def _as_torch(state_dict: Mapping) -> State:
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v)) for k, v in state_dict.items()}


def _under(scope: str, state: State) -> State:
    return {f"{scope}.{k}": v for k, v in state.items()}


def _linear(sd: State, p: str) -> State:
    """Linear, Conv2d and LayerNorm alike: weight and bias."""
    return {"weight": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}


def _embedding(sd: State, p: str) -> State:
    return {"weight": sd[f"{p}.weight"]}


def _mha(sd: State, p: str) -> State:
    w = sd[f"{p}.in_proj_weight"]  # [3E, E]
    b = sd[f"{p}.in_proj_bias"]  # [3E]
    e = w.shape[1]
    out = {}
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"{name}.weight"] = w[i * e:(i + 1) * e]
        out[f"{name}.bias"] = b[i * e:(i + 1) * e]
    out.update(_under("out_proj", _linear(sd, f"{p}.out_proj")))
    return out


def _fc12(sd: State, p: str) -> State:
    """``singlelayerMLP`` and ``SinusoidalMLPPositionalEmbedding``."""
    return {**_under("fc1", _linear(sd, f"{p}.fc1")), **_under("fc2", _linear(sd, f"{p}.fc2"))}


def _mlp(sd: State, p: str) -> State:
    """Reference MLP: Sequential Linear/ReLU pairs and a final Linear →
    ``hidden_i``, ``out`` (the ReLU slots hold no parameters)."""
    idxs = sorted({int(k[len(p) + 5:].split(".")[0]) for k in sd if k.startswith(f"{p}.mlp.")})
    out = {}
    for n, i in enumerate(idxs[:-1]):
        out.update(_under(f"hidden_{n}", _linear(sd, f"{p}.mlp.{i}")))
    out.update(_under("out", _linear(sd, f"{p}.mlp.{idxs[-1]}")))
    return out


def _transformer_block(sd: State, p: str) -> State:
    out = {**_under("self_attn", _mha(sd, f"{p}.self_attn")),
           **_under("cross_attn", _mha(sd, f"{p}.cross_attn"))}
    for name in ("layernorm1", "layernorm2", "layernorm3"):
        out.update(_under(name, _linear(sd, f"{p}.{name}")))
    out.update(_under("ffn_0", _linear(sd, f"{p}.ffn.0")))
    out.update(_under("ffn_2", _linear(sd, f"{p}.ffn.2")))
    if f"{p}.context_self_attn.in_proj_weight" in sd:
        out.update(_under("context_self_attn", _mha(sd, f"{p}.context_self_attn")))
        out.update(_under("layernorm_context", _linear(sd, f"{p}.layernorm_context")))
    return out


def _blocks(sd: State, p: str) -> State:
    n = len({k.split(".")[len(p.split("."))] for k in sd if k.startswith(f"{p}.")})
    out = {}
    for i in range(n):
        out.update(_under(f"block_{i}", _transformer_block(sd, f"{p}.{i}")))
    return out


def convert_photometric_encoder(sd, p: str = "enc.inference_transformer") -> State:
    """photometricTransformerEncoder → ``PhotometricTransformerEncoder``."""
    sd = _as_torch(sd)
    out = {"initbottleneck": sd[f"{p}.initbottleneck"],
           **_under("bottleneckfc", _fc12(sd, f"{p}.bottleneckfc")),
           **_under("blocks", _blocks(sd, f"{p}.transformerblocks")),
           **_under("bandembd", _embedding(sd, f"{p}.bandembd")),
           **_under("fluxfc", _linear(sd, f"{p}.fluxfc"))}
    if f"{p}.time_embd.fc1.weight" in sd:  # concat=True: MLP time embedding
        out.update(_under("time_embd", _fc12(sd, f"{p}.time_embd")))
        out.update(_under("LCfc", _mlp(sd, f"{p}.LCfc")))
    return out


def convert_photometric_decoder(sd, p: str = "dec.generativetransformer") -> State:
    """photometricTransformerDecoder → ``PhotometricTransformerDecoder``."""
    sd = _as_torch(sd)
    return {**_under("blocks", _blocks(sd, f"{p}.transformerblocks")),
            **_under("sinusoidal_time_embd", _fc12(sd, f"{p}.sinusoidal_time_embd")),
            **_under("bandembd", _embedding(sd, f"{p}.bandembd")),
            **_under("contextfc", _mlp(sd, f"{p}.contextfc")),
            **_under("get_photo", _fc12(sd, f"{p}.get_photo"))}


def convert_spectra_encoder(sd, p: str = "enc.inference_transformer") -> State:
    """spectraTransformerEncoder → ``SpectraTransformerEncoder``."""
    sd = _as_torch(sd)
    out = {"initbottleneck": sd[f"{p}.initbottleneck"],
           **_under("bottleneckfc", _fc12(sd, f"{p}.bottleneckfc")),
           **_under("blocks", _blocks(sd, f"{p}.transformerblocks")),
           **_under("flux_embd", _linear(sd, f"{p}.flux_embd")),
           **_under("phase_embd", _fc12(sd, f"{p}.phase_embd_layer"))}
    if f"{p}.spectrafc.mlp.0.weight" in sd:  # concat=True: plain sinusoidal wavelengths
        out.update(_under("spectrafc", _mlp(sd, f"{p}.spectrafc")))
    else:
        out.update(_under("wavelength_embd", _fc12(sd, f"{p}.wavelength_embd_layer")))
    return out


def convert_spectra_decoder(sd, p: str = "dec.generativetransformer") -> State:
    """spectraTransformerDecoder → ``SpectraTransformerDecoder``."""
    sd = _as_torch(sd)
    return {**_under("blocks", _blocks(sd, f"{p}.transformerblocks")),
            **_under("wavelength_embd_layer", _fc12(sd, f"{p}.wavelength_embd_layer")),
            **_under("phase_embd_layer", _fc12(sd, f"{p}.phase_embd_layer")),
            **_under("contextfc", _mlp(sd, f"{p}.contextfc")),
            **_under("get_flux", _fc12(sd, f"{p}.get_flux"))}


def convert_photometric_vae(state_dict) -> State:
    """Reference ``PhotometricVAE``/``BrightPhotometricVAE`` → the port's
    (the Bright variant's ``brightnessfc`` MLP is detected by key)."""
    sd = _as_torch(state_dict)
    out = {**_under("enc", convert_photometric_encoder(sd)),
           **_under("dec", convert_photometric_decoder(sd))}
    if "brightnessfc.mlp.0.weight" in sd:
        out.update(_under("brightnessfc", _mlp(sd, "brightnessfc")))
    return out


def convert_spectra_vae(state_dict) -> State:
    """Reference ``SpectraVAE``/``BrightSpectraVAE`` → the port's."""
    sd = _as_torch(state_dict)
    out = {**_under("enc", convert_spectra_encoder(sd)),
           **_under("dec", convert_spectra_decoder(sd))}
    if "brightnessfc.mlp.0.weight" in sd:
        out.update(_under("brightnessfc", _mlp(sd, "brightnessfc")))
    return out


def convert_photospec_mmvae(state_dict) -> State:
    """Reference ``photospecMMVAE`` → the port's ``PhotoSpecMMVAE``
    (``vaes.0`` photometry, ``vaes.1`` spectra, on both sides)."""
    sd = _as_torch(state_dict)
    photo = {k[len("vaes.0."):]: v for k, v in sd.items() if k.startswith("vaes.0.")}
    spec = {k[len("vaes.1."):]: v for k, v in sd.items() if k.startswith("vaes.1.")}
    return {**_under("vaes.0", convert_photometric_vae(photo)),
            **_under("vaes.1", convert_spectra_vae(spec))}


def convert_hostimg_encoder(sd, p: str = "enc.inference_transformer") -> State:
    """HostImgTransformerEncoder → the port's. The default 2-D sin-cos
    position table is computed on both sides (no parameters); a learned
    one (``sincosin=False``) drops its leading axis."""
    sd = _as_torch(sd)
    out = {"initbottleneck": sd[f"{p}.initbottleneck"],
           **_under("patch_embed.proj", _linear(sd, f"{p}.patch_embed.proj")),
           **_under("bottleneckfc", _fc12(sd, f"{p}.bottleneckfc")),
           **_under("blocks", _blocks(sd, f"{p}.transformerblocks"))}
    if f"{p}.pos_embed" in sd:
        out["pos_embed"] = sd[f"{p}.pos_embed"][0]
    if f"{p}.eventloc_embd.fc1.weight" in sd:
        out.update(_under("eventloc_embd", _fc12(sd, f"{p}.eventloc_embd")))
    return out


def convert_hostimg_decoder(sd, p: str = "dec.generativetransformer") -> State:
    """HostImgTransformerDecoder / ...Hybrid → the port's; the hybrid is
    detected by its ``final_refine`` convolutions, the per-pixel MLP
    decoder by ``decoder.mlp``."""
    sd = _as_torch(sd)
    out = {**_under("contextfc", _mlp(sd, f"{p}.contextfc")),
           **_under("blocks", _blocks(sd, f"{p}.transformerblocks"))}
    if f"{p}.final_refine.0.weight" in sd:  # hybrid
        out.update(_under("decoder", _linear(sd, f"{p}.decoder")))
        out.update(_under("refine_0", _linear(sd, f"{p}.final_refine.0")))
        out.update(_under("refine_1", _linear(sd, f"{p}.final_refine.2")))
    elif f"{p}.decoder.mlp.0.weight" in sd:  # per-pixel MLP decoder
        out.update(_under("decoder", _mlp(sd, f"{p}.decoder")))
    else:  # per-pixel Linear decoder
        out.update(_under("decoder", _linear(sd, f"{p}.decoder")))
    return out


def convert_hostimg_vae(state_dict) -> State:
    """Reference ``HostImgVAE`` → the port's ``HostImgVAE``."""
    sd = _as_torch(state_dict)
    return {**_under("enc", convert_hostimg_encoder(sd)),
            **_under("dec", convert_hostimg_decoder(sd))}


def convert_contrastive(state_dict) -> State:
    """Reference ``ContraPhotSpec`` → the port's ``ContraPhotSpec`` (the
    towers are the modality encoders)."""
    sd = _as_torch(state_dict)
    return {**_under("photometry_encoder",
                     convert_photometric_encoder(sd, "photometry_encoder")),
            **_under("photo_proj", _fc12(sd, "photo_proj")),
            **_under("spectra_encoder", convert_spectra_encoder(sd, "spectra_encoder")),
            **_under("spectra_proj", _fc12(sd, "spectra_proj"))}


# the inverse, port name → reference name, applied in this order
_TO_REFERENCE = [
    (re.compile(r"(^|\.)enc\."), r"\1enc.inference_transformer."),
    (re.compile(r"(^|\.)dec\."), r"\1dec.generativetransformer."),
    (re.compile(r"(^|\.)blocks\.block_(\d+)\."), r"\1transformerblocks.\2."),
    (re.compile(r"\.ffn_(\d+)\."), r".ffn.\1."),
    (re.compile(r"\.refine_0\."), r".final_refine.0."),
    (re.compile(r"\.refine_1\."), r".final_refine.2."),
    (re.compile(r"\.(phase|wavelength)_embd\."), r".\1_embd_layer."),
]
_HIDDEN = re.compile(r"^(?:(.*)\.)?hidden_(\d+)\.weight$")
_QKV = re.compile(r"^(.*)\.([qkv])_proj\.(weight|bias)$")


def to_reference_state_dict(state_dict: Mapping[str, torch.Tensor]) -> State:
    """A port model's state dict under the reference's names, as the
    reference model's ``state_dict()`` holds them: the converters' inverse
    (``convert_*(to_reference_state_dict(sd))`` is ``sd``). For handing a
    port model back to the reference, and for stand-in reference files."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    hidden: Dict[str, int] = {}  # MLP prefix → hidden layers
    for k in sd:
        m = _HIDDEN.match(k)
        if m:
            scope = m.group(1) or ""
            hidden[scope] = max(hidden.get(scope, 0), int(m.group(2)) + 1)
    out: State = {}
    for k, v in sd.items():
        m = _QKV.match(k)
        if m:
            if m.group(2) == "q":
                stem, leaf = m.group(1), m.group(3)
                v = torch.cat([sd[f"{stem}.{c}_proj.{leaf}"] for c in "qkv"])
                k = f"{stem}.in_proj_{leaf}"
            else:
                continue
        else:
            stem, _, leaf = k.rpartition(".")
            scope, _, last = stem.rpartition(".")
            if last.startswith("hidden_") and scope in hidden:
                k = f"{scope}.mlp.{2 * int(last[7:])}.{leaf}".lstrip(".")
            elif last == "out" and scope in hidden:
                k = f"{scope}.mlp.{2 * hidden[scope]}.{leaf}".lstrip(".")
            elif k.endswith("pos_embed"):
                v = v[None]
        for pattern, repl in _TO_REFERENCE:
            k = pattern.sub(repl, k)
        out[k] = v
    return out


# -- whole-module pickle import ------------------------------------------------
#
# The reference ships checkpoints as whole-module pickles (``torch.save(model)``,
# loaded with ``torch.load(..., weights_only=False)``), which unpickle only
# with the original ``VAESNe`` package importable. These helpers make that
# the first step of a migration: pickle → state_dict → the converters above
# → the port's state dict.

_PICKLE_CONVERTERS = {
    # reference class name → (converter, vaesne_tpu_torch model family)
    "photospecMMVAE": ("convert_photospec_mmvae", "PhotoSpecMMVAE"),
    "MMVAE": ("convert_photospec_mmvae", "PhotoSpecMMVAE"),
    "SpectraVAE": ("convert_spectra_vae", "SpectraVAE"),
    "BrightSpectraVAE": ("convert_spectra_vae", "BrightSpectraVAE"),
    "PhotometricVAE": ("convert_photometric_vae", "PhotometricVAE"),
    "BrightPhotometricVAE": ("convert_photometric_vae", "BrightPhotometricVAE"),
    "HostImgVAE": ("convert_hostimg_vae", "HostImgVAE"),
    "ContraPhotSpec": ("convert_contrastive", "ContraPhotSpec"),
}


def load_reference_pickle(path: str, package_path: str | None = None):
    """Load a reference whole-module pickle; returns (flat numpy state_dict,
    reference class name).

    .. warning:: **Only run this on checkpoint files you trust.** A whole
       ``nn.Module`` pickle loads only with ``torch.load(weights_only=False)``:
       unpickling EXECUTES arbitrary code embedded in the file, and resolving
       the pickle's class references imports (i.e. executes) the reference
       ``VAESNe`` package from ``package_path``. A plain
       ``torch.save(model.state_dict())`` file avoids both: it loads without
       any package on ``sys.path`` and is the format to ask collaborators
       for.

    ``package_path``: the directory holding the ``VAESNe`` package, so the
    pickle's class references resolve (default: ``$VAESNE_REFERENCE``).
    Pickles that are plain state_dicts need no package; their class name
    is ``None``.
    """
    pkg = package_path or os.environ.get("VAESNE_REFERENCE")
    added = False
    if pkg and os.path.isdir(pkg) and pkg not in sys.path:
        sys.path.insert(0, pkg)
        added = True
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    finally:
        if added:
            sys.path.remove(pkg)
    if hasattr(obj, "state_dict"):
        return numpy_state_dict(obj.state_dict()), type(obj).__name__
    if isinstance(obj, dict):
        return {k: np.asarray(v.detach().cpu().numpy()) if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in obj.items()}, None
    raise TypeError(
        f"{path} unpickled to {type(obj).__name__}; expected an nn.Module "
        "or a state_dict")


def import_reference_pickle(path: str, package_path: str | None = None,
                            class_name: str | None = None, device=None) -> State:
    """One-call migration: reference pickle → the port's state dict, its
    tensors on ``device`` (default: the card, ``training.resolve_device``).

    Dispatches on the pickled module's class (or an explicit ``class_name``
    for plain-state_dict pickles). The result loads with
    ``load_state_dict(strict=True)`` into the matching ``vaesne_tpu_torch``
    model built with the SAME hyperparameters the reference model was built
    with (the reference encodes them in its checkpoint's file name; the
    weights give them only through their shapes). See
    ``load_reference_pickle`` for the trust warning."""
    from ..training import resolve_device

    device = resolve_device(device)
    sd, cls = load_reference_pickle(path, package_path)
    cls = class_name or cls
    if cls is None:
        raise ValueError(
            f"{path} is a bare state_dict; pass class_name= (one of "
            f"{sorted(_PICKLE_CONVERTERS)}) to pick the converter")
    if cls not in _PICKLE_CONVERTERS:
        raise ValueError(
            f"no converter for reference class {cls!r}; supported: "
            f"{sorted(_PICKLE_CONVERTERS)}")
    conv_name, _ = _PICKLE_CONVERTERS[cls]
    return {k: v.to(device) for k, v in globals()[conv_name](sd).items()}
