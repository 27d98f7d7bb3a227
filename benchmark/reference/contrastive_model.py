"""The plain reference of VAESNe's contrastive two-tower network.

Plain PyTorch over a dict of parameters named as the system under test
names them (``spectra_encoder.blocks.block_0.context_self_attn.q_proj.weight``,
``photo_proj.fc1.weight``, ...), on the blocks of the MoE-MMVAE's reference
(``model.Net``): no kernel, no cache. It follows the published model
(YunyiShen/VAESNe-dev, ``cannon/test_photospectra_contrast.py``,
``contrastiveNets.ContraPhotSpec``, ``losses.negInfoNCE``):

  * two perceiver towers, the photometric one over the light curve and the
    spectra one over the spectrum and its phase token, each with
    ``latent_len`` learned bottleneck tokens (no mu/scale split), post-LN
    blocks and a one-hidden-layer MLP to ``latent_dim``; the spectra tower
    reads the wavelength through its linear path and the flux through its
    sinusoid, as the published model does;
  * with ``selfattn`` every block first lets the context attend to itself
    (``ctx = LN_ctx(ctx + drop(SelfAttn(ctx, key_padding_mask)))``, dropout
    sites 2 and 3) before the bottleneck cross-attends to it;
  * a projection head per tower, fc(L·D → L·D) → ReLU → fc(L·D → proj);
  * the symmetric InfoNCE: each projection normalised (norm clipped at
    1e-12), logits z1·z2ᵀ/τ, the mean of the two cross-entropies against
    the diagonal, negated.

Each tower of a training step draws its dropout from ``fold_in(seed, 0)``
(photometry) or ``fold_in(seed, 1)`` (spectra), block i from
``fold_in(that, i)`` and site s of a block from ``fold_in(block, s)``. A
pass works on a block of events of the whole batch (``model.Rows``): the
dropout masks are drawn for the whole batch and the block keeps its rows.
Departures from upstream: none in what is computed; upstream's torch
dropout draws come from torch's global generator, these from the seeds.

The ReLUs whose every input carries a whole event (``EVENT_RELUS``: each
tower's bottleneck MLP, one input a latent token, and each projection head)
can show their inputs (``seen``) and take their derivative flipped at chosen
inputs (``flips``), their value unchanged: ReLU's derivative steps at zero,
so where an input lies within round-off of zero a sound fp32 program may
take either side, and ``contrastive_train`` follows both.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import rng
from .model import Net, Rows, dims_of, gelu


def parameter_shapes(config: dict) -> Dict[str, tuple]:
    """Every parameter of the two-tower network, by name, with its shape."""
    d = dims_of(config)
    E, F, D, L = d.model_dim, d.ff_dim, d.latent_dim, d.latent_len
    P, selfattn = config["proj_dim"], config["model"]["selfattn"]
    out: Dict[str, tuple] = {}

    def linear(name, i, o):
        out[f"{name}.weight"] = (o, i)
        out[f"{name}.bias"] = (o,)

    def ln(name):
        out[f"{name}.weight"] = (E,)
        out[f"{name}.bias"] = (E,)

    def stack(name):
        for i in range(d.num_layers):
            b = f"{name}.block_{i}"
            attentions = ("self_attn", "cross_attn") + (("context_self_attn",) if selfattn
                                                         else ())
            for att in attentions:
                for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    linear(f"{b}.{att}.{p}", E, E)
            for n in ("layernorm1", "layernorm2", "layernorm3") + (
                    ("layernorm_context",) if selfattn else ()):
                ln(f"{b}.{n}")
            linear(f"{b}.ffn_0", E, F)
            linear(f"{b}.ffn_2", F, E)

    p = "photometry_encoder"
    out[f"{p}.initbottleneck"] = (L, E)
    out[f"{p}.bandembd.weight"] = (d.num_bands, E)
    linear(f"{p}.fluxfc", 1, E)
    linear(f"{p}.time_embd.fc1", 2 * E, E)
    linear(f"{p}.time_embd.fc2", E, E)
    linear(f"{p}.LCfc.hidden_0", 3 * E, E)
    linear(f"{p}.LCfc.out", E, E)
    stack(f"{p}.blocks")
    linear(f"{p}.bottleneckfc.fc1", E, E)
    linear(f"{p}.bottleneckfc.fc2", E, D)
    p = "spectra_encoder"
    linear(f"{p}.flux_embd", 1, E)
    linear(f"{p}.spectrafc.hidden_0", 2 * E, E)
    linear(f"{p}.spectrafc.out", E, E)
    linear(f"{p}.phase_embd.fc1", 2 * E, E)
    linear(f"{p}.phase_embd.fc2", E, E)
    out[f"{p}.initbottleneck"] = (L, E)
    stack(f"{p}.blocks")
    linear(f"{p}.bottleneckfc.fc1", E, E)
    linear(f"{p}.bottleneckfc.fc2", E, D)
    for proj in ("photo_proj", "spectra_proj"):
        linear(f"{proj}.fc1", L * D, L * D)
        linear(f"{proj}.fc2", L * D, P)
    return out


EVENT_RELUS = ("photometry_encoder.bottleneckfc", "spectra_encoder.bottleneckfc", "photo_proj",
               "spectra_proj")


class _FlippedRelu(torch.autograd.Function):
    """ReLU whose derivative is flipped at ``index`` (a tuple of index
    tensors); its value is ReLU's."""

    @staticmethod
    def forward(ctx, x, index):
        keep = x > 0
        keep[index] = ~keep[index]
        ctx.save_for_backward(keep)
        return torch.relu(x)

    @staticmethod
    def backward(ctx, grad):
        (keep,) = ctx.saved_tensors
        return grad * keep, None


class ContrastiveNet(Net):
    """One pass of the two-tower network's reference: ``Net``'s layers,
    precision and dropout, the blocks with the context self-attention,
    the towers and their projections.

    ``seen``, where a dict, collects each event ReLU's inputs, a block's
    after the block before; ``flips`` maps an event ReLU to the inputs
    (event of the batch, then the rest of the index) whose derivative the
    pass flips while it records a graph."""

    def __init__(self, params: Dict[str, torch.Tensor], config: dict, precision: str = "fp32",
                 training: bool = False):
        super().__init__(params, dims_of(config), precision, training)
        self.selfattn = config["model"]["selfattn"]
        self.seen: Optional[Dict[str, List[torch.Tensor]]] = None
        self.flips: Dict[str, List[Tuple[int, ...]]] = {}
        self._row0 = 0

    def single(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if name not in EVENT_RELUS:
            return super().single(name, x)
        h = self.linear(f"{name}.fc1", x)
        if self.seen is not None:
            self.seen.setdefault(name, []).append(h.detach())
        here = [(e - self._row0, *rest) for e, *rest in self.flips.get(name, ())
                if 0 <= e - self._row0 < h.shape[0]]
        if here and torch.is_grad_enabled():
            index = tuple(torch.tensor(axis, device=h.device) for axis in zip(*here))
            return self.linear(f"{name}.fc2", _FlippedRelu.apply(h, index))
        return self.linear(f"{name}.fc2", torch.relu(h))

    def block(self, name, x, context, mask, context_mask, seed, rows):
        def site(i):
            return rng.maybe_fold_in(seed, i)

        a = self.attention(f"{name}.self_attn", x, x, x, mask, site(0), rows)
        x = self.layer_norm(f"{name}.layernorm1", x + self.dropout(a, site(1), rows))
        if self.selfattn:
            c = self.attention(f"{name}.context_self_attn", context, context, context,
                               context_mask, site(2), rows)
            context = self.layer_norm(f"{name}.layernorm_context",
                                      context + self.dropout(c, site(3), rows))
        c = self.attention(f"{name}.cross_attn", x, context, context, context_mask, site(4),
                           rows)
        x = self.layer_norm(f"{name}.layernorm2", x + self.dropout(c, site(5), rows))
        h = self.linear(f"{name}.ffn_2", gelu(self.linear(f"{name}.ffn_0", x)))
        return self.layer_norm(f"{name}.layernorm3", x + self.dropout(h, site(6), rows))

    def photometry(self, flux, time, band, mask, seed=None, rows=None):
        """The photometric tower's embedding [R, L, D]."""
        p = "photometry_encoder"
        tokens = self.mlp(f"{p}.LCfc", torch.cat([
            self.linear(f"{p}.fluxfc", flux[..., None]),
            self.sinusoid_mlp(f"{p}.time_embd", time),
            self.embed(f"{p}.bandembd", band)], dim=-1))
        x = self.P[f"{p}.initbottleneck"][None].expand(flux.shape[0], -1, -1)
        h = self.stack(f"{p}.blocks", x, tokens, None, mask, seed, rows)
        return self.single(f"{p}.bottleneckfc", x + h)

    def spectra(self, flux, wavelength, phase, mask, seed=None, rows=None):
        """The spectra tower's embedding [R, L, D]: the linear path reads the
        wavelength, the sinusoid the flux."""
        p = "spectra_encoder"
        tokens = self.mlp(f"{p}.spectrafc", torch.cat([
            self.linear(f"{p}.flux_embd", wavelength[..., None]), self.sinusoid(flux)], dim=-1))
        context = torch.cat([tokens, self.sinusoid_mlp(f"{p}.phase_embd", phase[..., None])],
                            dim=1)
        mask = torch.cat([mask, mask.new_zeros((mask.shape[0], 1))], dim=1)
        x = self.P[f"{p}.initbottleneck"][None].expand(flux.shape[0], -1, -1)
        h = self.stack(f"{p}.blocks", x, context, None, mask, seed, rows)
        return self.single(f"{p}.bottleneckfc", x + h)

    def projections(self, batch, seed: Optional[int] = None, rows: Optional[Rows] = None):
        """(z1, z2) [R, proj] of the events ``batch`` = (photometry tuple,
        spectra tuple); ``seed`` the step's dropout seed (train mode)."""
        photo, spec = batch
        self._row0 = 0 if rows is None else rows.start
        z1 = self.photometry(*photo, rng.maybe_fold_in(seed, 0), rows)
        z2 = self.spectra(*spec, rng.maybe_fold_in(seed, 1), rows)
        return (self.single("photo_proj", z1.flatten(1)),
                self.single("spectra_proj", z2.flatten(1)))


def info_nce(net: Net, z1: torch.Tensor, z2: torch.Tensor, temperature: float) -> torch.Tensor:
    """The negated symmetric InfoNCE of the projections [B, proj]: a
    quantity to maximise."""
    z1 = z1 / torch.clamp(torch.sqrt((z1 * z1).sum(-1, keepdim=True)), min=1e-12)
    z2 = z2 / torch.clamp(torch.sqrt((z2 * z2).sum(-1, keepdim=True)), min=1e-12)
    logits = net.mm(z1, z2.t()) / temperature
    rows = torch.diagonal(torch.log_softmax(logits, dim=1)).mean()
    cols = torch.diagonal(torch.log_softmax(logits, dim=0)).mean()
    return (rows + cols) / 2.0
