"""The plain reference of the host-galaxy image VAE (VAESNe's third modality).

Plain PyTorch over a dict of parameters named as the system under test
names them (``enc.patch_embed.proj.weight``, ``dec.refine_0.weight``, ...),
on the blocks of the MoE-MMVAE's reference (``model.Net``): no kernel, no
cuDNN, no cache. It follows the published model (YunyiShen/VAESNe-dev,
``cannon/test_ZTFimage.py``, the ViT-style ``HostImgVAE``):

  * encoder: a p×p stride-p convolution cuts the image into patch tokens,
    a fixed 2-D sin-cos grid is added, and 2·L learned bottleneck tokens
    cross-attend to them through post-LN blocks; a one-hidden-layer MLP
    gives the posterior's loc and (softplus) scale;
  * hybrid decoder: one query per patch on the 2-D grid cross-attends to
    the latents (through an MLP), a Dense gives p·p·d features per patch,
    unfolded to a d-channel image (pixel (gy·p + py, gx·p + px) takes patch
    (gy, gx)'s block (py, px)), then two p×p SAME convolutions, d → 4d →
    C, with a ReLU between; or the per-pixel decoder, one query per pixel
    and an MLP head;
  * a Laplace posterior and prior, and a Laplace likelihood of scale 1 over
    every pixel (images carry no mask).

A convolution is an im2col (``unfold``) and one product through
``Net.mm``, so the control's TF32 rounds its operands as the card's TF32
convolutions would. Departures from upstream: images are NCHW where the
published model (and the JAX package) run NHWC, the same numbers
transposed; the SAME padding of the even 2×2 kernel puts its one pixel of
zeros after the image on each axis (lax's rule); no event-location tokens
(``focal_loc`` is off in the configuration, and the reference refuses it).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import rng
from .model import (SCALE_EPS, Dims, Net, flatten_latents, laplace_log_prob, laplace_sample,
                    softplus)


def dims_of(config: dict) -> Dims:
    """The blocks' sizes (``num_bands`` has no meaning here: 0)."""
    m = config["model"]
    if m["selfattn"] or config["focal_loc"]:
        raise ValueError("the image reference has no context self-attention and no "
                         "event-location tokens")
    return Dims(m["latent_len"], m["latent_dim"], m["model_dim"], m["num_heads"], m["ff_dim"],
                m["num_layers"], 0, m["dropout"])


def parameter_shapes(config: dict) -> Dict[str, tuple]:
    """Every parameter of the image VAE, by name, with its shape."""
    d = dims_of(config)
    E, D, L = d.model_dim, d.latent_dim, d.latent_len
    C, p = config["in_channels"], config["patch_size"]
    out: Dict[str, tuple] = {}

    def linear(name, i, o):
        out[f"{name}.weight"] = (o, i)
        out[f"{name}.bias"] = (o,)

    def conv(name, i, o):
        out[f"{name}.weight"] = (o, i, p, p)
        out[f"{name}.bias"] = (o,)

    def stack(name):
        for i in range(d.num_layers):
            b = f"{name}.block_{i}"
            for att in ("self_attn", "cross_attn"):
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    linear(f"{b}.{att}.{proj}", E, E)
            for n in ("layernorm1", "layernorm2", "layernorm3"):
                out[f"{b}.{n}.weight"] = (E,)
                out[f"{b}.{n}.bias"] = (E,)
            linear(f"{b}.ffn_0", E, d.ff_dim)
            linear(f"{b}.ffn_2", d.ff_dim, E)

    conv("enc.patch_embed.proj", C, E)
    out["enc.initbottleneck"] = (2 * L, E)
    stack("enc.blocks")
    linear("enc.bottleneckfc.fc1", E, E)
    linear("enc.bottleneckfc.fc2", E, D)
    linear("dec.contextfc.hidden_0", D, E)
    linear("dec.contextfc.out", E, E)
    stack("dec.blocks")
    if config["hybrid"]:
        linear("dec.decoder", E, E * p * p)
        conv("dec.refine_0", E, 4 * E)
        conv("dec.refine_1", 4 * E, C)
    else:
        linear("dec.decoder.hidden_0", E, E)
        linear("dec.decoder.out", E, C)
    return out


def sincos_grid(dim: int, height: int, width: int, device) -> torch.Tensor:
    """The fixed 2-D sin-cos embedding [H·W, dim], rows in row-major (y, x)
    order: cat[sin(x·ω), cos(x·ω)] + cat[sin(y·ω), cos(y·ω)], with
    ω_i = 1 / 10000^(i / (dim/2)), i < dim/2."""
    half = dim // 2
    omega = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32, device=device) / half))
    y = torch.arange(height, dtype=torch.float32, device=device).repeat_interleave(width)
    x = torch.arange(width, dtype=torch.float32, device=device).repeat(height)

    def waves(c):
        a = c[:, None] * omega[None, :]
        return torch.cat([torch.sin(a), torch.cos(a)], dim=-1)

    return waves(x) + waves(y)


class ImageNet(Net):
    """One pass of the image VAE's reference: ``Net``'s blocks, precision
    and dropout, and the image model's own layers."""

    def __init__(self, params: Dict[str, torch.Tensor], config: dict, precision: str = "fp32",
                 training: bool = False):
        super().__init__(params, dims_of(config), precision, training)
        self.img, self.patch = config["img_size"], config["patch_size"]
        self.channels, self.hybrid = config["in_channels"], config["hybrid"]

    def conv(self, name: str, x: torch.Tensor, stride: int) -> torch.Tensor:
        """A convolution of NCHW ``x`` (already padded) with no padding of its
        own: every kh×kw window flattened (in, kh, kw) and one product with
        the flattened kernel, plus the bias."""
        w, b = self.P[f"{name}.weight"], self.P[f"{name}.bias"]
        n, _, h, wd = x.shape
        cout, _, kh, kw = w.shape
        ho, wo = (h - kh) // stride + 1, (wd - kw) // stride + 1
        cols = F.unfold(x, (kh, kw), stride=stride)  # [N, in·kh·kw, Ho·Wo]
        rows = cols.transpose(1, 2).reshape(n * ho * wo, -1)
        y = self.mm(rows, w.reshape(cout, -1).t()) + b
        return y.reshape(n, ho * wo, cout).transpose(1, 2).reshape(n, cout, ho, wo)

    def same_conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A p×p stride-1 SAME convolution: (p − 1)//2 pixels of zeros
        before on each axis, the rest after."""
        lo = (self.patch - 1) // 2
        hi = self.patch - 1 - lo
        return self.conv(name, F.pad(x, (lo, hi, lo, hi)), 1)

    def encode(self, image: torch.Tensor, seed: Optional[int]):
        """(posterior loc, scale) [B, L, D] of images [B, C, H, W]."""
        E, g = self.d.model_dim, self.img // self.patch
        patches = self.conv("enc.patch_embed.proj", image, self.patch)  # [B, E, g, g]
        context = patches.flatten(2).transpose(1, 2) + sincos_grid(E, g, g, image.device)[None]
        x = self.P["enc.initbottleneck"][None].expand(image.shape[0], -1, -1)
        h = self.stack("enc.blocks", x, context, None, None, seed, None)
        bottleneck = self.single("enc.bottleneckfc", x + h)
        L = self.d.latent_len
        return bottleneck[:, :L], softplus(bottleneck[:, L:]) + SCALE_EPS

    def decode(self, z: torch.Tensor, seed: Optional[int]) -> torch.Tensor:
        """Decoder means [R, C, H, W] of latents z [R, L, D]."""
        R, E, p = z.shape[0], self.d.model_dim, self.patch
        side = self.img // p if self.hybrid else self.img
        x = sincos_grid(E, side, side, z.device)[None].expand(R, -1, -1)
        context = self.mlp("dec.contextfc", z)
        h = self.stack("dec.blocks", x, context, None, None, seed, None)
        if not self.hybrid:
            out = self.mlp("dec.decoder", h + x)  # [R, H·W, C]
            return out.reshape(R, side, side, self.channels).permute(0, 3, 1, 2)
        feats = self.linear("dec.decoder", h + x).reshape(R, side, side, p, p, E)
        # [R, gy, gx, py, px, E] → [R, E, gy·p + py, gx·p + px]
        image = feats.permute(0, 5, 1, 3, 2, 4).reshape(R, E, side * p, side * p)
        h = torch.relu(self.same_conv("dec.refine_0", image))
        return self.same_conv("dec.refine_1", h)


def laplace_kl(loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """KL(Laplace(loc, scale) ‖ Laplace(0, 1)), elementwise."""
    delta = torch.abs(loc)
    return -torch.log(scale) + delta + scale * torch.exp(-delta / scale) - 1.0


def elbo(net: ImageNet, images: torch.Tensor, step_seed: int, K: int, beta: float,
         batch_events: Optional[int] = None) -> torch.Tensor:
    """The step's ELBO at K samples: E[log p(x|z)]/β − KL(q‖p) averaged over
    the samples and the first ``batch_events`` images (all by default). The
    posterior noise comes from ``fold_in(step_seed, 0)``, the encoder's
    dropout from ``fold_in(fold_in(step_seed, 1), 0)`` and the decoder's
    from ``fold_in(fold_in(step_seed, 1), 1)``."""
    B = images.shape[0]
    drop = rng.fold_in(step_seed, 1) if net.training else None
    loc, scale = net.encode(images, rng.maybe_fold_in(drop, 0))
    g = rng.generator(rng.fold_in(step_seed, 0), images.device)
    u = torch.rand((K,) + tuple(loc.shape), generator=g, device=images.device)
    z = laplace_sample(loc, scale, u)  # [K, B, L, D]
    mean = net.decode(flatten_latents(z), rng.maybe_fold_in(drop, 1))  # row b·K + k
    mean = mean.reshape((B, K) + tuple(mean.shape[1:])).transpose(0, 1)  # [K, B, C, H, W]
    lpx = laplace_log_prob(images[None], mean, torch.ones_like(mean)).flatten(2).sum(-1)
    kl = laplace_kl(loc, scale).sum((-1, -2))
    terms = lpx / beta - kl[None]
    n = B if batch_events is None else batch_events
    return terms[:, :n].mean()
