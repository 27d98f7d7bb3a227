"""Operations and bytes of the host-galaxy image VAE's training step, from
its configuration alone: the model FLOPs, the attention grids that go to K1
and K2, and the three convolutions, each forward with its two backward
products.

The conventions are the package's (``counts/__init__.py``): model FLOPs
count the products of every linear layer, attention (QKᵀ and PV) and
convolution, the forward once, a backward twice the forward, remat's
re-run not at all. A convolution's forward, its input gradient (dgrad) and
its weight gradient (wgrad) are each 2·N·Ho·Wo·Cout·Cin·kh·kw operations;
each reads its operands once and writes its result once.
"""

from __future__ import annotations

from typing import List, NamedTuple

from . import BYTES, Grid, _block, _linear, routes_to_kernel


class ImageShape(NamedTuple):
    """The sizes the counts need: widths, the image and its patches, the
    latent tokens."""

    E: int
    F: int
    H: int
    layers: int
    L: int
    D: int
    img: int
    patch: int
    channels: int
    hybrid: bool


def shape_of(config: dict) -> ImageShape:
    m = config["model"]
    return ImageShape(m["model_dim"], m["ff_dim"], m["num_heads"], m["num_layers"],
                      m["latent_len"], m["latent_dim"], config["img_size"],
                      config["patch_size"], config["in_channels"], config["hybrid"])


def queries(s: ImageShape) -> int:
    """The decoder's queries: one per patch (hybrid) or per pixel."""
    return (s.img // s.patch) ** 2 if s.hybrid else s.img ** 2


def tower_grids(s: ImageShape, tower: str, rows: int) -> List[Grid]:
    """Every attention of one pass of a tower over ``rows`` rows: the
    encoder's 2·L bottleneck tokens over the patch tokens, the decoder's
    queries over the L latents; none masked."""
    lq, lc = {"enc": (2 * s.L, (s.img // s.patch) ** 2), "dec": (queries(s), s.L)}[tower]
    return [g for _ in range(s.layers) for g in (Grid(rows, lq, lq, False),
                                                  Grid(rows, lq, lc, False))]


def kernel_grids(s: ImageShape, tower: str, rows: int) -> List[Grid]:
    """The tower's grids that go to K1 (and K2 in a backward)."""
    return [g for g in tower_grids(s, tower, rows) if routes_to_kernel(g.rows, s.H, g.lq, g.lk)]


class Conv(NamedTuple):
    """One convolution over a batch: its name, the batch, the padded input
    [Cin, Hi, Wi], the output [Cout, Ho, Wo], the square kernel, and whether
    its input takes a gradient (the image's patch convolution does not)."""

    name: str
    batch: int
    cin: int
    hi: int
    cout: int
    ho: int
    k: int
    dgrad: bool


def convolutions(s: ImageShape, images: int, K: int) -> List[Conv]:
    """The step's convolutions: the encoder's patch convolution over the
    images, and the hybrid decoder's two SAME convolutions over its
    E-channel image of each of the K·images samples (p − 1 pixels of
    padding on each axis)."""
    g, p = s.img // s.patch, s.patch
    out = [Conv("patch_embed", images, s.channels, s.img, s.E, g, p, False)]
    if s.hybrid:
        padded, rows = s.img + p - 1, K * images
        out += [Conv("refine_0", rows, s.E, padded, 4 * s.E, s.img, p, True),
                Conv("refine_1", rows, 4 * s.E, padded, s.channels, s.img, p, True)]
    return out


def conv_products(c: Conv, dtype: str = "fp32"):
    """[(kind, flops, bytes)] of one convolution's forward (``fprop``) and
    its backward products (``dgrad`` where its input takes a gradient,
    ``wgrad``): x the padded input, y the output, w the kernel (and bias)."""
    size = BYTES[dtype]
    flops = 2 * c.batch * c.ho * c.ho * c.cout * c.cin * c.k * c.k
    x = c.batch * c.cin * c.hi * c.hi * size
    y = c.batch * c.cout * c.ho * c.ho * size
    w = (c.cout * c.cin * c.k * c.k + c.cout) * size
    out = [("fprop", flops, x + w + y)]
    if c.dgrad:
        out.append(("dgrad", flops, y + w + x))
    out.append(("wgrad", flops, x + y + w))
    return out


def forward_flops(s: ImageShape, images: int, K: int) -> int:
    """Forward FLOPs of the image VAE over ``images`` images with K decoded
    samples of each."""
    E, L, D, p, C = s.E, s.L, s.D, s.patch, s.channels
    g2, n = (s.img // p) ** 2, queries(s)
    enc = (2 * C * p * p * E * g2 + s.layers * _block(s, 2 * L, g2) + _linear(E, E, 2 * L)
           + _linear(E, D, 2 * L))
    dec = _linear(D, E, L) + _linear(E, E, L) + s.layers * _block(s, n, L)
    if s.hybrid:
        pixels = s.img ** 2
        dec += (_linear(E, E * p * p, n) + 2 * pixels * 4 * E * E * p * p
                + 2 * pixels * C * 4 * E * p * p)
    else:
        dec += _linear(E, E, n) + _linear(E, C, n)
    return images * (enc + K * dec)


def train_step_flops(s: ImageShape, batch: int, K: int) -> int:
    """Model FLOPs of one training step: the forward and twice it for the
    backward."""
    return 3 * forward_flops(s, batch, K)
