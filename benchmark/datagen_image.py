"""The benchmark's host-galaxy images and the image VAE's initial weights,
both from the seed.

Images: 60×60 RGB stamps in [−1, 1], NCHW float32, each one rotated
elliptical Gaussian (centre within the middle 40%, axes 3–12 pixels), a
brightness per channel and pixel noise of σ 0.05 before the map to
[−1, 1], the kind of stamp the port's own synthetic set holds. Made here,
in bulk with numpy, so a change to the program cannot change the inputs it
is measured on; the same seed gives the same array.

Weights: the port's initial distributions (``utils.weights.init_params``),
drawn on the card from one generator: Linear weight and bias
U(±1/√fan_in); a convolution's weight lecun-normal (a normal truncated at
±2σ, rescaled to variance 1/fan_in, fan_in = in·kh·kw) and its bias 0;
LayerNorm 1 and 0; the bottleneck tokens N(0, 1).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

TRUNC = 2.0  # the truncated normal's bound, in σ
# the standard deviation of a standard normal truncated at ±2
TRUNC_STD = 0.87962566103423978


def make_images(n: int, img_size: int, channels: int, seed: int) -> np.ndarray:
    """``n`` synthetic stamps [n, channels, img_size, img_size] in [−1, 1]."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(0.3, 0.7, (n, 2, 1, 1)) * img_size
    axes = rng.uniform(3.0, 12.0, (n, 2, 1, 1))
    theta = rng.uniform(0.0, np.pi, (n, 1, 1))
    brightness = rng.uniform(0.5, 1.0, (n, channels, 1, 1))
    noise = rng.standard_normal((n, channels, img_size, img_size))
    yy, xx = np.mgrid[0:img_size, 0:img_size]
    dx, dy = xx - centre[:, 0], yy - centre[:, 1]
    xr = dx * np.cos(theta) + dy * np.sin(theta)
    yr = -dx * np.sin(theta) + dy * np.cos(theta)
    galaxy = np.exp(-0.5 * ((xr / axes[:, 0]) ** 2 + (yr / axes[:, 1]) ** 2))
    images = galaxy[:, None] * brightness + 0.05 * noise
    return np.clip(images * 2.0 - 1.0, -1.0, 1.0).astype(np.float32)


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, "torch.Tensor"]:
    """Initial fp32 weights on ``device`` from ``seed``: the uniform draws of
    the Linear layers, the bottleneck tokens' normal draws and the
    convolutions' truncated normals, in that order, each over the names in
    sorted order."""
    import torch

    names = sorted(shapes)
    conv = {n for n in names if len(shapes[n]) == 4}
    conv_bias = {n for n in names if n.endswith(".bias") and n[:-len("bias")] + "weight" in conv}
    fixed = {n for n in names if ".layernorm" in n} | conv_bias
    normal = [n for n in names if n.endswith("initbottleneck")]
    uniform = [n for n in names if n not in fixed and n not in conv and n not in normal]
    convs = [n for n in names if n in conv]
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(fn, group):
        return fn(sum(math.prod(shapes[n]) for n in group), generator=g, device=device)

    u, z, c = draw(torch.rand, uniform), draw(torch.randn, normal), draw(torch.rand, convs)
    out, at = {}, 0
    for n in uniform:
        size = math.prod(shapes[n])
        weight = shapes[n[:-len("bias")] + "weight"] if n.endswith(".bias") else shapes[n]
        out[n] = ((2.0 * u[at:at + size] - 1.0) / math.sqrt(weight[-1])).view(shapes[n])
        at += size
    at = 0
    for n in normal:
        size = math.prod(shapes[n])
        out[n] = z[at:at + size].view(shapes[n])
        at += size
    # the standard normal truncated at ±2 by its inverse CDF, then σ
    lo = 0.5 * (1.0 + math.erf(-TRUNC / math.sqrt(2.0)))
    at = 0
    for n in convs:
        size = math.prod(shapes[n])
        p = lo + (1.0 - 2.0 * lo) * c[at:at + size]
        t = (math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)).clamp(-TRUNC, TRUNC)
        fan_in = math.prod(shapes[n][1:])
        out[n] = (t * (math.sqrt(1.0 / fan_in) / TRUNC_STD)).view(shapes[n])
        at += size
    for n in fixed:
        fill = 1.0 if ".layernorm" in n and n.endswith(".weight") else 0.0
        out[n] = torch.full(shapes[n], fill, device=device)
    return out
