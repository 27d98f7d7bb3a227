"""The plain reference of the first training steps of an image VAE run.

From the run's seed, the raw images and the initial weights it works out
again what the program's training loop does before and in its first
steps: the ×``aug_factor`` copies of the images, the epoch's flips and
affine warps, the sample order, each step's seed, the posterior noise and
the dropout masks, the ELBO at K samples (a mean over the samples and the
batch), its gradient, the global-norm clip and AdamW (``train.AdamW``).

``record`` returns, for the comparison, what ``train.record`` returns for
the MoE-MMVAE: each step's loss (the negated ELBO), the norm of each
parameter's gradient as the optimizer took it at each of the first steps,
and the norm of each parameter's change over the steps after the first.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import rng
from .image_model import ImageNet, elbo
from .train import HALF_BATCH, AdamW, epoch_seeds

FLIP = 0.5  # each flip's probability
DEGREES, SCALE, TRANSLATE = 15.0, (0.75, 1.25), 0.05  # the affine warp's ranges
FILL = -1.0  # black, in the images' [−1, 1]


def warp(images: torch.Tensor, angle, scale, dx, dy) -> torch.Tensor:
    """Bilinear inverse-affine resampling of an NCHW batch about the pixel
    centre ((H−1)/2, (W−1)/2): output pixel p reads the input at
    centre + R(−angle)·(p − centre − (dx, dy)) / scale, each of the four
    neighbours outside the frame reading ``FILL``; the neighbours' terms
    are added in the order (y0, x0), (y0, x1), (y1, x0), (y1, x1)."""
    b, c, h, w = images.shape
    dev = images.device
    y = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos = torch.cos(angle)[:, None, None]
    sin = torch.sin(angle)[:, None, None]
    s = scale[:, None, None]
    u = x - cx - dx[:, None, None]
    v = y - cy - dy[:, None, None]
    src_x = cx + (cos * u + sin * v) / s
    src_y = cy + (-sin * u + cos * v) / s
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    fx, fy = src_x - x0, src_y - y0
    x0, y0 = x0.long(), y0.long()
    batch = torch.arange(b, device=dev)[:, None, None]
    out = None
    for yi, wy in ((y0, 1.0 - fy), (y0 + 1, fy)):
        for xi, wx in ((x0, 1.0 - fx), (x0 + 1, fx)):
            inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            pix = images[batch, :, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]  # [B, H, W, C]
            pix = torch.where(inside[..., None], pix, FILL).permute(0, 3, 1, 2)
            term = (wy * wx)[:, None] * pix
            out = term if out is None else out + term
    return out


def augment(seed: int, images: torch.Tensor) -> torch.Tensor:
    """The epoch's augmentation of every image, drawn in order from one
    generator on the images' device: a horizontal flip, a vertical flip
    (each with probability 0.5), then the angle (±15°), the scale
    (0.75–1.25) and the shift (±5% of the side, rounded to whole pixels) of
    the affine warp."""
    g = rng.generator(seed, images.device)
    b, _, h, w = images.shape

    def uniform(shape, low, high):
        return low + (high - low) * torch.rand(shape, generator=g, device=images.device)

    flip_x = torch.rand(b, generator=g, device=images.device) < FLIP
    flip_y = torch.rand(b, generator=g, device=images.device) < FLIP
    images = torch.where(flip_x[:, None, None, None], images.flip(-1), images)
    images = torch.where(flip_y[:, None, None, None], images.flip(-2), images)
    angle = torch.deg2rad(uniform((b,), -DEGREES, DEGREES))
    scale = uniform((b,), SCALE[0], SCALE[1])
    shift = uniform((b, 2), -TRANSLATE, TRANSLATE)
    return warp(images, angle, scale, torch.round(shift[:, 0] * w), torch.round(shift[:, 1] * h))


def record(params0: Dict[str, torch.Tensor], images: np.ndarray, config: dict, train_seed: int,
           steps: int = 4, grad_steps: int = 2, precision: str = "fp32",
           fault: Optional[str] = None) -> dict:
    """The reference's first ``steps`` steps from the initial weights
    ``params0`` and the raw images [N, C, H, W]: {"loss": [...], "grads":
    [{name: norm}, ...] of the first ``grad_steps`` steps, "change": {name:
    norm} from after step 1 to the end}. ``fault=HALF_BATCH`` averages the
    ELBO over the first half of each batch alone."""
    t = config["train"]
    device = next(iter(params0.values())).device
    params = {k: v.detach().clone().requires_grad_() for k, v in params0.items()}
    names = sorted(params)
    opt = AdamW([params[n] for n in names], t["lr"], t["weight_decay"], t["b1"], t["b2"],
                t.get("eps", 1e-8), t["grad_clip"] if t["grad_clip"] > 0 else None)
    data = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    data = torch.cat([data] * config["aug_factor"], dim=0)
    aug_seed, shuffle_seed = epoch_seeds(train_seed, 0)
    data = augment(aug_seed, data)
    n, B, K = data.shape[0], t["batch_size"], t["K"]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(shuffle_seed))
    order = perm[:(n // B) * B].view(n // B, B)
    step_gen = torch.Generator().manual_seed(rng.fold_in(train_seed, 1))
    net = ImageNet(params, config, precision, training=True)
    events = B // 2 if fault == HALF_BATCH else None
    losses, grads, after_first = [], [], None
    for i in range(steps):
        step_seed = rng.draw_seed(step_gen)
        for p in params.values():
            p.grad = None
        objective = elbo(net, data[order[i].to(device)], step_seed, K, t["beta"], events)
        (-objective).backward()
        took = opt.step()
        losses.append(-float(objective.detach()))
        if i < grad_steps:
            grads.append({nm: float(torch.linalg.vector_norm(g)) for nm, g in zip(names, took)})
        if i == 0:
            after_first = {nm: params[nm].detach().clone() for nm in names}
    change = {nm: float(torch.linalg.vector_norm(params[nm].detach() - after_first[nm]))
              for nm in names}
    return {"loss": losses, "grads": grads, "change": change}
