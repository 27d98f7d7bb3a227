"""The plain reference of the first training steps of a MoE-MMVAE run.

From the run's seed, the raw data and the initial weights it works out
again what the program's training loop does before and in its first
steps: the epoch's augmentation and sample order, each step's seed, the
posterior noise and the dropout masks, the MoE-IWAE objective (K samples
per expert, log-mean-exp over the M·K weights, a sum over the batch), its
gradient, the global-norm clip and AdamW. The decoders run a few events
at a time (the objective is a sum over events), so a batch of any size
fits; the gradients add over the blocks.

``record`` returns, for the comparison: each step's loss (the negated
objective, as the program reports it), the norm of each parameter's
gradient as the optimizer gets it (clipped) at each of the first steps,
and the norm of each parameter's change over the steps after the first.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from . import rng
from .model import (MASK_VARIANCES, Net, Rows, dims_of, flatten_latents, grid_loglik,
                    laplace_log_prob, laplace_sample, llik_scalings, log_mean_exp)

FLUX_NOISE, TIME_SHIFT, EXTRA_MASK_PROB = 0.02, 0.1, 0.05
HALF_BATCH = "half_batch"  # a planted fault: half of each batch, the mean over the rest


def training_tuples(raw: Dict[str, np.ndarray], repeat: int, device):
    """((flux, time, band, missing), (flux, wavelength, phase, missing)) of
    the training events, repeated ``repeat`` times along the events."""
    idx = np.asarray(raw["training_idx"])

    def put(a, dtype):
        t = torch.from_numpy(np.ascontiguousarray(a[idx])).to(device=device, dtype=dtype)
        return torch.cat([t] * repeat, dim=0) if repeat > 1 else t

    photo = (put(raw["photoflux"], torch.float32), put(raw["phototime"], torch.float32),
             put(raw["photowavelength"], torch.int64), put(raw["photomask"] == 0, torch.bool))
    spec = (put(raw["flux"], torch.float32), put(raw["wavelength"], torch.float32),
            put(raw["phase"], torch.float32), put(raw["mask"] == 0, torch.bool))
    return photo, spec


def augment(seed: int, data):
    """The epoch's augmentation, drawn in order from one generator on the
    data's device: light-curve flux noise, one time shift per curve, extra
    masking; then spectrum flux noise and extra masking."""
    (flux, time, band, mask), (sflux, wl, phase, smask) = data
    g = rng.generator(seed, flux.device)

    def normal(shape, like):
        return torch.randn(shape, generator=g, dtype=like.dtype, device=like.device)

    flux = flux + FLUX_NOISE * normal(flux.shape, flux)
    time = time + TIME_SHIFT * normal((time.shape[0], 1), time)
    mask = mask | (torch.rand(mask.shape, generator=g, device=mask.device) < EXTRA_MASK_PROB)
    sflux = sflux + FLUX_NOISE * normal(sflux.shape, sflux)
    smask = smask | (torch.rand(smask.shape, generator=g, device=smask.device)
                     < EXTRA_MASK_PROB)
    return (flux, time, band, mask), (sflux, wl, phase, smask)


def epoch_seeds(seed: int, epoch: int):
    """(augmentation seed, shuffle seed) of an epoch."""
    e = rng.fold_in(rng.fold_in(seed, 2), epoch)
    return rng.fold_in(e, 0), rng.fold_in(e, 1)


def objective_backward(net: Net, batch, step_seed: int, K: int, beta: float,
                       block_events: int, fault: Optional[str] = None) -> float:
    """The step's MoE-IWAE objective; its negation's gradient is added to
    every parameter's ``.grad``."""
    photo, spec = batch
    d = net.d
    B, M = photo[0].shape[0], 2
    MK = M * K
    g = rng.generator(rng.fold_in(step_seed, 0), photo[0].device)
    drop = rng.fold_in(step_seed, 1)
    enc = [net.encode_photometry(*photo), net.encode_spectrum(*spec)]
    shape = (K, B, d.latent_len, d.latent_dim)
    noise = [torch.rand(shape, generator=g, device=photo[0].device) for _ in range(M)]
    leaves = [[t.detach().requires_grad_() for t in pair] for pair in enc]
    scal = llik_scalings(beta)
    events = B // 2 if fault == HALF_BATCH else B
    total = 0.0
    for b0 in range(0, events, block_events):
        b1 = min(events, b0 + block_events)
        idx = torch.arange(b0, b1, device=photo[0].device)
        zs = [laplace_sample(loc[b0:b1], scale[b0:b1], u[:, b0:b1])
              for (loc, scale), u in zip(leaves, noise)]
        z_flat = flatten_latents(torch.cat(zs, 0))
        rows = Rows(b0 * MK, B * MK)
        lls = []
        for m, x in enumerate((photo, spec)):
            loc = net.decode(m, x, z_flat, idx, MK, rng.fold_in(drop, m), rows)
            loc = loc.reshape(b1 - b0, MK, -1).transpose(0, 1)
            lls.append(grid_loglik(loc, x[0][b0:b1], x[3][b0:b1], MASK_VARIANCES[m]))
        lws = []
        for r in range(M):
            zr = zs[r]
            lpz = laplace_log_prob(zr, torch.zeros_like(zr), torch.ones_like(zr)).sum((-1, -2))
            lqz = log_mean_exp(torch.stack([
                laplace_log_prob(zr, loc[b0:b1], scale[b0:b1]).sum((-1, -2))
                for loc, scale in leaves]))
            lpx = sum(ll[r * K:(r + 1) * K] * s for ll, s in zip(lls, scal))
            lws.append(lpz + lpx - lqz)
        obj = log_mean_exp(torch.cat(lws, 0), 0).sum()
        if fault == HALF_BATCH:
            obj = obj * (B / events)
        (-obj).backward()
        total += float(obj.detach())
    grads = [t.grad for pair in leaves for t in pair]
    torch.autograd.backward([t for pair in enc for t in pair], grads)
    return total


class AdamW:
    """AdamW with a global-norm clip ahead of it, over a list of tensors."""

    def __init__(self, params: List[torch.Tensor], lr: float, weight_decay: float, b1: float,
                 b2: float, eps: float, clip: Optional[float]):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2, self.eps, self.clip = b1, b2, eps, clip
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    def step(self) -> List[torch.Tensor]:
        """One update from each parameter's ``.grad``; returns the gradients
        as the update took them (after the clip)."""
        grads = [p.grad for p in self.params]
        if self.clip is not None:
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            if float(norm) >= self.clip:
                grads = [g * (self.clip / norm) for g in grads]
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        with torch.no_grad():
            for p, g, m, v in zip(self.params, grads, self.m, self.v):
                p.mul_(1.0 - self.lr * self.wd)
                m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                p.add_(-(self.lr / c1) * m / (torch.sqrt(v) / math.sqrt(c2) + self.eps))
        return grads


def record(params0: Dict[str, torch.Tensor], raw: Dict[str, np.ndarray], config: dict,
           train_seed: int, steps: int = 4, grad_steps: int = 2, precision: str = "fp32",
           fault: Optional[str] = None, block_rows: int = 64) -> dict:
    """The reference's first ``steps`` steps from the initial weights
    ``params0``: {"loss": [...], "grads": [{name: norm}, ...] of the first
    ``grad_steps`` steps, "change": {name: norm} from after step 1 to the
    end}."""
    dims = dims_of(config)
    t = config["train"]
    device = next(iter(params0.values())).device
    params = {k: v.detach().clone().requires_grad_() for k, v in params0.items()}
    names = sorted(params)
    opt = AdamW([params[n] for n in names], t["lr"], t["weight_decay"], t["b1"], t["b2"],
                t.get("eps", 1e-8), t["grad_clip"] if t["grad_clip"] > 0 else None)
    data = training_tuples(raw, config.get("repeat_factor", 1), device)
    aug_seed, shuffle_seed = epoch_seeds(train_seed, 0)
    data = augment(aug_seed, data)
    n, B, K = data[0][0].shape[0], t["batch_size"], t["K"]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(shuffle_seed))
    order = perm[:(n // B) * B].view(n // B, B)
    step_gen = torch.Generator().manual_seed(rng.fold_in(train_seed, 1))
    net = Net(params, dims, precision, training=True)
    block_events = max(1, block_rows // (2 * K))
    losses, grads, after_first = [], [], None
    for i in range(steps):
        step_seed = rng.draw_seed(step_gen)
        idx = order[i].to(device)
        batch = tuple(tuple(a[idx] for a in m) for m in data)
        for p in params.values():
            p.grad = None
        objective = objective_backward(net, batch, step_seed, K, t["beta"], block_events, fault)
        took = opt.step()
        losses.append(-objective)
        if i < grad_steps:
            grads.append({nm: float(torch.linalg.vector_norm(g)) for nm, g in zip(names, took)})
        if i == 0:
            after_first = {nm: params[nm].detach().clone() for nm in names}
    change = {nm: float(torch.linalg.vector_norm(params[nm].detach() - after_first[nm]))
              for nm in names}
    return {"loss": losses, "grads": grads, "change": change}
