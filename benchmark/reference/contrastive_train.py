"""The plain reference of the first training steps of a contrastive run.

From the run's seed, the raw data and the initial weights it works out
again what the program's training loop does before and in its first
steps: the training split, the epoch's augmentation and sample order
(``train.augment``, ``train.epoch_seeds``), each step's seed and the
dropout masks, the symmetric InfoNCE over the batch's projections, its
gradient, the global-norm clip and AdamW (``train.AdamW``).

The towers run a block of events at a time. InfoNCE couples the events
only through the projections, so a step runs the towers over every block
without a graph, takes the head's gradient with respect to the
projections, then runs each block again with a graph and carries that
gradient back through it: the same gradient as one pass over the batch,
in the memory of one block.

``record`` returns, for the comparison, what ``train.record`` returns for
the MoE-MMVAE: each step's loss (the negated objective), the norm of each
parameter's gradient as the optimizer took it at each of the first steps,
and the norm of each parameter's change over the steps after the first.

Where an input of an event ReLU (``contrastive_model.EVENT_RELUS``) lies
within ``UNDETERMINED`` of its site's largest, fp32 does not decide which
side of zero it is on: a sound program computes these inputs within ~5e-7
of the reference's, relative to the largest, and ReLU's derivative there is
0 on one side and 1 on the other. A flip moves the step's gradient by that
input's whole share (a latent token or a projection of one event), which
AdamW carries into every later step. ``record_branches`` therefore returns
the trajectory and one more for each way of deciding the undetermined
inputs it meets, each deciding them by a flipped derivative; the
comparison takes the trajectory nearest the program's. A flip leaves the
pass's value as it is and moves its gradient, and so every later step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import rng
from .contrastive_model import ContrastiveNet, info_nce
from .model import Rows
from .train import HALF_BATCH, AdamW, augment, epoch_seeds, training_tuples


UNDETERMINED = 1e-5  # of the site's largest input; a sound program's lie within ~5e-7 of ours
BRANCHES = 16  # trajectories at most


def objective_backward(net: ContrastiveNet, batch, step_seed: int, temperature: float,
                       block_events: int, fault: Optional[str] = None,
                       flips: Optional[Dict[str, List[Tuple[int, ...]]]] = None):
    """The step's InfoNCE objective, and the event ReLUs' undetermined
    inputs as (site, index) in order; the negated objective's gradient is
    added to every parameter's ``.grad``, with the derivative flipped at
    ``flips`` ({site: [index]}). ``fault=HALF_BATCH`` takes the objective
    over the first half of the batch alone."""
    B = batch[0][0].shape[0]
    blocks = [(b0, min(B, b0 + block_events)) for b0 in range(0, B, block_events)]

    def towers(b0, b1):
        events = tuple(tuple(a[b0:b1] for a in m) for m in batch)
        return net.projections(events, step_seed, Rows(b0, B))

    net.seen, net.flips = {}, {}
    with torch.no_grad():
        parts = [towers(b0, b1) for b0, b1 in blocks]
    seen, net.seen = net.seen, None
    undetermined = []
    for site, inputs in sorted(seen.items()):
        h = torch.cat(inputs).abs()
        undetermined += [(site, tuple(i)) for i in (h < UNDETERMINED * h.max()).nonzero().tolist()]
    z1 = torch.cat([p[0] for p in parts]).requires_grad_()
    z2 = torch.cat([p[1] for p in parts]).requires_grad_()
    n = B // 2 if fault == HALF_BATCH else B
    objective = info_nce(net, z1[:n], z2[:n], temperature)
    (-objective).backward()
    net.flips = flips or {}
    try:
        for b0, b1 in blocks:
            torch.autograd.backward(list(towers(b0, b1)), [z1.grad[b0:b1], z2.grad[b0:b1]])
    finally:
        net.flips = {}
    return float(objective.detach()), undetermined


def record(params0: Dict[str, torch.Tensor], raw: Dict[str, np.ndarray], config: dict,
           train_seed: int, steps: int = 4, grad_steps: int = 2, precision: str = "fp32",
           fault: Optional[str] = None, block_events: int = 8, flips: tuple = ()) -> dict:
    """The reference's first ``steps`` steps from the initial weights
    ``params0``: {"loss": [...], "grads": [{name: norm}, ...] of the first
    ``grad_steps`` steps, "change": {name: norm} from after step 1 to the
    end, "undetermined": [(step, site, index), ...] in order}, the event
    ReLUs' derivative flipped at ``flips`` ((step, site, index), ...)."""
    t = config["train"]
    device = next(iter(params0.values())).device
    params = {k: v.detach().clone().requires_grad_() for k, v in params0.items()}
    names = sorted(params)
    opt = AdamW([params[n] for n in names], t["lr"], t["weight_decay"], t["b1"], t["b2"],
                t.get("eps", 1e-8), t["grad_clip"] if t["grad_clip"] > 0 else None)
    data = training_tuples(raw, 1, device)
    aug_seed, shuffle_seed = epoch_seeds(train_seed, 0)
    data = augment(aug_seed, data)
    n, B = data[0][0].shape[0], t["batch_size"]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(shuffle_seed))
    order = perm[:(n // B) * B].view(n // B, B)
    step_gen = torch.Generator().manual_seed(rng.fold_in(train_seed, 1))
    net = ContrastiveNet(params, config, precision, training=True)
    losses, grads, after_first, undetermined = [], [], None, []
    for i in range(steps):
        step_seed = rng.draw_seed(step_gen)
        idx = order[i].to(device)
        batch = tuple(tuple(a[idx] for a in m) for m in data)
        for p in params.values():
            p.grad = None
        here: Dict[str, List[Tuple[int, ...]]] = {}
        for step, site, index in flips:
            if step == i + 1:
                here.setdefault(site, []).append(index)
        objective, found = objective_backward(net, batch, step_seed, config["temperature"],
                                              block_events, fault, here)
        undetermined += [(i + 1, site, index) for site, index in found]
        took = opt.step()
        losses.append(-objective)
        if i < grad_steps:
            grads.append({nm: float(torch.linalg.vector_norm(g)) for nm, g in zip(names, took)})
        if i == 0:
            after_first = {nm: params[nm].detach().clone() for nm in names}
    change = {nm: float(torch.linalg.vector_norm(params[nm].detach() - after_first[nm]))
              for nm in names}
    return {"loss": losses, "grads": grads, "change": change, "undetermined": undetermined}


def record_branches(params0: Dict[str, torch.Tensor], raw: Dict[str, np.ndarray], config: dict,
                    train_seed: int, steps: int = 4, grad_steps: int = 2, **kwargs) -> list:
    """``record``'s trajectory, then one for each set of the undetermined
    inputs that it and its branches meet, each set flipped (a branch adds
    inputs after its last flip, so each set comes once), at most
    ``BRANCHES`` in all; each trajectory's ``flips`` say which."""
    out, todo = [], [()]
    while todo and len(out) < BRANCHES:
        flips = todo.pop(0)
        rec = record(params0, raw, config, train_seed, steps, grad_steps, flips=flips, **kwargs)
        rec["flips"] = flips
        out.append(rec)
        todo += [flips + (u,) for u in rec["undetermined"] if not flips or u > flips[-1]]
    return out
