"""Training objectives of the port: ELBO, m-ELBO, the MoE-IWAE, InfoNCE and
the regression MSE.

Counterparts of ``vaesne_tpu/objectives.py`` (``grid_loglik``, ``elbo``,
``m_elbo``, ``m_iwae_terms``, ``m_iwae``, ``neg_info_nce``, ``mse``). Every objective returns a
quantity to MAXIMISE; the train step minimises its negation. The reductions
are the JAX package's (``elbo``: mean over K·B; ``m_iwae``: log-mean-exp
over the (modality·K) axis, then SUM over the batch), because they set the
effective learning rate.

Where the JAX package takes a PRNG key, these take an integer ``seed``:
``fold_in(seed, 0)`` seeds the posterior-sampling generator on the model's
device and ``fold_in(seed, 1)`` the dropout, which is on in train mode
(``model.train()``, the JAX package's ``deterministic=False``) and off in
eval mode.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .distributions import kl_divergence, log_mean_exp
from .ops import partition
from .utils.rng import device_generator, fold_in


def _seeded(objective, kwargs, model, batch, seed):
    return objective(model, batch, seed=seed, **kwargs)


def as_loss(objective: Callable, **kwargs) -> Callable:
    """``objective(model, batch, seed=seed, **kwargs)`` as a train loop's
    ``loss_fn(model, batch, seed)``: a ``functools.partial`` of module-level
    functions, so it pickles for spawned ranks (``parallel.launch``)."""
    return functools.partial(_seeded, objective, kwargs)


def grid_loglik(px_z, data: torch.Tensor) -> torch.Tensor:
    """Σ log p(x|z) over the observation grid → [K, B]. A likelihood that
    carries its own mask (``MaskedGridLaplace``) takes its fused path, the
    masked Laplace kernels for grids of 128 points or more."""
    if hasattr(px_z, "grid_loglik"):
        return px_z.grid_loglik(data)
    lp = px_z.log_prob(data[None])  # broadcast over K
    return lp.reshape(lp.shape[:2] + (-1,)).sum(-1)


def _rngs(model, x, seed: int):
    """(sampling generator on the data's device, dropout seed or None)."""
    device = x[0][0].device if isinstance(x[0], (tuple, list)) else x[0].device
    drop = fold_in(seed, 1) if model.training else None
    return device_generator(fold_in(seed, 0), device), drop


def elbo(model, x, K: int = 1, *, seed: int, debug: bool = False) -> torch.Tensor:
    """E[log p(x|z)]·llik_scaling − KL(q‖p), averaged over K and batch, for
    one modality VAE; ``x[0]`` is the observed grid. ``debug`` prints the
    terms as the JAX package does, ``kl: <mean KL>, llk: <−mean log-lik>``
    (a host sync)."""
    generator, drop = _rngs(model, x, seed)
    qz_x, px_z, _ = model(x, K, generator=generator, seed=drop)
    lpx_z = grid_loglik(px_z, x[0]) * model.total_llik_scaling  # [K, B]
    kld = kl_divergence(qz_x, model.pz(x[0].device))  # [B, L, D]
    if debug:
        print(f"kl: {kld.sum((-1, -2)).mean().detach().cpu().numpy()}, "
              f"llk: {(-lpx_z.mean()).detach().cpu().numpy()}")
    return (lpx_z - kld.sum((-1, -2))[None, :]).mean()


def m_elbo(model, x, K: int = 1, *, seed: int) -> torch.Tensor:
    """Multimodal ELBO with cross-modal importance weights; z and the
    source posterior's log-density are detached in the weights, where the
    JAX package stops their gradient."""
    generator, drop = _rngs(model, x, seed)
    qz_xs, px_zs, zss = model(x, K, generator=generator, seed=drop)
    pz = model.pz(x[0][0].device)
    scalings = model.llik_scalings
    M = len(qz_xs)
    lpx_zs, klds = [], []
    for r, qz_x in enumerate(qz_xs):
        klds.append(kl_divergence(qz_x, pz).sum((-1, -2)))  # [B]
        for d in range(M):
            lp = grid_loglik(px_zs[d][d], x[d][0]) * scalings[d]  # [K, B]
            if d == r:
                lwt = torch.zeros((), device=lp.device)
            else:
                zs = zss[d].detach()
                lwt = (qz_x.log_prob(zs) - qz_xs[d].log_prob(zs).detach()).sum((-1, -2))
            lpx_zs.append(torch.exp(lwt) * lp)
    obj = (1.0 / M) * (torch.stack(lpx_zs).sum(0) - torch.stack(klds).sum(0)[None, :])
    return obj.mean(0).sum()


def m_iwae_log_weights(qz_xs, px_zs, zss, x, scalings, pz) -> torch.Tensor:
    """The MoE-IWAE log-weights on precomputed forward outputs. Per expert r:
      lw_r = log p(z_r) + Σ_d log p_d(x_d | z_r)·scale_d − log (1/M)Σ_m q_m(z_r)
    stacked into [(M·K), B]."""
    lws = []
    for r in range(len(qz_xs)):
        lpz = pz.log_prob(zss[r]).sum((-1, -2))  # [K, B]
        lqz_x = log_mean_exp(torch.stack([qz.log_prob(zss[r]).sum((-1, -2))
                                          for qz in qz_xs]))  # [K, B]
        lpx_z = torch.stack([grid_loglik(px_z, x[d][0]) * scalings[d]
                             for d, px_z in enumerate(px_zs[r])]).sum(0)  # [K, B]
        lws.append(lpz + lpx_z - lqz_x)
    return torch.cat(lws, dim=0)


def m_iwae_terms(qz_xs, px_zs, zss, x, scalings, pz) -> torch.Tensor:
    """The MoE-IWAE estimator on precomputed forward outputs: the
    log-weights' log-mean-exp over the (M·K) axis, summed over batch."""
    return log_mean_exp(m_iwae_log_weights(qz_xs, px_zs, zss, x, scalings, pz), axis=0).sum()


def m_iwae(model, x, K: int = 1, *, seed: int) -> torch.Tensor:
    """MoE-IWAE estimate of log p(x) for the multimodal VAE."""
    generator, drop = _rngs(model, x, seed)
    qz_xs, px_zs, zss = model(x, K, generator=generator, seed=drop)
    return m_iwae_terms(qz_xs, px_zs, zss, x, model.llik_scalings,
                        model.pz(x[0][0].device))


def _dropout_seed(model, seed: Optional[int]) -> Optional[int]:
    """The model's dropout seed: ``seed`` in train mode, where one is
    required (the JAX package's key for ``deterministic=False``), None in
    eval mode."""
    if not model.training:
        return None
    if seed is None:
        raise ValueError("need a seed for dropout in train mode")
    return seed


def neg_info_nce(model, x, temperature: float = 0.07, *,
                 seed: Optional[int] = None) -> torch.Tensor:
    """Negated symmetric InfoNCE over a two-tower model's projections
    (z1, z2) = model(x): with each row normalised (norm clipped at 1e-12)
    and logits = z1·z2ᵀ / temperature, −(CE(logits, I) + CE(logitsᵀ, I))/2,
    each CE a mean over the batch. A quantity to maximise. On one of
    several event shards the logits are the global batch's: both
    projections are gathered from every rank (``partition.gather_events``),
    as the JAX package's one program sees the whole batch."""
    z1, z2 = model(x, seed=_dropout_seed(model, seed))
    z1, z2 = partition.gather_events(z1), partition.gather_events(z2)
    z1 = z1 / torch.linalg.vector_norm(z1, dim=-1, keepdim=True).clamp_min(1e-12)
    z2 = z2 / torch.linalg.vector_norm(z2, dim=-1, keepdim=True).clamp_min(1e-12)
    logits = z1 @ z2.T / temperature
    labels = torch.arange(z1.shape[0], device=z1.device)
    return -(F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2.0


def mse(model, x, y: torch.Tensor, *, seed: Optional[int] = None) -> torch.Tensor:
    """Negated mean squared error of a regression head's prediction
    model(x) against ``y``: a quantity to maximise."""
    pred = model(x, seed=_dropout_seed(model, seed))
    return -torch.mean((pred - y) ** 2)
