"""Distribution-parameterised VAE skeleton of the port.

The counterpart of ``vaesne_tpu/models/base_vae.py``, with one API for every
modality VAE:

  forward(x, K, generator, seed) -> (qz_x, px_z, zs)
  encode(x, mean)            -> posterior mean, or the distribution
  decode(zs, x, seed)        -> px_z over the modality grid, batch [K, B]
  reconstruct(x, K, ...)     -> reconstructions [K, B, ...]
  generate(N, x, generator)  -> prior draws decoded on x's grids [N, B, ...]

The K importance samples are flattened into the decoder batch BATCH-major
(row b·K + k), exactly as the JAX package does, and unflattened back to
[K, B, ...] at the exit. Dropout follows train/eval mode and, in train
mode, draws from the integer ``seed`` (the encoder from ``fold_in(seed, 0)``,
the decoder from ``fold_in(seed, 1)``); ``encode`` and ``reconstruct``
always run deterministic, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from ..distributions import Distribution, Laplace, MaskedGridLaplace
from ..utils.rng import maybe_fold_in


def tile_leading(a: torch.Tensor, K: int) -> torch.Tensor:
    """[B, ...] → [B·K, ...], row b·K + k holding batch element b."""
    return a.repeat_interleave(K, dim=0)


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """Run ``module`` with dropout off, restoring its mode afterwards."""
    was_training = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was_training)


class BaseVAE(nn.Module):
    """Shared behaviour of the modality VAEs. Subclasses set ``latent_len``,
    ``latent_dim``, ``beta``, ``llik_scaling`` and implement
    ``_enc_params(x, seed) -> (mu, scale)`` and ``_dec_dist(z_flat, x, K, seed)``."""

    prior = Laplace
    likelihood = Laplace
    posterior = Laplace

    @property
    def total_llik_scaling(self) -> float:
        return self.llik_scaling / self.beta

    def pz(self, device=None) -> Distribution:
        """Standard prior over [latent_len, latent_dim] tokens."""
        shape = (self.latent_len, self.latent_dim)
        return self.prior(torch.zeros(shape, device=device), torch.ones(shape, device=device))

    def forward(self, x, K: int = 1, generator: Optional[torch.Generator] = None,
                seed: Optional[int] = None):
        mu, scale = self._enc_params(x, maybe_fold_in(seed, 0))
        qz_x = self.posterior(mu, scale)
        zs = qz_x.sample(generator, (K,))
        return qz_x, self.decode(zs, x, maybe_fold_in(seed, 1)), zs

    def encode(self, x, mean: bool = True):
        """Posterior mean (or the whole posterior), always deterministic."""
        with eval_mode(self):
            mu, scale = self._enc_params(x)
        qz_x = self.posterior(mu, scale)
        return qz_x.mean if mean else qz_x

    def decode(self, zs: torch.Tensor, x, seed: Optional[int] = None) -> Distribution:
        """zs [K, B, latent_len, latent_dim] → likelihood with batch [K, B, ...]."""
        K, B = zs.shape[0], zs.shape[1]
        z_flat = zs.transpose(0, 1).reshape((B * K,) + tuple(zs.shape[2:]))
        px_flat = self._dec_dist(z_flat, x, K, seed)
        return px_flat.map(lambda a: a.reshape((B, K) + tuple(a.shape[1:])).transpose(0, 1))

    def _masked_likelihood(self, loc: torch.Tensor, mask: torch.Tensor,
                           big: float) -> Distribution:
        """The decoder's mask-variance trick: scale 1 + big·mask."""
        if self.likelihood is Laplace:
            return MaskedGridLaplace(loc, mask, big)
        return self.likelihood(loc, 1.0 + big * mask.to(loc.dtype))

    def reconstruct(self, x, K: int = 1, predictive: bool = False,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Posterior-draw reconstructions [K, B, ...]: decoder means, or with
        ``predictive`` one draw each from the observed-point likelihood."""
        qz_x = self.encode(x, mean=False)
        zs = qz_x.sample(generator, (K,))
        with eval_mode(self):
            px_z = self.decode(zs, x)
        if predictive:
            return px_z.observed.sample(generator)
        return px_z.mean

    def generate(self, N: int, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Prior draws z ~ p(z) of shape [N, B, L, D] decoded on x's grids."""
        B = x[0].shape[0]
        zs = self.pz(x[0].device).sample(generator, (N, B))
        with eval_mode(self):
            return self.decode(zs, x).mean
