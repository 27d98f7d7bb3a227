"""Mixture-of-experts multimodal VAE of the port (MoE-MMVAE).

Counterpart of ``vaesne_tpu/models/mmvae.py``. ``forward`` fills the M×M
cross-modal likelihood matrix: ``px_zs[e][d]`` is modality d decoded from
modality e's latents. ``reconstruct`` indexing: ``[0][0]`` LC→LC, ``[1][0]``
spec→LC, ``[0][1]`` LC→spec, ``[1][1]`` spec→spec.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..distributions import Distribution, Laplace
from ..utils.rng import maybe_fold_in
from .base_vae import BaseVAE, eval_mode

GOLDSTEIN_LENGTH_RATIO = 982.0 / 60.0


class MMVAE(nn.Module):
    """MoE-MMVAE over any list of modality VAEs (``vaes.0``, ``vaes.1``, …)."""

    prior = Laplace

    def __init__(self, vaes: Sequence[BaseVAE]):
        super().__init__()
        self.vaes = nn.ModuleList(vaes)

    @property
    def llik_scalings(self):
        return tuple(v.total_llik_scaling for v in self.vaes)

    def pz(self, device=None) -> Distribution:
        shape = (self.vaes[0].latent_len, self.vaes[0].latent_dim)
        return self.prior(torch.zeros(shape, device=device), torch.ones(shape, device=device))

    def forward(self, x, K: int = 1, generator: Optional[torch.Generator] = None,
                seed: Optional[int] = None):
        """Encode every modality (deterministic, as in the JAX package), then
        fill the M×M matrix with ONE decoder pass per modality: the M
        experts' latents are stacked on the K axis ([M·K, B, L, D]) and the
        result sliced back per expert. In train mode decoder d's dropout
        draws from ``fold_in(seed, d)``."""
        qz_xs, zss = [], []
        for m, vae in enumerate(self.vaes):
            qz_x = vae.encode(x[m], mean=False)
            qz_xs.append(qz_x)
            zss.append(qz_x.sample(generator, (K,)))
        M = len(self.vaes)
        z_all = torch.cat(zss, dim=0)  # [M*K, B, L, D]
        px_zs = [[None] * M for _ in range(M)]
        for d, vae in enumerate(self.vaes):
            px_all = vae.decode(z_all, x[d], maybe_fold_in(seed, d))
            for e in range(M):
                px_zs[e][d] = px_all.map(lambda a, e=e: a[e * K:(e + 1) * K])
        return qz_xs, px_zs, zss

    def generate(self, N: int, x, generator: Optional[torch.Generator] = None):
        """Prior draws decoded on every modality's grids, [N, B, ...] each."""
        B = x[0][0].shape[0]
        latents = self.pz(x[0][0].device).sample(generator, (N, B))
        with eval_mode(self):
            return [vae.decode(latents, x[d]).mean for d, vae in enumerate(self.vaes)]

    def reconstruct(self, x, K: int = 1, predictive: bool = False,
                    generator: Optional[torch.Generator] = None):
        """M×M matrix of posterior reconstructions: decoder means, or with
        ``predictive`` one draw each from the observed-point likelihood."""
        with eval_mode(self):
            _, px_zs, _ = self(x, K=K, generator=generator)
        if predictive:
            return [[px_z.observed.sample(generator) for px_z in row] for row in px_zs]
        return [[px_z.mean for px_z in row] for row in px_zs]

    def crossmodgen(self, x_in, x_out, direction=(0, 1), K: int = 1,
                    predictive: bool = False,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Encode modality direction[0] from ``x_in`` and decode modality
        direction[1] onto ``x_out``'s grids: [K, B, grid] decoder means, or
        with ``predictive`` draws from the observed-point likelihood."""
        e, d = direction
        zs = self.vaes[e].encode(x_in, mean=False).sample(generator, (K,))
        with eval_mode(self):
            px_z = self.vaes[d].decode(zs, x_out)
        if predictive:
            return px_z.observed.sample(generator)
        return px_z.mean


class PhotoSpecMMVAE(MMVAE):
    """Photometry + spectra MoE-MMVAE, ``vaes = [photometric, spectra]``.

    Both sub-VAEs take ``beta``; modality 0 (photometry) also takes
    ``llik_scaling = length_ratio`` so a 60-point light curve is not drowned
    by a 982-bin spectrum. The sub-VAEs passed in are updated in place."""

    def __init__(self, vaes: Sequence[BaseVAE], beta: float = 1.0,
                 length_ratio: float = GOLDSTEIN_LENGTH_RATIO):
        for i, vae in enumerate(vaes):
            vae.beta = beta
            vae.llik_scaling = length_ratio if i == 0 else 1.0
        super().__init__(vaes)
        self.beta = beta
        self.length_ratio = length_ratio
