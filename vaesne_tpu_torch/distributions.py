"""Distributions over tensors, for the PyTorch port.

Small dataclasses in place of ``torch.distributions``: the same API as the
JAX package's (``mean``, ``scale``, ``log_prob``, ``sample``, ``observed``),
with a ``torch.Generator`` where JAX threads a PRNG key, and ``map`` to apply
one tensor function to every array a distribution holds (the JAX package's
``tree_map`` over the pytree). Defaults everywhere are Laplace.
``MaskedGridLaplace.grid_loglik`` routes grids of 128 points or more to the
masked Laplace kernels (``ops/laplace.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from .ops.dispatch import laplace_routes_to_kernel
from .ops.laplace import masked_laplace_loglik, masked_laplace_loglik_reference

Shape = Tuple[int, ...]


def _as_shape(sample_shape: Union[int, Sequence[int]]) -> Shape:
    if isinstance(sample_shape, int):
        return (sample_shape,)
    return tuple(sample_shape)


@dataclasses.dataclass(frozen=True)
class Laplace:
    """Laplace(loc, scale), elementwise."""

    loc: torch.Tensor
    scale: torch.Tensor

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Laplace":
        return Laplace(fn(self.loc), fn(self.scale))

    @property
    def batch_shape(self) -> Shape:
        return tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))

    @property
    def mean(self) -> torch.Tensor:
        return self.loc.expand(self.batch_shape)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return -torch.abs(x - self.loc) / self.scale - torch.log(2.0 * self.scale)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape: Union[int, Sequence[int]] = ()) -> torch.Tensor:
        """Reparameterised draw: loc − scale·sign(u)·log1p(−|u|) with
        u ~ U(eps−1, 1). The lower bound uses ``finfo.eps``: with ``tiny``
        it rounds to −1 in float32 and log1p(−1) = −inf becomes reachable."""
        shape = _as_shape(sample_shape) + self.batch_shape
        dtype = torch.promote_types(self.loc.dtype, self.scale.dtype)
        eps = torch.finfo(dtype).eps
        u = torch.rand(shape, generator=generator, dtype=dtype, device=self.loc.device)
        u = (eps - 1.0) + (2.0 - eps) * u
        return self.loc - self.scale * torch.sign(u) * torch.log1p(-torch.abs(u))

    @property
    def observed(self) -> "Laplace":
        """The likelihood at the observed-point scale, Laplace(loc, 1)."""
        return Laplace(self.loc, torch.ones_like(self.loc))


@dataclasses.dataclass(frozen=True)
class Normal:
    """Normal(loc, scale), elementwise."""

    loc: torch.Tensor
    scale: torch.Tensor

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Normal":
        return Normal(fn(self.loc), fn(self.scale))

    @property
    def batch_shape(self) -> Shape:
        return tuple(torch.broadcast_shapes(self.loc.shape, self.scale.shape))

    @property
    def mean(self) -> torch.Tensor:
        return self.loc.expand(self.batch_shape)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * z**2 - torch.log(self.scale) - 0.5 * math.log(2.0 * math.pi)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape: Union[int, Sequence[int]] = ()) -> torch.Tensor:
        shape = _as_shape(sample_shape) + self.batch_shape
        noise = torch.randn(shape, generator=generator, dtype=self.loc.dtype,
                            device=self.loc.device)
        return self.loc + self.scale * noise

    @property
    def observed(self) -> "Normal":
        return Normal(self.loc, torch.ones_like(self.loc))


@dataclasses.dataclass(frozen=True)
class MaskedGridLaplace:
    """Laplace likelihood over a masked grid, scale = 1 + big·mask, held as
    (loc, mask, big) rather than a materialised scale tensor."""

    loc: torch.Tensor
    mask: torch.Tensor  # bool, True == missing
    big: float

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "MaskedGridLaplace":
        return MaskedGridLaplace(fn(self.loc), fn(self.mask), self.big)

    @property
    def scale(self) -> torch.Tensor:
        m = self.mask.expand(self.loc.shape)
        return 1.0 + self.big * m.to(torch.promote_types(self.loc.dtype, torch.float32))

    @property
    def batch_shape(self) -> Shape:
        return tuple(self.loc.shape)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return Laplace(self.loc, self.scale).log_prob(x)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape: Union[int, Sequence[int]] = ()) -> torch.Tensor:
        return Laplace(self.loc, self.scale).sample(generator, sample_shape)

    @property
    def observed(self) -> Laplace:
        """Laplace(loc, 1): the likelihood on observed points, without the
        1 + big·mask inflation (which only nulls masked points' gradient)."""
        return Laplace(self.loc, torch.ones_like(self.loc))

    def grid_loglik(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over all grid axes of ``log_prob(x)``, keeping the two leading
        (K, B) axes: [K, B], fp32. ``x`` is the unexpanded data [B, ...] or
        broadcasts against ``loc``.

        Rows are flattened BATCH-major (row b·K + k), as the decoder made
        them, so the flatten of ``loc`` and the mask undoes ``decode``'s exit
        transpose; unexpanded data stays [B, N] and the kernel reads row
        r // K of it. ``loc`` is cast to fp32 first (under bf16 autocast
        the decoder hands over bf16)."""
        K, B = self.loc.shape[:2]

        def flat(a):
            return a.transpose(0, 1).reshape(B * K, -1)

        loc = flat(self.loc).float()
        mask = flat(self.mask.expand(self.loc.shape))
        if tuple(x.shape) == tuple(self.loc.shape[1:]):
            data = x.reshape(B, -1)
        else:
            data = flat(x.expand(self.loc.shape))
        fn = (masked_laplace_loglik if laplace_routes_to_kernel(loc.shape[-1])
              else masked_laplace_loglik_reference)
        return fn(loc, data, mask, float(self.big)).reshape(B, K).transpose(0, 1)


Distribution = Union[Laplace, Normal, MaskedGridLaplace]


def get_mean(d: Distribution) -> torch.Tensor:
    """Mean of a distribution (every distribution here has it in closed
    form, so the JAX package's Monte Carlo fallback has no use)."""
    return d.mean


def log_mean_exp(value: torch.Tensor, dim: int = 0, keepdim: bool = False) -> torch.Tensor:
    """logsumexp(value, dim) − log(n)."""
    n = value.shape[dim]
    return torch.logsumexp(value, dim=dim, keepdim=keepdim) - math.log(n)


def kl_divergence(d1: Distribution, d2: Distribution,
                  generator: Optional[torch.Generator] = None,
                  K: int = 100) -> torch.Tensor:
    """Closed-form KL for Laplace‖Laplace and Normal‖Normal, else a Monte
    Carlo estimate over K draws of d1 from ``generator``; without one it
    raises, as the JAX package does without a key (it never draws from
    torch's global generator)."""
    if isinstance(d1, Laplace) and isinstance(d2, Laplace):
        delta = torch.abs(d1.loc - d2.loc)
        b1, b2 = d1.scale, d2.scale
        return torch.log(b2 / b1) + delta / b2 + (b1 / b2) * torch.exp(-delta / b1) - 1.0
    if isinstance(d1, Normal) and isinstance(d2, Normal):
        v1, v2 = d1.scale**2, d2.scale**2
        return 0.5 * (v1 / v2 + (d2.loc - d1.loc) ** 2 / v2 - 1.0 + torch.log(v2 / v1))
    if generator is None:
        raise ValueError("No closed-form KL for this pair; pass a generator for MC.")
    samples = d1.sample(generator, (K,))
    return (d1.log_prob(samples) - d2.log_prob(samples)).mean(0)
