"""Distributions over tensors, for the PyTorch port.

Small dataclasses in place of ``torch.distributions``: the same API as the
JAX package's (``mean``, ``variance``, ``scale``, ``log_prob``, ``sample``
and its torch-style alias ``rsample``, ``observed``), with a
``torch.Generator`` where JAX threads a PRNG key, and ``map`` to apply
one tensor function to every array a distribution holds (the JAX package's
``tree_map`` over the pytree). Defaults everywhere are Laplace.
``MaskedGridLaplace.grid_loglik`` routes grids of 128 points or more to the
masked Laplace kernels (``ops/laplace.py``). Every draw goes through
``draw_events``, which on an event shard keeps this rank's part of the
global batch's draw.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from .ops import partition
from .ops.dispatch import laplace_routes_to_kernel
from .utils.rng import device_generator
from .ops.laplace import masked_laplace_loglik, masked_laplace_loglik_reference

Shape = Tuple[int, ...]
EVENT_AXIS = 1  # of every draw: [K, B, ...] posterior and likelihood samples, [N, B, ...] prior


def draw_events(draw: Callable[[Shape], torch.Tensor], shape: Shape) -> torch.Tensor:
    """``draw(shape)``; on one of several event shards (``ops.partition``)
    the draw for the global batch, of which this rank keeps its events, so
    every rank consumes the generator as one process does and the ranks'
    samples are the one process's, event for event."""
    s = partition.active()
    if s is None or s.n_data == 1:
        return draw(shape)
    if len(shape) <= EVENT_AXIS:
        raise ValueError(f"a draw of shape {shape} has no event axis {EVENT_AXIS}")
    local = shape[EVENT_AXIS]
    full = shape[:EVENT_AXIS] + (local * s.n_data,) + shape[EVENT_AXIS + 1:]
    return draw(full).narrow(EVENT_AXIS, s.data_rank * local, local)


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

    @property
    def variance(self) -> torch.Tensor:
        return (2.0 * self.scale**2).expand(self.batch_shape)

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
        u = draw_events(lambda full: torch.rand(full, generator=generator, dtype=dtype,
                                                device=self.loc.device), shape)
        u = (eps - 1.0) + (2.0 - eps) * u
        return self.loc - self.scale * torch.sign(u) * torch.log1p(-torch.abs(u))

    rsample = sample  # the torch-style name, as in the JAX package

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

    @property
    def variance(self) -> torch.Tensor:
        return (self.scale**2).expand(self.batch_shape)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * z**2 - torch.log(self.scale) - 0.5 * math.log(2.0 * math.pi)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape: Union[int, Sequence[int]] = ()) -> torch.Tensor:
        shape = _as_shape(sample_shape) + self.batch_shape
        noise = draw_events(lambda full: torch.randn(full, generator=generator,
                                                     dtype=self.loc.dtype,
                                                     device=self.loc.device), shape)
        return self.loc + self.scale * noise

    rsample = sample

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

    @property
    def variance(self) -> torch.Tensor:
        return 2.0 * self.scale**2

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return Laplace(self.loc, self.scale).log_prob(x)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape: Union[int, Sequence[int]] = ()) -> torch.Tensor:
        return Laplace(self.loc, self.scale).sample(generator, sample_shape)

    rsample = sample

    @property
    def observed(self) -> Laplace:
        """Laplace(loc, 1): the likelihood on observed points, without the
        1 + big·mask inflation (which only nulls masked points' gradient)."""
        return Laplace(self.loc, torch.ones_like(self.loc))

    def grid_loglik(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over all grid axes of ``log_prob(x)``, keeping the two leading
        (K, B) axes: [K, B], fp32. ``x`` is the unexpanded data [B, ...] or
        broadcasts against ``loc``.

        On CUDA tensors with a grid routed to the kernels, ``loc`` and the
        mask go to K3 as [K, B, N] views of what the decoder made (an
        expert's slice of the stacked decode, the mask broadcast where it
        is), in loc's dtype (bf16 under autocast): no copy and no cast.
        Elsewhere rows are flattened BATCH-major (row b·K + k), as the
        decoder made them, so the flatten undoes ``decode``'s exit
        transpose; unexpanded data stays [B, N] and row r reads row r // K
        of it; ``loc`` is cast to fp32 first."""
        K, B = self.loc.shape[:2]
        n = math.prod(self.loc.shape[2:])
        unexpanded = tuple(x.shape) == tuple(self.loc.shape[1:])
        if self.loc.is_cuda and laplace_routes_to_kernel(n):
            loc = self.loc.reshape(K, B, n)
            mask = self.mask.expand(self.loc.shape).reshape(K, B, n)
            data = x.reshape(B, n) if unexpanded else x.expand(self.loc.shape).reshape(K, B, n)
            return masked_laplace_loglik(loc, data, mask, float(self.big))

        def flat(a):
            return a.transpose(0, 1).reshape(B * K, -1)

        loc = flat(self.loc).float()
        mask = flat(self.mask.expand(self.loc.shape))
        if unexpanded:
            data = x.reshape(B, -1)
        else:
            data = flat(x.expand(self.loc.shape))
        fn = (masked_laplace_loglik if laplace_routes_to_kernel(loc.shape[-1])
              else masked_laplace_loglik_reference)
        return fn(loc, data, mask, float(self.big)).reshape(B, K).transpose(0, 1)


Distribution = Union[Laplace, Normal, MaskedGridLaplace]


def get_mean(d, key: Optional[int] = None, K: int = 100) -> torch.Tensor:
    """Mean of a distribution: ``d.mean`` where it has one (every
    distribution here does), else the mean of K draws from a generator on
    loc's device seeded with ``key``, the port's integer stand-in for the
    JAX package's PRNG key; without one it raises, as the JAX package
    does."""
    mean = getattr(d, "mean", None)
    if mean is not None:
        return mean
    if key is None:
        raise ValueError("Distribution has no closed-form mean; pass a seed as key.")
    return d.sample(device_generator(key, d.loc.device), (K,)).mean(0)


def log_mean_exp(value: torch.Tensor, axis: int = 0, keepdims: bool = False) -> torch.Tensor:
    """logsumexp(value, axis) − log(n), with the JAX package's keywords."""
    n = value.shape[axis]
    return torch.logsumexp(value, dim=axis, keepdim=keepdims) - math.log(n)


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
