"""Kernel dispatch policy: which grids go to the fused kernels.

``routes_to_kernel`` (attention) and ``laplace_routes_to_kernel`` (the
masked Laplace likelihood) reproduce the JAX package's rules
(``vaesne_tpu/nn/layers.py`` ``MultiHeadAttention`` and
``vaesne_tpu/distributions.py`` ``MaskedGridLaplace.grid_loglik``) exactly,
so the port launches a kernel wherever the JAX package launches its Pallas
kernel. The thresholds were tuned for the TPU: there the kernels' layouts
pad short axes to 128 lanes, which made small grids cheaper on the plain
path. They have not been re-tuned for the H100.
"""

from __future__ import annotations

import os

# Lq*Lk at or above this goes to the kernel whatever the row count
GRID_THRESHOLD = 1 << 16
# bytes of fp32 logits (rows*H*Lq*Lk*4) at or above this go to the kernel
LOGIT_BYTES_THRESHOLD = 1 << 28
# likelihood grids of at least this many points go to the Laplace kernels
LAPLACE_MIN_GRID = 128


def env_flag(name: str, default: bool) -> bool:
    """Boolean environment knob: anything but ``0``/``false``/``False`` is
    true. The one parse shared by every VAESNE_* flag."""
    env = os.environ.get(name)
    if env is None:
        return default
    return env not in ("0", "false", "False")


def routes_to_kernel(rows: int, num_heads: int, lq: int, lk: int) -> bool:
    """True where the fused attention kernel takes a [rows, Lq, E] x
    [rows, Lk, E] grid: a large Lq*Lk, or a logit volume of 256 MiB."""
    return (lq * lk >= GRID_THRESHOLD
            or rows * num_heads * lq * lk * 4 >= LOGIT_BYTES_THRESHOLD)


def laplace_routes_to_kernel(n: int) -> bool:
    """True where the masked Laplace kernels take a grid of ``n`` points
    per row (the 982-bin spectra; not the 60-point light curves)."""
    return n >= LAPLACE_MIN_GRID
