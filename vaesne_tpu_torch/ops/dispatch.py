"""Kernel dispatch policy: which attention grids go to the fused kernel.

``routes_to_kernel`` reproduces the JAX layer's rule
(``vaesne_tpu/nn/layers.py`` ``MultiHeadAttention``) exactly, so the port
launches its kernel wherever the JAX package launches its Pallas kernel. The
two thresholds were tuned for the TPU: there the kernel's packed layout pads
short query axes to 128 lanes, which made small grids cheaper on the plain
path. They have not been re-tuned for the H100.
"""

from __future__ import annotations

import os

# Lq*Lk at or above this goes to the kernel whatever the row count
GRID_THRESHOLD = 1 << 16
# bytes of fp32 logits (rows*H*Lq*Lk*4) at or above this go to the kernel
LOGIT_BYTES_THRESHOLD = 1 << 28


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
