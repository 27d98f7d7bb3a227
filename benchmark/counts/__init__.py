"""Operations and bytes of the work the benchmark drives, from shapes alone.

The peaks are NVIDIA's published rates of one H100 SXM (dense): fp32 work
is held to the TF32 tensor-core rate, 495 TFLOP/s, the highest rate at
which the card does any fp32 product (the attention kernels compute fp32 as
3xTF32 on the tensor cores, so the 67 TFLOP/s of the fp32 CUDA cores would
let them read over 100%); bf16 to 989 TFLOP/s; HBM moves 3.35 TB/s.

A kernel's bound is the larger of its operations over the peak and its
bytes over the memory rate. The attention counts are those of the kernel
table's bound functions: every (query, key, head) pair of the padded grid
counts, masked or not; each input byte is read once and each output byte
written once. Model FLOPs count the products of every linear layer and of
every attention (QKᵀ and PV), the forward once; a backward is twice the
forward, and remat's re-run of the forward is not counted.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

PEAK_FLOPS = {"fp32": 495e12, "bf16": 989e12}
HBM_BYTES_S = 3.35e12
BYTES = {"fp32": 4, "bf16": 2}

# the rule that sends an attention grid to the kernels (K1 forward, K2 backward)
GRID_THRESHOLD = 1 << 16
LOGIT_BYTES_THRESHOLD = 1 << 28


def bound_s(nbytes: float, flops: float, dtype: str = "fp32") -> float:
    """The least time the card can take for the work, in seconds."""
    return max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype])


def attention_fwd(rows: int, lq: int, lk: int, E: int, H: int, masked: bool, stats: bool,
                  dtype: str = "fp32"):
    """(flops, bytes) of one K1 launch over [rows, Lq, E] queries and
    [rows, Lk, E] keys: 4·Dh flop per (query, key, head); q, k, v (and the
    mask) read once, the output (and with ``stats`` the fp32 row max and
    sum) written once."""
    dh, size = E // H, BYTES[dtype]
    nbytes = rows * (2 * lq + 2 * lk) * E * size + (rows * lk if masked else 0)
    nbytes += 2 * rows * H * lq * 4 if stats else 0
    return rows * H * lq * lk * 4 * dh, nbytes


def attention_bwd(rows: int, lq: int, lk: int, E: int, H: int, dtype: str = "fp32"):
    """(flops, bytes) of one K2 launch: 10·Dh flop per (query, key, head)
    (s = q·k again, dp = dout·v, dv, dq, dk); q, k, v, out, dout, the mask
    and the row statistics read once, dq, dk, dv written once."""
    dh, size = E // H, BYTES[dtype]
    nbytes = (rows * (3 * lq + 2 * lk) * E * size + rows * lk + 2 * rows * H * lq * 4
              + rows * (lq + 2 * lk) * E * size)
    return rows * H * lq * lk * 10 * dh, nbytes


def routes_to_kernel(rows: int, heads: int, lq: int, lk: int) -> bool:
    return lq * lk >= GRID_THRESHOLD or rows * heads * lq * lk * 4 >= LOGIT_BYTES_THRESHOLD


class Grid(NamedTuple):
    """One attention of a tower: its rows, query and key lengths, and
    whether its keys carry a padding mask."""

    rows: int
    lq: int
    lk: int
    masked: bool


class Shape(NamedTuple):
    """The sizes the counts need: widths, the light curve's points, the
    spectrum's bins and the latent tokens."""

    E: int
    F: int
    H: int
    layers: int
    L: int
    D: int
    n_photo: int
    n_spec: int


def shape_of(config: dict) -> Shape:
    m = config["model"]
    return Shape(m["model_dim"], m["ff_dim"], m["num_heads"], m["num_layers"], m["latent_len"],
                 m["latent_dim"], config["photometry_points"], config["spectrum_bins"])


def tower_grids(s: Shape, tower: str, rows: int) -> Iterator[Grid]:
    """Every attention of one pass of a tower over ``rows`` rows: the
    encoders' bottleneck (2·L tokens) over the observations, the decoders'
    observation grid over the latents (and the phase token)."""
    lq, lc, self_masked, cross_masked = {
        "photo_enc": (2 * s.L, s.n_photo, False, True),
        "spec_enc": (2 * s.L, s.n_spec + 1, False, True),
        "photo_dec": (s.n_photo, s.L, True, False),
        "spec_dec": (s.n_spec, s.L + 1, True, False),
    }[tower]
    for _ in range(s.layers):
        yield Grid(rows, lq, lq, self_masked)
        yield Grid(rows, lq, lc, cross_masked)


def kernel_grids(s: Shape, tower: str, rows: int):
    """The tower's grids that go to K1 (and K2 in a backward)."""
    return [g for g in tower_grids(s, tower, rows) if routes_to_kernel(g.rows, s.H, g.lq, g.lk)]


def _linear(i: int, o: int, tokens: int) -> int:
    return 2 * i * o * tokens


def _block(s: Shape, lq: int, lc: int) -> int:
    E = s.E
    return (_linear(E, E, lq) * 4 + 4 * lq * lq * E            # self-attention
            + _linear(E, E, lq) * 2 + _linear(E, E, lc) * 2 + 4 * lq * lc * E  # cross
            + _linear(E, s.F, lq) + _linear(s.F, E, lq))          # feed-forward


def tower_flops(s: Shape, tower: str) -> int:
    """Forward FLOPs of one row (an event, or a decoded sample) of a tower."""
    E, L, D = s.E, s.L, s.D
    sin_mlp = _linear(2 * E, E, 1) + _linear(E, E, 1)  # per token
    if tower == "photo_enc":
        n = s.n_photo
        pre = _linear(1, E, n) + sin_mlp * n + _linear(3 * E, E, n) + _linear(E, E, n)
        return pre + s.layers * _block(s, 2 * L, n) + _linear(E, E, 2 * L) + _linear(E, D, 2 * L)
    if tower == "spec_enc":
        n = s.n_spec
        pre = _linear(1, E, n) + _linear(2 * E, E, n) + _linear(E, E, n) + sin_mlp
        return (pre + s.layers * _block(s, 2 * L, n + 1) + _linear(E, E, 2 * L)
                + _linear(E, D, 2 * L))
    context = _linear(D, E, L) + _linear(E, E, L)
    if tower == "photo_dec":
        n = s.n_photo
        return (sin_mlp * n + context + s.layers * _block(s, n, L) + _linear(E, E, n)
                + _linear(E, 1, n))
    if tower == "spec_dec":
        n = s.n_spec
        return (sin_mlp * n + sin_mlp + context + s.layers * _block(s, n, L + 1)
                + _linear(E, E, n) + _linear(E, 1, n))
    raise ValueError(tower)


def mmvae_forward_flops(s: Shape, events: int, samples: int) -> int:
    """Forward FLOPs of the MoE-MMVAE over ``events`` events with
    ``samples`` decoded samples of each (M·K in training, K·M in a
    reconstruction): both encoders once per event, both decoders per sample."""
    return events * (tower_flops(s, "photo_enc") + tower_flops(s, "spec_enc")
                     + samples * (tower_flops(s, "photo_dec") + tower_flops(s, "spec_dec")))


def train_step_flops(s: Shape, batch: int, K: int) -> int:
    """Model FLOPs of one training step: the forward and twice it for the
    backward."""
    return 3 * mmvae_forward_flops(s, batch, 2 * K)
