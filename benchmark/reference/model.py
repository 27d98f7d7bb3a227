"""The plain reference of the photometry + spectra MoE-MMVAE (VAESNe).

Plain PyTorch over a dict of parameters named as the system under test
names them (``vaes.0.enc.blocks.block_0.self_attn.q_proj.weight``, ...): no
kernel, no cache, no batching of its own. It follows the published
architecture (YunyiShen/VAESNe-dev): per modality a perceiver-style
transformer encoder (bottleneck tokens cross-attending to the observations)
and decoder (query tokens on the observation grid cross-attending to the
latents), post-LN blocks, exact GELU, a Laplace posterior, prior and
likelihood, the decoders' mask-variance likelihood, and the MoE-IWAE.

Every product goes through ``Net.mm`` at the pass's precision: ``fp32``
(TF32 off), or the control's ``tf32``, which rounds both operands of every
product (forward and backward) to TF32 and accumulates in fp32, as the
tensor cores do.

A pass of the decoders works on a block of rows of the whole batch
(``Rows``): dropout masks are drawn for the whole batch, as the program
draws them, and the block keeps its rows, so the reference can run a large
batch block by block.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from . import rng

LN_EPS = 1e-5
MASK_BIAS = -1e9
PHOTO_MASK_VARIANCE = 1e8
SPEC_MASK_VARIANCE = 1e10
SCALE_EPS = 1e-6
LENGTH_RATIO = 982.0 / 60.0  # the light curve's likelihood weight, for both data sets


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class _RoundedProduct(torch.autograd.Function):
    """a @ b with both operands rounded, in the backward too."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ctx.rnd
        return r(g) @ r(b).transpose(-1, -2), r(a).transpose(-1, -2) @ r(g), None


class Rows(NamedTuple):
    """A block of rows: its first row in the whole batch, and the batch's
    rows (which the dropout draws and the dispatch rule see)."""

    start: int
    total: int


class Dims(NamedTuple):
    latent_len: int
    latent_dim: int
    model_dim: int
    num_heads: int
    ff_dim: int
    num_layers: int
    num_bands: int
    dropout: float


def dims_of(config: dict) -> Dims:
    m = config["model"]
    return Dims(m["latent_len"], m["latent_dim"], m["model_dim"], m["num_heads"], m["ff_dim"],
                m["num_layers"], config["num_bands"], m["dropout"])


def parameter_shapes(d: Dims) -> Dict[str, tuple]:
    """Every parameter of the model, by name, with its shape."""
    E, F, D, L = d.model_dim, d.ff_dim, d.latent_dim, d.latent_len
    out: Dict[str, tuple] = {}

    def linear(name, i, o):
        out[f"{name}.weight"] = (o, i)
        out[f"{name}.bias"] = (o,)

    def ln(name):
        out[f"{name}.weight"] = (E,)
        out[f"{name}.bias"] = (E,)

    def mlp(name, i, o):  # one hidden layer of E
        linear(f"{name}.hidden_0", i, E)
        linear(f"{name}.out", E, o)

    def single(name, o):
        linear(f"{name}.fc1", E, E)
        linear(f"{name}.fc2", E, o)

    def sin_mlp(name):
        linear(f"{name}.fc1", 2 * E, E)
        linear(f"{name}.fc2", E, E)

    def stack(name):
        for i in range(d.num_layers):
            b = f"{name}.block_{i}"
            for att in ("self_attn", "cross_attn"):
                for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    linear(f"{b}.{att}.{p}", E, E)
            for n in ("layernorm1", "layernorm2", "layernorm3"):
                ln(f"{b}.{n}")
            linear(f"{b}.ffn_0", E, F)
            linear(f"{b}.ffn_2", F, E)

    p = "vaes.0.enc"
    out[f"{p}.bandembd.weight"] = (d.num_bands, E)
    linear(f"{p}.fluxfc", 1, E)
    sin_mlp(f"{p}.time_embd")
    mlp(f"{p}.LCfc", 3 * E, E)
    out[f"{p}.initbottleneck"] = (2 * L, E)
    stack(f"{p}.blocks")
    single(f"{p}.bottleneckfc", D)
    p = "vaes.0.dec"
    sin_mlp(f"{p}.sinusoidal_time_embd")
    out[f"{p}.bandembd.weight"] = (d.num_bands, E)
    mlp(f"{p}.contextfc", D, E)
    stack(f"{p}.blocks")
    single(f"{p}.get_photo", 1)
    p = "vaes.1.enc"
    linear(f"{p}.flux_embd", 1, E)
    mlp(f"{p}.spectrafc", 2 * E, E)
    sin_mlp(f"{p}.phase_embd")
    out[f"{p}.initbottleneck"] = (2 * L, E)
    stack(f"{p}.blocks")
    single(f"{p}.bottleneckfc", D)
    p = "vaes.1.dec"
    sin_mlp(f"{p}.wavelength_embd_layer")
    sin_mlp(f"{p}.phase_embd_layer")
    mlp(f"{p}.contextfc", D, E)
    stack(f"{p}.blocks")
    single(f"{p}.get_flux", 1)
    return out


def _div_term(dim: int, step: int, device) -> torch.Tensor:
    return torch.exp(torch.arange(0, dim, step, dtype=torch.float32, device=device)
                     * (-math.log(10000.0) / dim))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 20.0, x, torch.log1p(torch.exp(torch.clamp(x, max=20.0))))


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def laplace_log_prob(x, loc, scale):
    return -torch.abs(x - loc) / scale - torch.log(2.0 * scale)


def laplace_sample(loc, scale, u):
    """The reparameterised draw from u ~ U[0, 1): loc − scale·sign(u')·log1p(−|u'|)
    with u' = (eps − 1) + (2 − eps)·u."""
    eps = torch.finfo(torch.float32).eps
    u = (eps - 1.0) + (2.0 - eps) * u
    return loc - scale * torch.sign(u) * torch.log1p(-torch.abs(u))


def log_mean_exp(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.logsumexp(x, dim=dim) - math.log(x.shape[dim])


def grid_loglik(loc: torch.Tensor, x: torch.Tensor, mask: torch.Tensor, big: float):
    """Σ over the grid of the Laplace log-density of x at scale 1 + big·mask:
    loc [K, B, N], x and mask [B, N] → [K, B]."""
    scale = 1.0 + big * mask.float()
    return laplace_log_prob(x[None], loc, scale[None]).sum(-1)


class Net:
    """One pass of the reference: the parameters, the precision of the
    products, and whether dropout is on (train mode)."""

    def __init__(self, params: Dict[str, torch.Tensor], dims: Dims, precision: str = "fp32",
                 training: bool = False):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.P, self.d, self.precision, self.training = params, dims, precision, training

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32":
            return a @ b
        return _RoundedProduct.apply(a, b, round_tf32)

    # -- layers ------------------------------------------------------------

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.P[f"{name}.weight"], self.P[f"{name}.bias"]
        y = self.mm(x.reshape(-1, x.shape[-1]), w.t()) + b
        return y.reshape(*x.shape[:-1], w.shape[0])

    def layer_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + LN_EPS) * self.P[f"{name}.weight"] \
            + self.P[f"{name}.bias"]

    def mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.linear(f"{name}.out", torch.relu(self.linear(f"{name}.hidden_0", x)))

    def single(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.linear(f"{name}.fc2", torch.relu(self.linear(f"{name}.fc1", x)))

    def sinusoid(self, x: torch.Tensor) -> torch.Tensor:
        ang = x[..., None] * _div_term(self.d.model_dim, 2, x.device)
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    def sinusoid_mlp(self, name: str, x: torch.Tensor) -> torch.Tensor:
        ang = x[..., None] * _div_term(self.d.model_dim, 1, x.device)
        enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.linear(f"{name}.fc2", torch.relu(self.linear(f"{name}.fc1", enc)))

    def embed(self, name: str, idx: torch.Tensor) -> torch.Tensor:
        return self.P[f"{name}.weight"][idx]

    def dropout(self, x: torch.Tensor, seed: Optional[int], rows: Optional[Rows]):
        rate = self.d.dropout if self.training else 0.0
        if rate == 0.0:
            return x
        return x * (_uniform(seed, x.shape, rows, x.device) >= rate) * (1.0 / (1.0 - rate))

    def attention(self, name: str, query, key, value, key_padding_mask, seed,
                  rows: Optional[Rows]) -> torch.Tensor:
        H = self.d.num_heads
        q = self.linear(f"{name}.q_proj", query)
        k = self.linear(f"{name}.k_proj", key)
        v = self.linear(f"{name}.v_proj", value)
        R, lq, E = q.shape
        lk, dh = k.shape[1], E // H

        def heads(t):
            return t.reshape(R, t.shape[1], H, dh).transpose(1, 2)

        s = self.mm(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(dh)
        if key_padding_mask is not None:
            bias = torch.zeros(key_padding_mask.shape, dtype=s.dtype, device=s.device)
            s = s + bias.masked_fill(key_padding_mask, MASK_BIAS)[:, None, None, :]
        w = torch.softmax(s, dim=-1)
        rate = self.d.dropout if self.training else 0.0
        if rate > 0.0:
            total = R if rows is None else rows.total
            if rng.routes_to_hash(total, H, lq, lk):
                keep = rng.hash_keep(seed, 0 if rows is None else rows.start, R, H, lq, lk,
                                     rate, s.device)
            else:
                keep = _uniform(seed, w.shape, rows, w.device) >= rate
            w = w * keep * (1.0 / (1.0 - rate))
        out = self.mm(w, heads(v)).transpose(1, 2).reshape(R, lq, E)
        return self.linear(f"{name}.out_proj", out)

    def block(self, name, x, context, mask, context_mask, seed, rows):
        def site(i):
            return rng.maybe_fold_in(seed, i)

        a = self.attention(f"{name}.self_attn", x, x, x, mask, site(0), rows)
        x = self.layer_norm(f"{name}.layernorm1", x + self.dropout(a, site(1), rows))
        c = self.attention(f"{name}.cross_attn", x, context, context, context_mask, site(4),
                           rows)
        x = self.layer_norm(f"{name}.layernorm2", x + self.dropout(c, site(5), rows))
        h = self.linear(f"{name}.ffn_2", gelu(self.linear(f"{name}.ffn_0", x)))
        return self.layer_norm(f"{name}.layernorm3", x + self.dropout(h, site(6), rows))

    def stack(self, name, x, context, mask, context_mask, seed, rows):
        for i in range(self.d.num_layers):
            x = self.block(f"{name}.block_{i}", x, context, mask, context_mask,
                           rng.maybe_fold_in(seed, i), rows)
        return x

    # -- towers ------------------------------------------------------------

    def _posterior(self, bottleneck):
        L = self.d.latent_len
        return bottleneck[:, :L], softplus(bottleneck[:, L:]) + SCALE_EPS

    @contextlib.contextmanager
    def _no_dropout(self):
        was, self.training = self.training, False
        try:
            yield
        finally:
            self.training = was

    def encode_photometry(self, flux, time, band, mask):
        """(posterior loc, scale) [B, L, D]; the encoders run without dropout."""
        with self._no_dropout():
            return self._encode_photometry(flux, time, band, mask)

    def encode_spectrum(self, flux, wavelength, phase, mask):
        """(posterior loc, scale) [B, L, D], without dropout. The linear path
        reads the wavelength and the sinusoid the flux, as the published
        model does."""
        with self._no_dropout():
            return self._encode_spectrum(flux, wavelength, phase, mask)

    def _encode_photometry(self, flux, time, band, mask):
        p = "vaes.0.enc"
        tokens = self.mlp(f"{p}.LCfc", torch.cat([
            self.linear(f"{p}.fluxfc", flux[..., None]),
            self.sinusoid_mlp(f"{p}.time_embd", time),
            self.embed(f"{p}.bandembd", band)], dim=-1))
        x = self.P[f"{p}.initbottleneck"][None].expand(flux.shape[0], -1, -1)
        h = self.stack(f"{p}.blocks", x, tokens, None, mask, None, None)
        return self._posterior(self.single(f"{p}.bottleneckfc", x + h))

    def _encode_spectrum(self, flux, wavelength, phase, mask):
        p = "vaes.1.enc"
        tokens = self.mlp(f"{p}.spectrafc", torch.cat([
            self.linear(f"{p}.flux_embd", wavelength[..., None]), self.sinusoid(flux)], dim=-1))
        context = torch.cat([tokens, self.sinusoid_mlp(f"{p}.phase_embd", phase[..., None])],
                            dim=1)
        mask = torch.cat([mask, mask.new_zeros((mask.shape[0], 1))], dim=1)
        x = self.P[f"{p}.initbottleneck"][None].expand(flux.shape[0], -1, -1)
        h = self.stack(f"{p}.blocks", x, context, None, mask, None, None)
        return self._posterior(self.single(f"{p}.bottleneckfc", x + h))

    def decode_photometry(self, time, band, z, mask, seed=None, rows=None):
        """Decoder means [R, 60] of latents z [R, L, D] on (time, band)."""
        p = "vaes.0.dec"
        x = self.sinusoid_mlp(f"{p}.sinusoidal_time_embd", time) + self.embed(f"{p}.bandembd",
                                                                               band)
        context = self.mlp(f"{p}.contextfc", z)
        h = self.stack(f"{p}.blocks", x, context, mask, None, seed, rows)
        return self.single(f"{p}.get_photo", x + h)[..., 0]

    def decode_spectrum(self, wavelength, phase, z, mask, seed=None, rows=None):
        """Decoder means [R, N] of latents z [R, L, D] on (wavelength, phase)."""
        p = "vaes.1.dec"
        x = self.sinusoid_mlp(f"{p}.wavelength_embd_layer", wavelength)
        context = torch.cat([self.mlp(f"{p}.contextfc", z),
                             self.sinusoid_mlp(f"{p}.phase_embd_layer", phase[..., None])], dim=1)
        h = self.stack(f"{p}.blocks", x, context, mask, None, seed, rows)
        return self.single(f"{p}.get_flux", x + h)[..., 0]

    def decode(self, d: int, x, z_flat, idx, mk: int, seed=None, rows=None):
        """Modality d's decoder means [R, N] for the latents z_flat [R, L, D],
        row r of event idx[r // mk]."""
        if d == 0:
            _, time, band, mask = x
            return self.decode_photometry(time[idx].repeat_interleave(mk, 0),
                                          band[idx].repeat_interleave(mk, 0), z_flat,
                                          mask[idx].repeat_interleave(mk, 0), seed, rows)
        _, wavelength, phase, mask = x
        return self.decode_spectrum(wavelength[idx].repeat_interleave(mk, 0),
                                    phase[idx].repeat_interleave(mk, 0), z_flat,
                                    mask[idx].repeat_interleave(mk, 0), seed, rows)


def _uniform(seed: int, shape, rows: Optional[Rows], device) -> torch.Tensor:
    """The dropout site's U[0, 1) draw for the whole batch, this block's rows."""
    if seed is None:
        raise ValueError("dropout in train mode needs a seed")
    full = tuple(shape) if rows is None else (rows.total,) + tuple(shape[1:])
    u = torch.rand(full, generator=rng.generator(seed, device), device=device)
    return u if rows is None else u[rows.start:rows.start + shape[0]]


def flatten_latents(z: torch.Tensor) -> torch.Tensor:
    """[K, B, L, D] → [B·K, L, D], row b·K + k."""
    K, B = z.shape[:2]
    return z.transpose(0, 1).reshape(B * K, *z.shape[2:])


def llik_scalings(beta: float) -> Sequence[float]:
    """The two modalities' likelihood weights: the light curve's length
    ratio, over β."""
    return (LENGTH_RATIO / beta, 1.0 / beta)


MASK_VARIANCES = (PHOTO_MASK_VARIANCE, SPEC_MASK_VARIANCE)
