"""Drive the PyTorch port's serving, training and evaluation paths, the
image VAE's, the contrastive and regression drivers', the multi-GPU paths,
the auxiliary blocks, the reference-weight import and the compute switches,
on one CUDA card and check them.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with an NVIDIA H100 (Hopper,
sm_90a) and nvcc. Phases, each printing its own lines:

  1. environment: torch/CUDA versions, the card's name and power limit,
     TF32 off for matmuls and cuDNN;
  2. build: every CUDA kernel under vaesne_tpu_torch/csrc/ with nvcc, one
     process per source in parallel, and any register spill;
  3. each kernel against its plain PyTorch version on the card at the
     shapes the paths give it (serving, the B = 192 step, the B = 16
     drivers of phase 10, the 983x983 spectra context of phase 13(c)): K1 attention forward at rate 0 and 0.1,
     its measured keep rate, K2 attention backward against autograd
     through the plain version, K3/K4 masked Laplace forward and backward
     in fp32 and bf16 on experts' slices of a stacked decode;
  4. the serving path at the flagship model's full width (random weights
     from --seed): embed, crossmodal, crossmodal_ci and reconstruct through
     InferenceServer, with K1's launch count checked against what the
     dispatch rule predicts for every call;
  5. the whole decode on the card (kernel) against the same module on the
     CPU (plain version);
  6. serving times: K1, its plain version and the library yardstick
     (scaled_dot_product_attention, timed here only) with CUDA events, the
     end-to-end crossmodal_ci latency, and a torch.profiler breakdown;
  7. the training path at full width: the m-IWAE step of bench.py (B = 192,
     K = 2, dropout 0.1, AdamW 1e-4, clip 10, remat on), 5 steps in fp32
     and 5 under bf16 autocast, every kernel's launches per step checked;
  8. one train step's loss and gradients on the card against the CPU, at
     dropout 0 on pinned posterior noise;
  9. training times: each kernel at the training shapes in fp32 and bf16,
     its bound beside the exp2 and dropout-hash floors, its plain version
     and its library yardstick (K1 at rate 0 and 0.1 beside SDPA without
     and with dropout), and a profile of one step;
     K1 at rate 0.1 and K2 are held against their plain versions on the
     same R = 768 inputs; K3 and K4 on experts' [K, B, 982] slices (the
     step's [2, 192], the drivers' [2, 16], the ZTF driver's [8, 32]),
     each beside one torch.sum over the same rows and the wrapper's host
     time per call; the device time and kernels of one grid_loglik
     forward and backward on an expert's slice of a real MMVAE decode;
 10. the training drivers at the flagship widths on synthetic data from
     --seed, checkpoints and logs under build/chip_smoke/: (a)
     train_photospectra.main for 3 epochs, saving each, every epoch's
     launches checked; (b) 2 epochs into another directory, then resumed
     to 3, equal to (a); (c) InferenceServer.from_checkpoint on (a)'s
     directory, crossmodal_ci on 32 held-out events equal bitwise to a
     server over (a)'s model; (d) one epoch of each other driver; (e) the
     driver's samples/s per epoch of (a), and a profile of one epoch of
     the driver resumed from (a)'s checkpoint;
 11. the evaluation drivers on the bridged flagship checkpoint, held
     against the JAX package's K = 100 results (artifacts/eval*/);
 12. the host-galaxy image VAE (ImageVAEConfig: 60x60x3, patch 2, the
     hybrid decoder): (a) K1 at rate 0 and 0.1 and K2 against their plain
     versions on its unmasked grids (900x900, 3,600x3,600, 400x400) and
     K1's keep rate at 900x900; (b) the bridged synthetic_image_4-4_patch2
     checkpoint's reconstruction on the card against the JAX package's
     and against the port on the CPU; (c) train_image.main for 2 epochs,
     then one epoch of the per-pixel decoder and of the MNIST config,
     every epoch's launches checked, samples/s, peak memory, a
     kill-and-resume bitwise equal to the 2 epochs, and a profile of one
     step; (d) try_models model=image at K = 100; (e) the kernels' device
     times and bounds at the image grids;
 13. contrastive pretraining and the regression heads at the shipped
     widths on the synthetic data: (a) the bridged
     goldstein_contrastive_4-4_proj8's projections and InfoNCE on the 103
     test events against the JAX package's; (b) train_contrastive.main for
     3 epochs, a run resumed from epoch 2 bitwise the same, samples/s
     (StepTimer), peak memory, a profiled step; (c) train_contrastive
     model.selfattn=true for an epoch, the spectra tower's 983x983
     key-padded context self-attention on K1 and K2, launches as predicted,
     both held against their plain versions on the captured input and
     timed beside their bounds, the plain versions and SDPA; (d)
     train_regression.main for both modalities and the three backbones, the
     frozen backbones bitwise unchanged and outside AdamW; (e)
     eval_regression.main on the bridged goldstein_photometry2param_mmvae
     head against the JAX package's CPU result;
 14. multi-GPU on the one card (vaesne_tpu_torch.parallel; spawned ranks,
     each its own process): (a) a world-1 NCCL group's DDP flagship step
     at B = 192 against the one-process step; (b) two ranks sharing the
     card over gloo, 96 events each, at dropout 0 and 0.1 against the
     one-process step, every rank's launches as the global-row dispatch
     predicts, K1/K2 held against their plain versions on every rank's
     captured input with its shard seed, the ranks' mask streams disjoint;
     (c) a 1x2 tensor-parallel step (2 heads a rank); (d) DP crossmodal_ci
     at K = 100 against one process; per-rank samples/s and peak memory
     (two ranks on one card: not a scaling number);
 15. the extras and the reference migration: (a) TransformerModel at the
     flagship's block widths (E 32, 4 heads, ff 32, 4 layers) over
     [R, 982, 32] with a key-padding mask and a [R, 5, 32] context, R the
     fewest rows that route, its forward at rate 0 and a backward at
     dropout 0.1 on K1 and K2 against the plain path on the card, launches
     as predicted, K1/K2 on the captured input timed beside their bounds;
     (b) RelativeMultiHeadAttention over 982x982 (no kernel serves it) on
     the card against the CPU, and its time; (c) GumbelSoftmax with a fixed
     generator on the card against the CPU; (d) a stand-in whole-module
     reference pickle imported through import_reference_pickle into a
     PhotoSpecMMVAE on the card, its crossmodal_ci against the CPU port.
 16. the JAX package's compute switches, each set for its own sub-phase
     and restored after it (phases 1-15 run with all three unset): (a)
     VAESNE_BF16=1 train_photospectra.main at the flagship widths for 3
     epochs, every epoch's launches phase 10's, K1/K2 on bf16 q, k, v and
     K3 on bf16 loc, 2 epochs resumed to 3 bitwise the run, fp32 parameters
     and moments, samples/s and the busy share beside phase 10's fp32; (b)
     bench.py's VAESNE_REMAT=0 B = 192 step in bf16 and fp32: launches as
     predicted without remat's re-run, the loss and gradients bitwise remat
     on's, samples/s and peak memory both ways; (c) VAESNE_BF16=1
     eval_goldstein against artifacts/eval/ with phase 11's gates (a miss
     is reported as a finding), events/s beside fp32; (d)
     VAESNE_DROPOUT_BITS=16 and 32: K1/K2 against their plain versions at
     R = 768 with phase 3's gates, their times, the keep rate, and the
     forward's and backward's masks against the plain mask; (e) bf16 K2 on
     Queue 3's near-uniform 983x983 input beside the JAX kernel's error
     (artifacts/queue3_bf16_k2/); (f) the four newly bridged checkpoints
     served on the card within 1e-4 of their JAX outputs, K1's launches as
     predicted.
 17. train.scan_epoch: one CUDA graph of the train step, replayed at every
     step after a warm-up step, against the step loop
     (train.scan_epoch=false): (a) train_photospectra (B = 16, K = 2,
     dropout 0.1) for 3 epochs in fp32, the two bitwise equal (parameters,
     AdamW state, step, generator, losses) with phase 10's launches every
     epoch, the graph run's epoch-2 checkpoint resumed under the graph
     bitwise the run, then in bf16 and at train.accum_steps=2 (one epoch
     of 6 steps on 128 synthetic events); (b)
     train_image in fp32 and a bf16 run resumed from its epoch-2
     checkpoint, train_contrastive at its defaults and with
     model.selfattn=true, a frozen-backbone train_regression, each bitwise
     its step loop; (c) samples/s, busy share and peak memory of graph and
     step loop: the B = 16 driver in fp32 and bf16, bench.py's B = 192
     step in fp32 and bf16 with VAESNE_REMAT 1 and 0, train_image,
     train_contrastive.
 18. train.scan_epoch under a data-parallel train.mesh: the step as two
     CUDA graphs per rank (the gradients; the update) around the gradient
     all-reduce, which runs eagerly between their replays, against the DDP
     step loop (spawned ranks on the one card): (a) a world-1 NCCL group
     runs train_photospectra inside its rank for an epoch in fp32 on 128
     synthetic events (6 steps), the two bitwise equal with phase 10's
     launches; (b) two ranks sharing the card over gloo, 8 events a rank,
     in fp32 (3 epochs, the graph run's epoch-2 checkpoint resumed under
     the graph), VAESNE_BF16=1 and train.accum_steps=2 (1 epoch each),
     these two on the 128 events (6 steps an epoch), each bitwise its step
     loop, every rank's launches as the global-row dispatch predicts, each
     rank's K1/K2 held against their plain versions on the last replayed
     step's input with its shard seed; (c) a 1x2 tensor-parallel driver
     keeps the step loop and prints which collective kept it there, and DP
     train_contrastive prints no such line; (d) samples/s a rank, busy
     share and peak memory of graph and step loop for (b)'s fp32 driver and
     the B = 192 DP step (96 events a rank), and the gloo all-reduce's time
     (two ranks on one card: not a scaling number).
 19. train_contrastive under a data-parallel train.mesh on two gloo ranks
     sharing the card (16 events a rank): each (micro)batch's step split at
     InfoNCE's gather into CUDA graphs of the towers, the head and the
     towers' backward, the gather's two all-reduces and the gradient
     all-reduce eager between them, against the DDP step loop: (a)
     model.selfattn=true in fp32 (3 epochs, the graph run's epoch-2
     checkpoint resumed under the graph) and VAESNE_BF16=1 (1 epoch), each
     bitwise its step loop, every rank's K1/K2 launches as predicted and
     held against their plain versions on the last replayed step's
     983x983 input with its shard seed; (b) the default towers and
     model.selfattn=true at train.accum_steps=2 (1 epoch each), bitwise;
     (c) samples/s a rank, rank 0's busy share and peak memory of graph
     and step loop for (a)'s fp32 run, and the time of each eager
     collective of a step.

Any failure raises and exits non-zero before the last line, which is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import vaesne_tpu_torch.distributions as distributions
import vaesne_tpu_torch.evaluation.harness as harness
import vaesne_tpu_torch.nn.layers as layers
import vaesne_tpu_torch.ops.attention as attention
import vaesne_tpu_torch.ops.laplace as laplace
import vaesne_tpu_torch.parallel as parallel
from vaesne_tpu_torch import (
    InferenceServer,
    PhotometricVAE,
    PhotoSpecMMVAE,
    SpectraVAE,
    TrainState,
    adamw,
    init_params,
    make_train_step,
    objectives,
)
from vaesne_tpu_torch.data import (
    image_tuple,
    make_goldstein_like,
    make_images,
    multimodal_tuple,
    photometry_tuple,
)
from vaesne_tpu_torch.experiments import (
    eval_goldstein,
    eval_masking,
    eval_regression,
    train_contrastive,
    train_image,
    train_photometry,
    train_photospectra,
    train_regression,
    train_spectra,
    train_ztf_photospect,
    train_ztf_spectra,
    try_models,
)
from vaesne_tpu_torch.experiments.common import optimizer_from_config, resolve_dataset
from vaesne_tpu_torch.nn import GumbelSoftmax, RelativeMultiHeadAttention, TransformerModel
from vaesne_tpu_torch.ops import _build, counters, laplace_routes_to_kernel, routes_to_kernel
from vaesne_tpu_torch import training
from vaesne_tpu_torch.training import to_device
from vaesne_tpu_torch.utils import fold_in, rng, torch_port
from vaesne_tpu_torch.utils.config import (
    ContrastiveConfig,
    ImageVAEConfig,
    PhotoSpectraMMVAEConfig,
    RegressionConfig,
    parse_overrides,
)
from vaesne_tpu_torch.utils.profiling import StepTimer

# the flagship model (vaesne_tpu/experiments/train_photospectra.py, bench.py)
NUM_BANDS, LATENT_LEN, LATENT_DIM = 6, 4, 4
MODEL_DIM, FF_DIM, HEADS, LAYERS = 32, 32, 4, 4
LP, NS = 60, 982  # light-curve points, spectrum bins
BUCKETS = (8, 32, 128, 512)
K_SERVE = 100
# the training step bench.py times (bench.py:62-66, :105-144; training.py:38-69)
B_TRAIN, K_TRAIN, DROPOUT, LR, TRAIN_STEPS = 192, 2, 0.1, 1e-4, 5
M = 2  # modalities: every decoder runs on M·K·B rows
BIG_SPECTRA = 1e10  # the spectra likelihood's mask variance
# the flagship driver's batch (PhotoSpectraMMVAEConfig) and phase 10's run
B_DRIVER, DRIVER_EPOCHS, N_HELD_OUT = 16, 3, 32
SMOKE_DIR = os.path.join("build", "chip_smoke")
# phase 11: the shipped flagship checkpoint bridged into the port, the JAX
# package's K = 100 results for it, and the harness's chunk sizes
EVAL_CKPT = os.path.join("artifacts", "ckpt_torch", "goldstein_photospec_4-4_K2_beta1.0")
EVAL_REF = {"latent": os.path.join("artifacts", "eval", "avg_metrics.npz"),
            "predictive": os.path.join("artifacts", "eval_predictive", "avg_metrics.npz")}
SWEEP_REF = os.path.join("artifacts", "eval", "masking_sweep.npz")
K_EVAL, SUITE_CHUNK, SWEEP_CHUNK = 100, 64, 32
# phase 12: the image VAE (ImageVAEConfig: 60x60x3, patch 2, the hybrid
# decoder, latent 4x4, model_dim 32, 4 heads, 4 layers, B = 32, K = 1);
# its decoders' self-attention grids: 900 patch tokens (patch 2), 3,600
# pixels (hybrid=False), 400 patch tokens (the MNIST config's patch 3)
IMG = 60
IMAGE_TOKENS, PIXEL_TOKENS, MNIST_TOKENS = (IMG // 2) ** 2, IMG * IMG, (IMG // 3) ** 2
B_IMAGE, IMAGE_EPOCHS, N_IMAGES = 32, 2, 512
K_TRY, N_TRY = 100, 4
IMAGE_CKPT = os.path.join("artifacts", "ckpt_torch", "synthetic_image_4-4_patch2")
IMAGE_REF = os.path.join(IMAGE_CKPT, "jax_reconstruction.npy")
# phase 13: the contrastive towers (ContrastiveConfig: latent 4x4, model_dim
# 32, 4 heads, 4 layers, proj 8, B = 32, tau 0.1) and the regression heads
# (RegressionConfig: MLP (128,)x4, B = 32) on resolve_dataset(None,
# "goldstein"): 512 synthetic events, 409 to train, 103 to test. The spectra
# tower's context is the 982 bins plus the phase token
B_CONTRA, CONTRA_EPOCHS, CONTEXT = 32, 3, NS + 1
CONTRA_CKPT = os.path.join("artifacts", "ckpt_torch", "goldstein_contrastive_4-4_proj8")
CONTRA_REF = os.path.join(CONTRA_CKPT, "jax_projections.npz")
HEAD_CKPT = os.path.join("artifacts", "ckpt_torch", "goldstein_photometry2param_mmvae")
HEAD_REF = os.path.join(HEAD_CKPT, "jax_absdiff.npy")
HEAD_TPU = os.path.join("artifacts", "eval", "avg_absdiff_photometry2goldstein_param_mmvae.npz")
REGRESSION_BACKBONES = {"mmvae": EVAL_CKPT, "contrast": CONTRA_CKPT, "end2end": None}

# phase 16: the JAX package's compute switches, each set for one sub-phase
SWITCHES = ("VAESNE_BF16", "VAESNE_REMAT", "VAESNE_DROPOUT_BITS")
BF16_EPOCHS, REMAT_STEPS = 3, 4
# the bridged unimodal and ZTF checkpoints and their reference events
# (tests/torch_parity.py::REFERENCE_EVENTS): (data kind, tuple builder)
BRIDGED_VAES = {"goldstein_photometry_4-4": ("goldstein", "photometry_tuple"),
                "goldstein_spectra_4-4": ("goldstein", "spectra_tuple"),
                "ztf_photospec_4-4_K8_beta0.5": ("ztf", "multimodal_tuple"),
                "ztf_spectra_4-4": ("ztf", "spectra_tuple")}
REFERENCE_EVENTS = dict(n=4, seed=1)

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s, fp32
# FMA-pipe flop/s, bf16 tensor-core flop/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
MUFU_PER_SM_CLK = 16  # exp2 results per SM per clock
INT32_PER_SM_CLK = 64  # 32-bit integer ALU results per SM per clock (half the fp32 rate)
# integer ALU operations of the dropout hash per (query, key, head): xor,
# shift, xor, compare (its two multiplies run on the FMA pipe)
HASH_OPS = 4


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def make_batch(n, seed):
    """Host-side (photometry, spectra) batch at the Goldstein contract: the
    numpy recipe of bench.make_batch (bench.py:69-96), copied here."""
    rng = np.random.default_rng(seed)
    photo = (rng.normal(size=(n, LP)).astype(np.float32),
             np.sort(rng.uniform(-1, 1, (n, LP)), axis=1).astype(np.float32),
             rng.integers(0, NUM_BANDS, (n, LP)).astype(np.int64),
             rng.uniform(size=(n, LP)) < 0.2)
    spec = (rng.normal(size=(n, NS)).astype(np.float32),
            np.linspace(-1, 1, NS, dtype=np.float32)[None].repeat(n, 0),
            rng.normal(size=(n,)).astype(np.float32),
            rng.uniform(size=(n, NS)) < 0.2)
    return photo, spec


def flagship(seed, dropout=DROPOUT):
    vaes = [PhotometricVAE(num_bands=NUM_BANDS, latent_len=LATENT_LEN, latent_dim=LATENT_DIM,
                           model_dim=MODEL_DIM, ff_dim=FF_DIM, num_heads=HEADS,
                           num_layers=LAYERS, dropout=dropout),
            SpectraVAE(latent_len=LATENT_LEN, latent_dim=LATENT_DIM, model_dim=MODEL_DIM,
                       ff_dim=FF_DIM, num_heads=HEADS, num_layers=LAYERS, dropout=dropout)]
    return init_params(PhotoSpecMMVAE(vaes, beta=1.0), torch.Generator().manual_seed(seed))


# -- launch counts the dispatch rule predicts ---------------------------------

def stack_launches(rows, lq, lk_context):
    """Kernel launches of one TransformerStack: per layer a self-attention
    (lq x lq) and a cross-attention (lq x lk_context)."""
    return LAYERS * (int(routes_to_kernel(rows, HEADS, lq, lq))
                     + int(routes_to_kernel(rows, HEADS, lq, lk_context)))


def encoder_launches(m, rows):
    # 2·latent_len bottleneck queries over the light curve, or over the
    # spectrum plus its phase token
    return stack_launches(rows, 2 * LATENT_LEN, LP if m == 0 else NS + 1)


def decoder_launches(d, rows):
    # grid queries over the latent tokens (plus the phase token for spectra)
    return stack_launches(rows, LP, LATENT_LEN) if d == 0 else stack_launches(
        rows, NS, LATENT_LEN + 1)


# -- timing --------------------------------------------------------------------

def seed_word(seed):
    """K1/K2's dropout seed as its word on the card, made once: a timed
    call then launches the kernel alone (an int seed adds the word's fill)."""
    return rng.seed_word(seed, "cuda")


def time_ms(fn, reps=10, warmup=3, inner=1):
    """Median milliseconds of one ``fn`` call on the card: CUDA events
    around ``inner`` back-to-back calls (many for a microsecond kernel, so
    the events' resolution does not dominate), divided by ``inner``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def randn_like(t, seed):
    """Standard normal draws of ``t``'s shape and dtype on its device, from
    their own generator."""
    g = torch.Generator(t.device).manual_seed(seed)
    return torch.randn(t.shape, device=t.device, dtype=t.dtype, generator=g)


def attention_inputs(rows, lq, lk, masked, seed, full_row=False):
    g = torch.Generator("cuda").manual_seed(seed)
    e = HEADS * (MODEL_DIM // HEADS)
    q = torch.randn(rows, lq, e, device="cuda", generator=g)
    k = torch.randn(rows, lk, e, device="cuda", generator=g)
    v = torch.randn(rows, lk, e, device="cuda", generator=g)
    mask = None
    if masked:
        mask = torch.rand(rows, lk, device="cuda", generator=g) < 0.2
        if full_row:
            mask[0] = True
    return q, k, v, mask


# Queue 3's input: a near-uniform, key-padded 983 x 983 attention like the
# contrastive spectra context's (train_contrastive model.selfattn=true),
# made with numpy from a seed so that both packages see the same values
QUEUE3 = os.path.join("artifacts", "queue3_bf16_k2", "jax_interpret_error.json")
QUEUE3_SEED, QUEUE3_ROWS, QUEUE3_MASKED, QUEUE3_MAX_LOGIT = 0, 2, 512, 0.093


def bf16_grid(x):
    """float32 numpy ``x`` rounded to the nearest bfloat16 (ties to even),
    kept as float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def near_uniform_attention_inputs(seed=QUEUE3_SEED, rows=QUEUE3_ROWS):
    """(q, k, v, dout) float32 numpy [rows, 983, 32] on the bfloat16 grid and
    the key-padding mask bool [rows, 983], 4 heads of 8: the statistics of
    the context self-attention input of train_contrastive
    model.selfattn=true, captured on the card. Its q, k and v are a
    per-head mean, the projections' biases at random initialisation (norm
    0.3–0.5 a head), plus a spread of 0.04; the last 512 of 983 keys are
    masked (52.1%); q is scaled so that the largest |logit| over the
    observed keys is 0.093; dout is standard normal."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(0.0, 0.15, (3, 1, 1, MODEL_DIM)).astype(np.float32)
    q, k, v = (mu[i] + np.float32(0.04) * rng.standard_normal((rows, CONTEXT, MODEL_DIM),
                                                              dtype=np.float32)
               for i in range(3))
    dout = rng.standard_normal((rows, CONTEXT, MODEL_DIM), dtype=np.float32)
    mask = np.zeros((rows, CONTEXT), bool)
    mask[:, CONTEXT - QUEUE3_MASKED:] = True
    dh = MODEL_DIM // HEADS
    logits = np.einsum("rqhd,rkhd->rhqk", q.reshape(rows, CONTEXT, HEADS, dh).astype(np.float64),
                       k.reshape(rows, CONTEXT, HEADS, dh).astype(np.float64)) / np.sqrt(dh)
    q = q * np.float32(QUEUE3_MAX_LOGIT / np.abs(logits[..., ~mask[0]]).max())
    return (*(bf16_grid(a) for a in (q, k, v, dout)), mask)


def bound(nbytes, ops, peak_ops_s):
    """(ms, resource): the least time for the work, the larger of its bytes
    over the memory rate and its operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak_ops_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound(rows, lq, lk, dtype, masked, stats=False):
    """K1's bound for one launch: q, k, v (and the mask) read once, the
    output (and with ``stats`` the fp32 row max and sum) written once;
    4·Dh flop per (query, key, head) at the card's peak for the dtype (the
    dropout hash's integer operations are not counted)."""
    dh = MODEL_DIM // HEADS
    size = torch.finfo(dtype).bits // 8
    nbytes = rows * (2 * lq + 2 * lk) * MODEL_DIM * size + (rows * lk if masked else 0)
    nbytes += 2 * rows * HEADS * lq * 4 if stats else 0
    return bound(nbytes, rows * HEADS * lq * lk * 4 * dh, PEAK_FLOPS[dtype])


def attention_bwd_bound(rows, lq, lk, dtype):
    """K2's bound for one backward: q, k, v, out, dout, the mask and the
    row statistics read once, dq, dk, dv written once; 10·Dh flop per
    (query, key, head): s = q·k again, dp = dout·v, dv, dq and dk."""
    dh = MODEL_DIM // HEADS
    size = torch.finfo(dtype).bits // 8
    nbytes = (rows * (3 * lq + 2 * lk) * MODEL_DIM * size + rows * lk
              + 2 * rows * HEADS * lq * 4 + rows * (lq + 2 * lk) * MODEL_DIM * size)
    return bound(nbytes, rows * HEADS * lq * lk * 10 * dh, PEAK_FLOPS[dtype])


def laplace_bound(rows, n, x_rows, backward, dtype=torch.float32):
    """K3/K4's bound: loc [R, N] in its dtype, fp32 x [Rx, N] and the byte
    mask [R, N] read once, the fp32 row sums [R] written (K3), or g [R] read
    and dloc [R, N] written in loc's dtype (K4); ~7 fp32 operations per
    point."""
    size = torch.finfo(dtype).bits // 8
    nbytes = rows * n * size + x_rows * n * 4 + rows * n + rows * 4
    nbytes += rows * n * size if backward else 0
    return bound(nbytes, 7 * rows * n, PEAK_FLOPS[torch.float32])


# (M, K, B, N) of the likelihood's grid: an expert's [K, B, N] slice of the
# stacked [M·K, B, N] decode at the B = 192 step, the B = 16 drivers and
# the ZTF MMVAE driver (K = 8, B = 32); then a single expert, a row past one
# 1024-point chunk and odd rows (single points, not pairs)
LAPLACE_PATH = [(M, K_TRAIN, B_TRAIN, NS), (M, K_TRAIN, B_DRIVER, NS), (M, 8, 32, NS)]
LAPLACE_EDGES = [(1, 1, 32, NS), (1, 3, 5, 2000), (M, K_TRAIN, 7, 129), (M, K_TRAIN, 7, 981)]


def laplace_inputs(m, k, b, n, dtype, seed):
    """An expert's slice as MMVAE.forward hands it to grid_loglik: loc and
    the mask [K, B, N] of the transposed [B, M·K, N] decode (strides N and
    M·K·N), the [B, N] data, g [K, B]. Row (0, 0) is fully masked and x
    equals loc at its first points (sign(0) = 0)."""
    g = torch.Generator("cuda").manual_seed(seed)
    e = m - 1
    loc = torch.randn(b, m * k, n, device="cuda", generator=g).to(dtype).transpose(0, 1)
    mask = (torch.rand(b, m * k, n, device="cuda", generator=g) < 0.2).transpose(0, 1)
    loc, mask = loc[e * k:(e + 1) * k], mask[e * k:(e + 1) * k]
    mask[0, 0] = True
    x = torch.randn(b, n, device="cuda", generator=g)
    x[0, :5] = loc[0, 0, :5].float()
    return loc, x, mask, torch.randn(k, b, device="cuda", generator=g)


def unit_floors(pairs, sm_clock_mhz):
    """(exp2 floor ms, hash floor ms) of ``pairs`` (query, key, head) pairs:
    one exp2 each on the SFU, and the dropout hash's integer operations on
    the INT32 pipe, at the max SM clock. Floors of one unit each, printed
    beside the bound, which they do not change."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per_ms = n_sm * sm_clock_mhz * 1e3  # SM clocks per ms, summed over the SMs
    return pairs / (MUFU_PER_SM_CLK * per_ms), pairs * HASH_OPS / (INT32_PER_SM_CLK * per_ms)


def _sdpa_operands(q, k, v, mask):
    r, _, e = q.shape
    dh = e // HEADS
    q4, k4, v4 = (t.view(r, -1, HEADS, dh).transpose(1, 2).contiguous() for t in (q, k, v))
    if mask is None:
        return q4, k4, v4, None
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device).masked_fill(mask, -1e9)
    return q4, k4, v4, bias[:, None, None, :]


def sdpa_call(q, k, v, mask, dropout=0.0):
    """The library yardstick: one scaled_dot_product_attention call with
    the −1e9 float mask, on [R, H, L, Dh] copies made outside the timing."""
    q4, k4, v4, bias = _sdpa_operands(q, k, v, mask)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=bias, dropout_p=dropout)


def sdpa_train_call(q, k, v, mask, dropout):
    """The library yardstick for K1 + K2: scaled_dot_product_attention
    forward and backward with the float mask and dropout."""
    q4, k4, v4, bias = _sdpa_operands(q, k, v, mask)
    leaves = [t.requires_grad_() for t in (q4, k4, v4)]
    dout = randn_like(q4, 40)

    def run():
        out = torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=bias, dropout_p=dropout)
        torch.autograd.grad(out, leaves, dout)
    return run


def sdpa_bwd_call(q, k, v, mask, dropout):
    """The library yardstick for K2 alone: the backward of one
    scaled_dot_product_attention forward (float mask, dropout), run once
    outside the timing and kept for repeated backwards."""
    q4, k4, v4, bias = _sdpa_operands(q, k, v, mask)
    leaves = [t.requires_grad_() for t in (q4, k4, v4)]
    out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias,
                                                           dropout_p=dropout)
    dout = randn_like(out, 41)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def chunk_slices(rows, chunk):
    """Row slices of ``chunk`` rows: the plain attention versions
    materialise int64 hash tensors of R·H·Lq·Lk entries, ~24 GB each at
    R = 768 in one piece."""
    return [slice(i, min(i + chunk, rows)) for i in range(0, rows, chunk)]


def chunk_seed(seed, s):
    """The seed under which rows ``s`` alone draw the dropout mask that
    rows s.start.. draw within the whole tensor under ``seed``: the hash
    seeds row r, head h with seed + (r·H + h)·1024."""
    return seed + s.start * HEADS * 1024


# -- phases --------------------------------------------------------------------

def phase_environment():
    log(1, f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True,
                           text=True, timeout=60, check=True).stdout.split()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in SWITCHES:  # phases 1-15 run at the defaults; 16 sets each for its sub-phase
        if os.environ.pop(name, None) is not None:
            log(1, f"unset {name}")
    log(1, f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
           f"max SM clock {clock} MHz; allow_tf32 matmul="
           f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    return float(clock)


def phase_build():
    t0 = time.perf_counter()
    targets = _build.build_all()
    log(2, f"built {sorted(targets)} in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        function = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                function = line.split("for", 1)[1].strip()
            if "Used" in line or ("spill" in line and ", 0 bytes spill stores, 0 bytes "
                                                       "spill loads" not in line):
                log(2, f"{name}: {line.strip()}" + (f" ({function})" if "spill" in line else ""))


def _rel(got, want):
    """max |got − want| over max |want| (floor 1e-6 for an all-zero want)."""
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-6)).item()


def phase_kernel_vs_plain():
    """Every kernel against its plain version on the same card inputs.
    Tolerances: a forward in fp32 max-abs ≤ 1e-5 (sums in another order);
    a gradient in fp32 ≤ 1e-4 of max |plain| (sums over ~1000 keys or
    queries of products that cancel); anything in bf16 ≤ 2e-2 of max |plain|
    against the plain version on fp32 inputs (bf16 keeps 8 bits); the
    Laplace row sums rtol 1e-5 (~1000 terms), their gradient rtol 1e-6 (the
    same elementwise operations). Returns the worst fp32 max-abs error per
    kernel."""
    worst = dict.fromkeys(("attention_fwd", "attention_fwd_dropout", "attention_bwd",
                           "laplace_fwd", "laplace_bwd"), 0.0)
    cases = [("982x982 masked, row 0 fully masked", 64, NS, NS, True),
             ("982x5", 256, NS, LATENT_LEN + 1, False),
             ("60x60 masked", 256, LP, LP, True),
             ("60x4", 256, LP, LATENT_LEN, False),
             ("983x983 masked (the contrastive spectra context), row 0 fully masked",
              B_CONTRA, CONTEXT, CONTEXT, True)]
    for i, (label, rows, lq, lk, masked) in enumerate(cases):
        q, k, v, mask = attention_inputs(rows, lq, lk, masked, seed=100 + i, full_row=masked)
        for rate, seed, name in ((0.0, None, "attention_fwd"),
                                 (DROPOUT, 1000 + i, "attention_fwd_dropout")):
            ref = attention.attention_reference(q, k, v, mask, HEADS, rate, seed)
            out = attention.fused_attention(q, k, v, mask, HEADS, rate, seed)
            torch.cuda.synchronize()
            err32 = (out - ref).abs().max().item()
            out16 = attention.fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask,
                                              HEADS, rate, seed)
            torch.cuda.synchronize()
            assert out16.dtype == torch.bfloat16
            err16 = _rel(out16, ref)
            log(3, f"attention_fwd rate {rate} R={rows} {label}: fp32 max-abs {err32:.3e}, "
                   f"bf16 rel {err16:.3e}")
            assert np.isfinite(err32) and err32 <= 1e-5, (label, rate, err32)
            assert np.isfinite(err16) and err16 <= 2e-2, (label, rate, err16)
            worst[name] = max(worst[name], err32)
            if masked and rate == 0.0:  # the fully masked row averages v uniformly
                uniform = v[0].mean(0).expand(lq, -1)
                assert torch.allclose(out[0], uniform, atol=1e-5), label
    keep_rate_check()
    # K2 at the training path's grids: 982x982 at the drivers' R = M·K·16 =
    # 64 (the plain version materialises int64 hash tensors of R·H·982²
    # entries, ~2 GB each), 982x5, 60x60, and 983x983 at train_contrastive
    # model.selfattn=true's R = 32
    for i, (label, rows, lq, lk, masked) in enumerate(cases[:3] + cases[4:]):
        rows = M * K_TRAIN * B_DRIVER if lq == lk == NS else rows
        q, k, v, mask = attention_inputs(rows, lq, lk, masked, seed=200 + i, full_row=masked)
        dout = randn_like(q, 300 + i)
        for rate, seed in ((0.0, None), (DROPOUT, 2000 + i)):
            want = attention.attention_backward_reference(q, k, v, mask, dout, HEADS, rate,
                                                           seed)
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                qd, kd, vd = (t.to(dtype) for t in (q, k, v))
                out, m, l = attention.fused_attention_fwd(qd, kd, vd, mask, HEADS, rate, seed)
                grads = attention.fused_attention_bwd(qd, kd, vd, mask, out, m, l,
                                                      dout.to(dtype), HEADS, rate, seed)
                torch.cuda.synchronize()
                errs[dtype] = [_rel(g, w) for g, w in zip(grads, want)]
                if dtype == torch.float32:
                    worst["attention_bwd"] = max(worst["attention_bwd"], *(
                        (g - w).abs().max().item() for g, w in zip(grads, want)))
            log(3, f"attention_bwd rate {rate} R={rows} {label}: dq, dk, dv rel fp32 "
                   + ", ".join(f"{e:.2e}" for e in errs[torch.float32]) + "; bf16 "
                   + ", ".join(f"{e:.2e}" for e in errs[torch.bfloat16]))
            assert all(np.isfinite(e) and e <= 1e-4 for e in errs[torch.float32]), label
            assert all(np.isfinite(e) and e <= 2e-2 for e in errs[torch.bfloat16]), label
    # K3/K4 on experts' slices of a stacked decode, fp32 and bf16 loc, the
    # row sums rtol 1e-5 / atol 1e-3 (~N terms in another order) and K4
    # rtol 1e-6 in fp32, one bf16 ulp (2^-8 relative) in bf16, against the
    # plain versions on the same (widened) loc; then the flat form [R, N]
    # over [R/K, N] data at the step's shape
    for case in LAPLACE_PATH + LAPLACE_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            loc, x, mask, gout = laplace_inputs(*case, dtype, seed=300)
            ref = laplace.masked_laplace_loglik_reference(loc, x, mask, BIG_SPECTRA)
            dref = laplace.masked_laplace_grad_reference(loc, x, mask, BIG_SPECTRA, gout)
            out = laplace.masked_laplace_loglik_fwd(loc, x, mask, BIG_SPECTRA)
            dloc = laplace.masked_laplace_loglik_bwd(loc, x, mask, BIG_SPECTRA, gout)
            torch.cuda.synchronize()
            e3, e4 = (out - ref).abs().max().item(), (dloc.float() - dref).abs().max().item()
            m, k, b, n = case
            log(3, f"laplace [{k}, {b}, {n}] slice of [{m * k}, {b}, {n}] {str(dtype)[6:]}: fwd "
                   f"max-abs {e3:.3e} (rel {_rel(out, ref):.2e}), bwd max-abs {e4:.3e}")
            assert dloc.dtype == dtype and out.shape == (k, b)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)
            if dtype == torch.float32:
                torch.testing.assert_close(dloc, dref, rtol=1e-6, atol=0)
                worst["laplace_fwd"] = max(worst["laplace_fwd"], e3)
                worst["laplace_bwd"] = max(worst["laplace_bwd"], e4)
            else:
                torch.testing.assert_close(dloc.float(), dref, rtol=2 ** -8, atol=0)
            assert bool((dloc[0, 0, :5] == 0).all())
    loc, x, mask, gout = laplace_inputs(*LAPLACE_PATH[0], torch.float32, seed=301)
    flat = [t.transpose(0, 1).reshape(B_TRAIN * K_TRAIN, -1) for t in (loc, mask)]
    out = laplace.masked_laplace_loglik_fwd(flat[0], x, flat[1], BIG_SPECTRA)
    dloc = laplace.masked_laplace_loglik_bwd(flat[0], x, flat[1], BIG_SPECTRA,
                                             gout.T.reshape(-1))
    torch.testing.assert_close(out, laplace.masked_laplace_loglik_reference(
        flat[0], x, flat[1], BIG_SPECTRA), rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(dloc, laplace.masked_laplace_grad_reference(
        flat[0], x, flat[1], BIG_SPECTRA, gout.T.reshape(-1)), rtol=1e-6, atol=0)
    log(3, f"laplace flat [{B_TRAIN * K_TRAIN}, {NS}] over [{B_TRAIN}, {NS}] data: within "
           f"the same tolerances")
    return worst


def keep_rate_check(rows=8, length=NS, phase=3):
    """K1's measured keep rate on a length x length grid: with q = 0 every
    weight is 1/Lk, and with v = 1 each output is (#kept/Lk)/(1 − rate);
    over rows·H·L² draws (31M at phase 3's 982²) it must be
    1 − round(2ʷ·rate)/2ʷ at the draws' width w (230/256 at the default 8
    bits) within 4σ."""
    q = torch.zeros(rows, length, MODEL_DIM, device="cuda")
    out = attention.fused_attention(q, q, torch.ones_like(q), None, HEADS, DROPOUT, 99)
    keep = out.double().mean().item() * (1.0 - DROPOUT)
    p = 1.0 - attention.drop_threshold(DROPOUT) / 2 ** attention.dropout_bits()
    n = rows * HEADS * length * length
    sigma = (p * (1 - p) / n) ** 0.5
    log(phase, f"attention_fwd keep rate over {n} draws ({length}x{length}): {keep:.6f} "
               f"(expected {p:.6f}, {abs(keep - p) / sigma:.2f} sigma)")
    assert abs(keep - p) <= 4 * sigma, keep


def phase_serving(model, seed):
    """The serving path at full width; every call's launch count must equal
    the dispatch rule's prediction. Returns the total launches."""
    server = InferenceServer(model, buckets=BUCKETS, seed=seed)
    photo, spec = make_batch(128, seed)

    def sub(batch, n):
        return tuple(a[:n] for a in batch)

    def check(label, expected, fn):
        before = attention.launches
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = attention.launches - before
        log(4, f"{label}: {dt * 1e3:.1f} ms, kernel launches {got} (predicted {expected})")
        assert got == expected, (label, got, expected)
        return out

    attention.launches = 0
    for m, x in enumerate((photo, spec)):
        z = check(f"embed m={m} n=8", encoder_launches(m, 8),
                  lambda x=x, m=m: server.embed(sub(x, 8), modality=m))
        assert z.shape == (8, LATENT_LEN, LATENT_DIM) and torch.isfinite(z).all()
    # bucket 128 also routes the 982x5 cross-attention (R = 12,800 >= 3,417)
    for n, bucket in ((6, 8), (20, 32), (128, 128)):
        out = check(f"crossmodal 0->1 K={K_SERVE} n={n} (bucket {bucket})",
                    encoder_launches(0, bucket) + decoder_launches(1, K_SERVE * bucket),
                    lambda n=n: server.crossmodal(sub(photo, n), sub(spec, n), K=K_SERVE))
        assert out.shape == (K_SERVE, n, NS) and torch.isfinite(out).all()
    mean, lo, hi = check(f"crossmodal_ci 0->1 K={K_SERVE} alpha=0.1 n=32",
                         encoder_launches(0, 32) + decoder_launches(1, K_SERVE * 32),
                         lambda: server.crossmodal_ci(sub(photo, 32), sub(spec, 32),
                                                      K=K_SERVE, alpha=0.1))
    for t in (mean, lo, hi):
        assert t.shape == (32, NS) and torch.isfinite(t).all()
    assert bool((lo <= mean).all() and (mean <= hi).all()), "lo <= mean <= hi violated"
    out = check(f"crossmodal 1->0 K={K_SERVE} n=100 (bucket 128)",
                encoder_launches(1, 128) + decoder_launches(0, K_SERVE * 128),
                lambda: server.crossmodal(sub(spec, 100), sub(photo, 100),
                                          direction=(1, 0), K=K_SERVE))
    assert out.shape == (K_SERVE, 100, LP) and torch.isfinite(out).all()
    rec = check("reconstruct K=2 n=8",
                sum(encoder_launches(m, 8) for m in (0, 1))
                + sum(decoder_launches(d, 2 * 2 * 8) for d in (0, 1)),
                lambda: server.reconstruct((sub(photo, 8), sub(spec, 8)), K=2))
    for e in (0, 1):
        for d, grid in ((0, LP), (1, NS)):
            assert rec[e][d].shape == (2, 8, grid) and np.isfinite(rec[e][d]).all()
    total = attention.launches
    log(4, f"main path: attention_fwd launched {total} times; stats {server.stats()}")
    assert total > 0
    return total


def phase_card_vs_cpu(model, cpu_model, seed):
    """The whole decode on the card (kernel) and on the CPU (plain
    version), fp32: max-abs error over max |CPU| ≤ 1e-4."""
    photo, spec = make_batch(2, seed + 1)
    zs = np.random.default_rng(seed + 2).normal(size=(2, 2, LATENT_LEN, LATENT_DIM))
    zs = torch.from_numpy(zs.astype(np.float32))
    for d, x in ((1, spec), (0, photo)):
        xt = tuple(torch.from_numpy(a) for a in x)
        with torch.inference_mode():
            before = attention.launches
            card = model.vaes[d].decode(zs.cuda(), tuple(a.cuda() for a in xt)).mean
            torch.cuda.synchronize()
            launched = attention.launches - before
            cpu = cpu_model.vaes[d].decode(zs, xt).mean
        err = (card.cpu() - cpu).abs().max().item()
        rel = err / cpu.abs().max().item()
        log(5, f"decode modality {d}: card (kernel launches {launched}) vs CPU max-abs "
               f"{err:.3e}, relative {rel:.3e}")
        assert launched == decoder_launches(d, 4)
        assert np.isfinite(rel) and rel <= 1e-4, (d, rel)


def phase_times(model, seed, sm_clock_mhz):
    """Kernel, plain and library times; end-to-end crossmodal_ci latency."""
    rows_main = 800
    res = {}
    for rows in (rows_main, 3200):
        q, k, v, mask = attention_inputs(rows, NS, NS, True, seed=7)
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            ms = time_ms(lambda: attention.fused_attention(qd, kd, vd, mask, HEADS))
            lib = time_ms(sdpa_call(qd, kd, vd, mask))
            bound, by = attention_bound(rows, NS, NS, dtype, True)
            exp_ms = unit_floors(rows * HEADS * NS * NS, sm_clock_mhz)[0]
            name = str(dtype).split(".")[-1]
            log(6, f"attention_fwd R={rows} 982x982 {name}: {ms:.3f} ms; bound {bound:.3f} ms "
                   f"({by}); exp2 floor {exp_ms:.3f} ms; library sdpa {lib:.3f} ms")
            res[(rows, dtype)] = (ms, bound, by, lib)
            del qd, kd, vd
    q, k, v, mask = attention_inputs(rows_main, NS, NS, True, seed=7)
    plain = time_ms(lambda: attention.attention_reference(q, k, v, mask, HEADS), reps=10,
                    warmup=1)
    log(6, f"plain attention_reference R={rows_main} 982x982 float32: {plain:.3f} ms")
    del q, k, v, mask
    torch.cuda.empty_cache()

    photo, spec = make_batch(32, seed + 3)
    for precision in ("fp32", "bf16"):
        srv = InferenceServer(model, buckets=BUCKETS, seed=seed, precision=precision)
        call = lambda: srv.crossmodal_ci(photo, spec, K=K_SERVE, alpha=0.1)  # noqa: E731
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            mean, lo, hi = call()
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        assert torch.isfinite(mean.float()).all()
        med = statistics.median(lat)
        log(6, f"crossmodal_ci 0->1 K={K_SERVE} bucket 32 {precision}: median "
               f"{med * 1e3:.2f} ms, {32 / med:.1f} events/s, peak memory "
               f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        profile_calls(call, f"crossmodal_ci {precision}")
    return res, plain


# -- training ------------------------------------------------------------------

COUNTERS = ("K1 rate>0", "K1", "K2", "K3", "K4")


def kernel_counts():
    counts = counters.launch_counts()
    return tuple(counts[name] for name in COUNTERS)


def reset_counts():
    counters.set_launch_counts(dict.fromkeys(COUNTERS, 0))


def train_step_prediction(batch_size, dropout, remat=True):
    """Launches per train step, from the dispatch rules: each routed grid
    launches K1 in the forward and, with ``remat`` (VAESNE_REMAT unset or
    not 0), again in remat's re-run, and K2 once in the backward; decoders
    run on M·K·B rows (in train mode: dropout), encoders on B rows (always
    deterministic); each of the M experts' likelihoods on a grid of 128
    points or more launches K3 and K4 once."""
    dec = sum(decoder_launches(d, M * K_TRAIN * batch_size) for d in (0, 1))
    enc = sum(encoder_launches(m, batch_size) for m in (0, 1))
    lik = M * sum(laplace_routes_to_kernel(n) for n in (LP, NS))
    runs = 2 if remat else 1
    return (runs * dec if dropout > 0 else 0, runs * (dec + enc), dec + enc, lik, lik)


def m_iwae_loss(model, batch, seed):
    return objectives.m_iwae(model, batch, K_TRAIN, seed=seed)


def phase_training(seed):
    """The flagship train step at bench.py's configuration, TRAIN_STEPS in
    fp32 and TRAIN_STEPS under bf16 autocast, each from fresh weights;
    every step's launches must equal the prediction. Returns the launches
    of the whole run and the step times."""
    batch = to_device(make_batch(B_TRAIN, seed + 10), torch.device("cuda"))
    want = train_step_prediction(B_TRAIN, DROPOUT)
    log(7, f"predicted launches per step {dict(zip(COUNTERS, want))}")
    reset_counts()
    res = {}
    for precision in ("fp32", "bf16"):
        model = flagship(seed)
        opt = adamw(LR)
        state = TrainState.create(model, opt, seed=seed)
        step = make_train_step(model, opt, m_iwae_loss, precision=precision)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(TRAIN_STEPS):
            before = kernel_counts()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            losses.append(loss.item())  # syncs
            times.append(time.perf_counter() - t0)
            got = tuple(b - a for a, b in zip(before, kernel_counts()))
            assert got == want, (precision, i, got, want)
        assert np.isfinite(losses).all(), (precision, losses)
        med = statistics.median(times[1:])  # the first step warms caches and cuBLAS
        peak = torch.cuda.max_memory_allocated() / 2**20
        log(7, f"{precision}: losses {', '.join(f'{x:.2f}' for x in losses)}; step times "
               f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; median of steps 2-"
               f"{TRAIN_STEPS} {med * 1e3:.2f} ms = {1 / med:.3f} steps/s = "
               f"{B_TRAIN / med:.1f} samples/s; peak memory {peak:.0f} MiB")
        res[precision] = (med, peak, state, step, batch)
    totals = dict(zip(COUNTERS, kernel_counts()))
    log(7, f"main path (training, {2 * TRAIN_STEPS} steps): launches {totals}")
    assert all(v > 0 for v in totals.values())
    return totals, res


@contextlib.contextmanager
def pinned_noise(seed):
    """Laplace draws become loc + scale·noise, the noise a numpy function of
    (seed, the draw's shape), so the card and the CPU sample alike."""
    original = distributions.Laplace.sample

    def sample(self, generator=None, sample_shape=()):
        shape = distributions._as_shape(sample_shape) + tuple(self.batch_shape)
        noise = np.random.default_rng([seed, *shape]).laplace(size=shape).astype(np.float32)
        return self.loc + self.scale * torch.from_numpy(noise).to(self.loc.device)

    distributions.Laplace.sample = sample
    try:
        yield
    finally:
        distributions.Laplace.sample = original


def _rel_l2(got, want):
    """‖got − want‖ / ‖want‖ over lists of tensors."""
    err2 = sum(((g.cpu() - w) ** 2).sum().item() for g, w in zip(got, want))
    return (err2 / sum((w ** 2).sum().item() for w in want)) ** 0.5


def phase_train_card_vs_cpu(seed):
    """One train step (−m_iwae of the flagship model at dropout 0, B = 4,
    K = 2, pinned posterior noise) on the card (kernels) and on the CPU
    (plain versions), fp32, TF32 off:
      * the loss within 1e-4 relative;
      * the M·K·B importance log-weights lw within 1e-5 of max |lw|;
      * the gradients of mean(lw) within 1e-4 relative, L2 over all
        parameters;
      * the step's gradients within 1e-3 relative, L2 over all parameters.
    The step's tolerance is wider because the estimator weighs each
    sample's lw gradients by softmax(lw) over its M·K draws: at
    lw ≈ −1e4, fp32 holds lw to ~1e-3 absolute in any summation order, and
    a mixed weight (0.3 against 0.7) moves by about that much relatively,
    so two fp32 implementations of the step's gradient differ by 1e-4 to
    1e-3. The gradients of lw itself, free of that amplification, hold the
    1e-4 tolerance."""
    model = flagship(seed, dropout=0.0)
    results = []
    for device in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(device).train()
        params = list(m.parameters())
        batch = to_device(make_batch(4, seed + 20), torch.device(device))
        before = kernel_counts()
        with pinned_noise(seed):
            qz_xs, px_zs, zss = m(batch, K_TRAIN)
        lw = objectives.m_iwae_log_weights(qz_xs, px_zs, zss, batch, m.llik_scalings,
                                           m.pz(device))
        loss = -distributions.log_mean_exp(lw, axis=0).sum()  # = −m_iwae
        step_grads = torch.autograd.grad(loss, params, retain_graph=True)
        if device == "cuda":
            torch.cuda.synchronize()
            got = tuple(b - a for a, b in zip(before, kernel_counts()))
            log(8, f"card step launches {dict(zip(COUNTERS, got))}")
            assert got == train_step_prediction(4, 0.0), got
        lw_grads = torch.autograd.grad(-lw.mean(), params)
        results.append((loss.item(), lw.detach().cpu(), step_grads, lw_grads))
    (l_card, lw_card, g_card, h_card), (l_cpu, lw_cpu, g_cpu, h_cpu) = results
    rel_loss = abs(l_card - l_cpu) / abs(l_cpu)
    rel_lw = ((lw_card - lw_cpu).abs().max() / lw_cpu.abs().max()).item()
    weights = torch.softmax(lw_cpu, dim=0)
    rel_lw_grad, rel_grad = _rel_l2(h_card, h_cpu), _rel_l2(g_card, g_cpu)
    log(8, f"loss card {l_card:.6f} CPU {l_cpu:.6f} (relative {rel_loss:.3e}); log-weights "
           f"max-abs {(lw_card - lw_cpu).abs().max().item():.3e} (relative {rel_lw:.3e}) at "
           f"|lw| up to {lw_cpu.abs().max().item():.4g}, largest importance weight per "
           f"sample {', '.join(f'{w:.3f}' for w in weights.max(0).values.tolist())}; "
           f"gradients relative L2 error: of mean(lw) {rel_lw_grad:.3e}, of the step "
           f"{rel_grad:.3e}")
    assert rel_loss <= 1e-4 and rel_lw <= 1e-5, (rel_loss, rel_lw)
    assert rel_lw_grad <= 1e-4 and rel_grad <= 1e-3, (rel_lw_grad, rel_grad)


def phase_train_times(train, seed, sm_clock_mhz):
    """Each training kernel at the training shapes: K1 (with its saved
    statistics) and K2 at R = M·K·B = 768 rows of 982x982, 20% of keys
    masked and row 0 fully masked, rate 0.1; K3 and K4 at [K·B, 982] rows
    over [B, 982] data. Beside each: its bound, its plain version and, for
    K1, K2 and K1 + K2, scaled_dot_product_attention (timed here only).
    K1 and K2 are also held against their plain versions on these very
    inputs, with phase 3's tolerances. Beside the bounds: the exp2 floor
    and the hash's integer floor at rate 0.1 (one exp2 and one hash per
    pair in K1 and in K2). Then a torch.profiler breakdown of
    one train step in each precision."""
    rows, chunk, dseed = M * K_TRAIN * B_TRAIN, 64, 5
    q, k, v, mask = attention_inputs(rows, NS, NS, True, seed=8, full_row=True)
    dout = randn_like(q, 42)
    slices = chunk_slices(rows, chunk)

    def plain_fwd():
        return torch.cat([attention.attention_reference(
            q[s], k[s], v[s], mask[s], HEADS, DROPOUT, chunk_seed(dseed, s)) for s in slices])

    def plain_bwd():
        grads = [attention.attention_backward_reference(
            q[s], k[s], v[s], mask[s], dout[s], HEADS, DROPOUT, chunk_seed(dseed, s))
            for s in slices]
        return [torch.cat(g) for g in zip(*grads)]

    res = {"plain_f": time_ms(plain_fwd, reps=3, warmup=1),
           "plain_b": time_ms(plain_bwd, reps=3, warmup=1)}
    log(9, f"plain versions R={rows} 982x982 float32 in chunks of {chunk} rows: "
           f"attention_reference rate 0.1 {res['plain_f']:.3f} ms; "
           f"attention_backward_reference (its forward and autograd backward) "
           f"{res['plain_b']:.3f} ms")
    want_out, want_grads = plain_fwd(), plain_bwd()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        qd, kd, vd, dd = (t.to(dtype) for t in (q, k, v, dout))
        fwd0 = time_ms(lambda: attention.fused_attention_fwd(qd, kd, vd, mask, HEADS, 0.0))
        fwd = time_ms(lambda: attention.fused_attention_fwd(qd, kd, vd, mask, HEADS, DROPOUT,
                                                            dseed))
        out, m, l = attention.fused_attention_fwd(qd, kd, vd, mask, HEADS, DROPOUT, dseed)
        bwd = time_ms(lambda: attention.fused_attention_bwd(qd, kd, vd, mask, out, m, l, dd,
                                                            HEADS, DROPOUT, dseed))
        grads = attention.fused_attention_bwd(qd, kd, vd, mask, out, m, l, dd, HEADS, DROPOUT,
                                              dseed)
        torch.cuda.synchronize()
        rel = [_rel(out, want_out)] + [_rel(g, w) for g, w in zip(grads, want_grads)]
        err_f = (out.float() - want_out).abs().max().item()
        err_b = max((g.float() - w).abs().max().item() for g, w in zip(grads, want_grads))
        log(9, f"R={rows} 982x982 {name} rate 0.1 against the plain versions: K1 max-abs "
               f"{err_f:.3e} (rel {rel[0]:.2e}); K2 dq, dk, dv rel "
               + ", ".join(f"{e:.2e}" for e in rel[1:]) + f" (max-abs {err_b:.3e})")
        assert all(np.isfinite(e) for e in rel), (name, rel)
        if dtype == torch.float32:
            assert err_f <= 1e-5 and all(e <= 1e-4 for e in rel[1:]), (err_f, rel)
            res["err_f"], res["err_b"] = err_f, err_b
        else:
            assert all(e <= 2e-2 for e in rel), rel
        del out, m, l, grads
        lib_f0 = time_ms(sdpa_call(qd, kd, vd, mask))
        lib_f = time_ms(sdpa_call(qd, kd, vd, mask, DROPOUT))
        lib_b = time_ms(sdpa_bwd_call(qd, kd, vd, mask, DROPOUT))
        lib_fb = time_ms(sdpa_train_call(qd, kd, vd, mask, DROPOUT))
        b_f = attention_bound(rows, NS, NS, dtype, True, stats=True)
        b_b = attention_bwd_bound(rows, NS, NS, dtype)
        exp_f, hash_f = unit_floors(rows * HEADS * NS * NS, sm_clock_mhz)
        log(9, f"R={rows} 982x982 {name}: K1 rate 0 {fwd0:.3f} ms (library sdpa no dropout "
               f"{lib_f0:.3f} ms), rate 0.1 {fwd:.3f} ms (library sdpa dropout 0.1 "
               f"{lib_f:.3f} ms); bound {b_f[0]:.3f} ms ({b_f[1]}), exp2 floor {exp_f:.3f} ms, "
               f"hash floor at rate 0.1 {hash_f:.3f} ms; K2 {bwd:.3f} ms (bound {b_b[0]:.3f} "
               f"ms, {b_b[1]}; the same exp2 and hash floors; library sdpa backward "
               f"{lib_b:.3f} ms); K1 + K2 {fwd + bwd:.3f} ms, "
               f"library sdpa forward + backward {lib_fb:.3f} ms")
        res[dtype] = dict(fwd0=fwd0, fwd=fwd, bwd=bwd, lib_f0=lib_f0, lib_f=lib_f, lib_b=lib_b,
                          lib_fb=lib_fb, b_f=b_f, b_b=b_b)
        del qd, kd, vd, dd
        torch.cuda.empty_cache()
    del q, k, v, mask, dout, want_out, want_grads
    torch.cuda.empty_cache()

    # K3/K4 on experts' [K, B, 982] slices of a stacked decode, fp32 and
    # bf16 loc; beside each, one torch.sum over the same loc (a library call
    # that reads loc's bytes and does less work than K3) and the wrapper's
    # host time per call
    for case in LAPLACE_PATH:
        _, k, b, n = case
        for dtype in (torch.float32, torch.bfloat16):
            loc, x, lmask, gout = laplace_inputs(*case, dtype, seed=9)
            calls = {
                "k3": lambda: laplace.masked_laplace_loglik_fwd(loc, x, lmask, BIG_SPECTRA),
                "k4": lambda: laplace.masked_laplace_loglik_bwd(loc, x, lmask, BIG_SPECTRA,
                                                                gout),
                "p3": lambda: laplace.masked_laplace_loglik_reference(loc, x, lmask,
                                                                      BIG_SPECTRA),
                "p4": lambda: laplace.masked_laplace_grad_reference(loc, x, lmask, BIG_SPECTRA,
                                                                     gout),
                "sum": lambda: torch.sum(loc, dim=-1)}
            dev = {key: device_ms(fn) for key, fn in calls.items()}
            host = {key: time_ms(calls[key], inner=100) for key in ("k3", "k4")}
            b3 = laplace_bound(k * b, n, b, False, dtype)
            b4 = laplace_bound(k * b, n, b, True, dtype)
            res[("laplace", k * b, dtype)] = dict(dev, b3=b3, b4=b4, host3=host["k3"],
                                                  host4=host["k4"])
            us = {key: f"{t * 1e3:.3f} us" for key, t in dev.items()}
            log(9, f"laplace [{k}, {b}, {n}] slice {str(dtype)[6:]}, device time per call: K3 "
                   f"{us['k3']} (bound {b3[0] * 1e3:.3f} us, {b3[1]}, "
                   f"{b3[0] / dev['k3']:.1%} of it; plain {us['p3']}); K4 {us['k4']} (bound "
                   f"{b4[0] * 1e3:.3f} us, {b4[1]}, {b4[0] / dev['k4']:.1%}; plain {us['p4']}); "
                   f"torch.sum(loc, dim=-1) {us['sum']}; wrapper host time per call (100 "
                   f"back-to-back between CUDA events) K3 {host['k3'] * 1e3:.2f} us, K4 "
                   f"{host['k4'] * 1e3:.2f} us")
    res["grid_loglik"] = grid_loglik_call(train["fp32"][2].model, seed)
    for precision, (_, _, state, step, batch) in train.items():
        profile_calls(lambda: step(state, batch), f"train step {precision}", n=2, top=12,
                      phase=9)
    return res


def grid_loglik_call(model, seed):
    """Device time and kernels of one grid_loglik forward, and forward +
    backward, on expert 0's [K, B, 982] slice of the spectra decoder's
    stacked [M·K, B, 982] output (the flagship model, random latents, the
    drivers' B = 16), as MMVAE.forward slices it; the backward runs into
    the whole stack. In fp32 and on the bf16 decode of autocast."""
    batch = to_device(make_batch(B_DRIVER, seed + 30), torch.device("cuda"))
    g = torch.Generator("cuda").manual_seed(seed)
    z_all = torch.randn(M * K_TRAIN, B_DRIVER, LATENT_LEN, LATENT_DIM, device="cuda", generator=g)
    gout = torch.randn(K_TRAIN, B_DRIVER, device="cuda", generator=g)
    out = {}
    for precision in ("fp32", "bf16"):
        with torch.no_grad(), torch.autocast("cuda", torch.bfloat16, enabled=precision == "bf16"):
            px_all = model.vaes[1].decode(z_all, batch[1], seed)
        stack = px_all.loc.detach().requires_grad_()
        d = distributions.MaskedGridLaplace(stack[:K_TRAIN], px_all.mask[:K_TRAIN], px_all.big)
        assert not d.loc.is_contiguous() and not d.mask.is_contiguous()

        def fwd_bwd():
            stack.grad = None
            d.grid_loglik(batch[1][0]).backward(gout)

        f_ms, f_n, f_names = device_kernels(lambda: d.grid_loglik(batch[1][0]))
        fb_ms, fb_n, fb_names = device_kernels(fwd_bwd)
        log(9, f"grid_loglik on expert 0's slice {tuple(d.loc.shape)} {d.loc.dtype} of a "
               f"flagship decode (strides {d.loc.stride()}): forward {f_ms * 1e3:.3f} us "
               f"device, {f_n} kernel per call ({f_names}); forward + backward "
               f"{fb_ms * 1e3:.3f} us, {fb_n} kernels ({fb_names})")
        assert f_n == 1 and "laplace_fwd_kernel" in next(iter(f_names)), f_names
        out[precision] = (f_ms, f_n, fb_ms, fb_n)
    return out


# -- the training drivers --------------------------------------------------------

def driver_args(seed, root, *extra):
    return [f"train.seed={seed}", f"train.ckpt_dir={root}",
            f"train.log_dir={os.path.join(root, 'logs')}", *extra]


# a small synthetic dataset at the flagship's widths (102 events to train: 6
# steps at B = 16), for runs whose checks need a few steps, not an epoch's 25
SMALL_EVENTS = 128


def small_dataset(seed):
    """The path of SMALL_EVENTS synthetic Goldstein events from ``seed``,
    written under SMOKE_DIR."""
    os.makedirs(SMOKE_DIR, exist_ok=True)
    path = os.path.join(SMOKE_DIR, f"small_{seed}.npz")
    np.savez(path, **make_goldstein_like(n=SMALL_EVENTS, seed=seed, spectrum_bins=NS,
                                         photometry_length=LP))
    return path


def flagship_ckpt(root):
    cfg = PhotoSpectraMMVAEConfig()
    return os.path.join(root, f"goldstein_photospec_{cfg.model.latent_len}-"
                              f"{cfg.model.latent_dim}_K{cfg.train.K}_beta{cfg.train.beta}")


def _params_rel(a, b):
    """max |a − b| over the parameters, over max |a|."""
    diff = max((x - y).abs().max().item() for x, y in zip(a.parameters(), b.parameters()))
    return diff / max(x.abs().max().item() for x in a.parameters())


def phase_drivers(seed):
    """Phase 10: the training drivers as a user runs them, at the flagship
    widths, on the synthetic data of --seed. Returns the launches of (a)'s
    run and (c)'s serving, and the numbers of (e)."""
    cfg = PhotoSpectraMMVAEConfig()
    assert cfg.train.batch_size == B_DRIVER and cfg.train.K == K_TRAIN
    assert cfg.model.dropout == DROPOUT
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    dir_a, dir_b, dir_d = (os.path.join(SMOKE_DIR, s) for s in ("a", "b", "d"))
    per_step = train_step_prediction(B_DRIVER, DROPOUT)
    log(10, f"predicted launches per driver step (B = {B_DRIVER}) "
            f"{dict(zip(COUNTERS, per_step))}")

    # (a) train 3 epochs, saving every epoch; each epoch's launches checked
    epochs = []
    mark = {}

    def on_epoch(epoch, state, loss):
        now, counts = time.perf_counter(), kernel_counts()
        steps = state.step - mark["step"]
        got = tuple(c - p for c, p in zip(counts, mark["counts"]))
        want = tuple(steps * w for w in per_step)
        log(10, f"(a) epoch {epoch + 1}: loss {loss:.6f}, {steps} steps, "
                f"{now - mark['t']:.3f} s (with its checkpoint save), launches "
                f"{dict(zip(COUNTERS, got))}")
        assert np.isfinite(loss), (epoch, loss)
        assert got == want, (epoch, got, want)
        epochs.append((now - mark["t"], steps))
        mark.update(t=time.perf_counter(), counts=kernel_counts(), step=state.step)

    reset_counts()
    mark.update(t=time.perf_counter(), counts=kernel_counts(), step=0)
    captured = counters.captures
    state_a, losses_a = train_photospectra.main(
        driver_args(seed, dir_a, f"train.epochs={DRIVER_EPOCHS}", "train.save_every=1"),
        callback=on_epoch)
    launches_a = dict(zip(COUNTERS, kernel_counts()))
    log(10, f"(a) main path (drivers): launches {launches_a}; CUDA graphs of the step "
            f"captured {counters.captures - captured} (train.scan_epoch=true)")
    assert len(losses_a) == DRIVER_EPOCHS and all(v > 0 for v in launches_a.values())
    rates = [B_DRIVER * steps / t for t, steps in epochs]
    med_rate = statistics.median(rates[1:])
    log(10, f"(e) driver samples/s per epoch (host clock, the epoch ending in the loss's "
            f"float): {', '.join(f'{r:.1f}' for r in rates)}; median of epochs 2-"
            f"{DRIVER_EPOCHS} {med_rate:.1f} samples/s "
            f"({B_DRIVER / med_rate * 1e3:.2f} ms per step)")

    # (b) 2 epochs, then resumed to 3: the same run as (a)
    train_photospectra.main(driver_args(seed, dir_b, "train.epochs=2", "train.save_every=1"))
    state_b, losses_b = train_photospectra.main(driver_args(
        seed, dir_b, f"train.epochs={DRIVER_EPOCHS}", "train.resume=true", "train.save_every=1"))
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(losses_a, losses_b))
    param_rel = _params_rel(state_a.model, state_b.model)
    bitwise = all(torch.equal(x, y) for x, y in zip(state_a.model.parameters(),
                                                     state_b.model.parameters()))
    log(10, f"(b) kill-and-resume against (a): losses {losses_b} vs {losses_a}, max relative "
            f"difference {loss_rel:.3e}; parameters max-abs difference over max |param| "
            f"{param_rel:.3e} (bitwise equal: {bitwise}); step {state_b.step} vs {state_a.step}")
    assert state_b.step == state_a.step and len(losses_b) == DRIVER_EPOCHS
    assert loss_rel <= 1e-6 and param_rel <= 1e-6, (loss_rel, param_rel)

    # (c) serve (a)'s checkpoint: bitwise the server over (a)'s model
    data = resolve_dataset(None, "goldstein", seed=seed)
    idx = np.asarray(data["testing_idx"])[:N_HELD_OUT]
    photo, spec = (tuple(t.numpy() for t in m)
                   for m in multimodal_tuple(data, idx=idx, device="cpu"))
    want = encoder_launches(0, N_HELD_OUT) + decoder_launches(1, K_SERVE * N_HELD_OUT)
    outs = []
    reset_counts()
    for label, make in (("from_checkpoint", lambda: InferenceServer.from_checkpoint(
                             flagship_ckpt(dir_a), buckets=BUCKETS, seed=seed)),
                        ("in-memory model", lambda: InferenceServer(
                            state_a.model, buckets=BUCKETS, seed=seed))):
        server = make()
        before = attention.launches
        outs.append(server.crossmodal_ci(photo, spec, K=K_SERVE, alpha=0.1))
        torch.cuda.synchronize()
        got = attention.launches - before
        log(10, f"(c) {label}: crossmodal_ci 0->1 K={K_SERVE} on {N_HELD_OUT} held-out events, "
                f"K1 launches {got} (predicted {want})")
        assert got == want, (label, got, want)
    for t in outs[0]:
        assert t.shape == (N_HELD_OUT, NS) and torch.isfinite(t).all()
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    log(10, f"(c) from_checkpoint against the in-memory model: bitwise equal {same}")
    assert same
    serve_launches = attention.launches

    # (d) the other drivers, one epoch each (ZTF at repeat_factor 1, a cut
    # from the drivers' 10 to keep the smoke short)
    log(10, "(d) cut: the ZTF drivers run at repeat_factor=1 (their default is 10)")
    for name, driver, extra in (("train_spectra", train_spectra, ()),
                                ("train_photometry", train_photometry, ()),
                                ("train_ztf_photospect", train_ztf_photospect,
                                 ("repeat_factor=1",)),
                                ("train_ztf_spectra", train_ztf_spectra, ("repeat_factor=1",))):
        t0 = time.perf_counter()
        state, losses = driver.main(driver_args(seed, dir_d, "train.epochs=1", *extra))
        torch.cuda.synchronize()
        log(10, f"(d) {name}: 1 epoch, {state.step} steps, loss {losses[0]:.6f}, "
                f"{time.perf_counter() - t0:.2f} s with its set-up")
        assert len(losses) == 1 and np.isfinite(losses).all(), (name, losses)

    # (e) the device's busy share of one epoch of the driver itself: a copy
    # of (a)'s checkpoint resumed for two more epochs, the profiler running
    # from the end of the first to the end of the second (the same window
    # as (a)'s samples/s: augmentation, the steps, the checkpoint save)
    dir_e = os.path.join(SMOKE_DIR, "e")
    shutil.copytree(flagship_ckpt(dir_a), flagship_ckpt(dir_e))
    prof = epoch_profiler()
    window = {}

    def on_profiled_epoch(epoch, state, loss):
        torch.cuda.synchronize()
        if epoch == DRIVER_EPOCHS:
            prof.start()
            window.update(t=time.perf_counter(), step=state.step)
        else:
            window.update(wall_us=(time.perf_counter() - window["t"]) * 1e6,
                          steps=state.step - window["step"])
            prof.stop()

    train_photospectra.main(driver_args(seed, dir_e, f"train.epochs={DRIVER_EPOCHS + 2}",
                                        "train.resume=true", "train.save_every=1"),
                            callback=on_profiled_epoch)
    busy = report_profile(prof, window["wall_us"], 1,
                          f"epoch {DRIVER_EPOCHS + 2} of train_photospectra.main "
                          f"({window['steps']} steps, resumed from (a)'s checkpoint)",
                          top=10, phase=10)
    return launches_a, serve_launches, med_rate, busy


# -- evaluation ------------------------------------------------------------------

def suite_chunk_prediction(chunk):
    """K1 launches of one reconstruction-suite chunk: MMVAE.reconstruct
    encodes both modalities and runs each decoder on M·K·chunk rows, then
    the posterior means encode both modalities again."""
    return (2 * sum(encoder_launches(m, chunk) for m in (0, 1))
            + sum(decoder_launches(d, M * K_EVAL * chunk) for d in (0, 1)))


def sweep_chunk_prediction(chunk):
    """K1 launches of one masking-sweep chunk: one MMVAE.reconstruct."""
    return (sum(encoder_launches(m, chunk) for m in (0, 1))
            + sum(decoder_launches(d, M * K_EVAL * chunk) for d in (0, 1)))


@contextlib.contextmanager
def per_chunk_launches(record):
    """Append (chunk size, K1 launches) for every chunk the harness runs:
    batched_apply's chunk function wrapped to count around each call (the
    chunk's outputs reach the host inside it, so its kernels have run)."""
    real = harness.batched_apply

    def counting(fn, data, chunk_size, *args, **kwargs):
        def counted(*a):
            before = attention.launches
            out = fn(*a)
            record.append((chunk_size, attention.launches - before))
            return out
        return real(counted, data, chunk_size, *args, **kwargs)

    harness.batched_apply = counting
    try:
        yield
    finally:
        harness.batched_apply = real


@contextlib.contextmanager
def capture_attention(rows, lq, lk, store):
    """Keep the inputs (q, k, v, mask) of the first routed attention call of
    ``rows`` rows on an lq x lk grid, as the layers hand them to the kernel."""
    real = layers.fused_attention

    def capturing(q, k, v, mask, *args):
        if not store and q.shape[:2] == (rows, lq) and k.shape[1] == lk:
            store.extend((q, k, v, mask))
        return real(q, k, v, mask, *args)

    layers.fused_attention = capturing
    try:
        yield
    finally:
        layers.fused_attention = real


def eval_gates(label, got, ref_path, failures, phase=11):
    """Per phase bucket: MSE within 5% relative, the bin-averaged coverage
    within 0.02 absolute, the bin-averaged width within 5% relative, of the
    JAX package's results for the same checkpoint and data."""
    ref = np.load(ref_path)
    rows = [("mse", got["mm_mse"], ref["mm_mse"], "rel", 0.05),
            ("coverage", np.nanmean(got["mm_coverage_mean"], 1),
             np.nanmean(ref["mm_coverage_mean"], 1), "abs", 0.02),
            ("width", np.nanmean(got["mm_width_mean"], 1), np.nanmean(ref["mm_width_mean"], 1),
             "rel", 0.05)]
    for name, port, jax_value, kind, tol in rows:
        diff = np.abs(port - jax_value) / (np.abs(jax_value) if kind == "rel" else 1.0)
        log(phase, f"{label} {name} per phase (-10, 0, 10, 20, 30 d): port "
                f"{np.array2string(port, precision=6)}, JAX "
                f"{np.array2string(jax_value, precision=6)}, "
                f"{'relative' if kind == 'rel' else 'absolute'} difference "
                f"{np.array2string(diff, precision=4)} (gate {tol})")
        if not (np.isfinite(diff).all() and (diff <= tol).all()):
            failures.append((label, name, diff.tolist()))


def phase_evaluation(seed):
    """Phase 11: the evaluation drivers on the bridged flagship checkpoint.
    Returns the K1 launches of (a)-(c) and K1's time on (e)'s input."""
    t_phase = time.perf_counter()
    out = os.path.join(SMOKE_DIR, "eval")
    shutil.rmtree(out, ignore_errors=True)
    record, store, failures = [], [], []
    rows = M * K_EVAL * SUITE_CHUNK
    reset_counts()
    with per_chunk_launches(record), capture_attention(rows, NS, NS, store):
        t0 = time.perf_counter()
        metrics = eval_goldstein.main([f"mm_ckpt={EVAL_CKPT}", f"K={K_EVAL}",
                                       f"out={os.path.join(out, 'latent')}"])
        t_first = time.perf_counter() - t0
        predictive = eval_goldstein.main([f"mm_ckpt={EVAL_CKPT}", f"K={K_EVAL}", "predictive=1",
                                          f"out={os.path.join(out, 'predictive')}"])
        mses = eval_masking.main([f"mm_ckpt={EVAL_CKPT}", f"K={K_EVAL}",
                                  f"out={os.path.join(out, 'masking')}"])
    totals = dict(zip(COUNTERS, kernel_counts()))
    log(11, f"main path (evaluation: eval_goldstein twice, eval_masking): launches {totals}; "
            f"the first eval_goldstein call took {t_first:.2f} s")
    assert totals["K1"] > 0 and all(v == 0 for k, v in totals.items() if k != "K1"), totals

    # (a), (b), (c): against the JAX package's results for this checkpoint
    eval_gates("(a) eval_goldstein K=100", metrics, EVAL_REF["latent"], failures)
    eval_gates("(b) eval_goldstein K=100 predictive=1", predictive, EVAL_REF["predictive"],
               failures)
    ref = np.load(SWEEP_REF)
    port = np.array([mses[float(p)] for p in ref["portions"]])
    diff = np.abs(port - ref["mse"]) / ref["mse"]
    log(11, f"(c) eval_masking K=100 MSE at {np.array2string(ref['portions'])} masked: port "
            f"{np.array2string(port, precision=6)}, JAX {np.array2string(ref['mse'], precision=6)}"
            f", relative difference {np.array2string(diff, precision=4)} (gate 0.05)")
    if not (diff <= 0.05).all():
        failures.append(("(c) masking", "mse", diff.tolist()))

    # (d) launches per chunk against the dispatch rule
    suite = [n for size, n in record if size == SUITE_CHUNK]
    sweep = [n for size, n in record if size == SWEEP_CHUNK]
    want_suite = suite_chunk_prediction(SUITE_CHUNK)
    want_sweep = sweep_chunk_prediction(SWEEP_CHUNK)
    log(11, f"(d) K1 launches per suite chunk (R = {rows}) {sorted(set(suite))} over {len(suite)} "
            f"chunks (predicted {want_suite}); per sweep chunk (R = {M * K_EVAL * SWEEP_CHUNK}) "
            f"{sorted(set(sweep))} over {len(sweep)} chunks (predicted {want_sweep})")
    data = resolve_dataset(None)
    n_test = len(data["testing_idx"])
    assert len(suite) == 2 * -(-n_test // SUITE_CHUNK), len(suite)
    assert len(sweep) == 6 * -(-n_test // SWEEP_CHUNK), len(sweep)
    assert set(suite) == {want_suite} and set(sweep) == {want_sweep}, (suite, sweep)
    assert totals["K1"] == sum(suite) + sum(sweep)

    # (e) K1 on the captured R = 12,800 decoder input against its plain
    # version on its first and last rows (all rows' logits would be ~197 GB)
    q, k, v, mask = store
    del store[:]
    with torch.inference_mode():
        kernel = attention.fused_attention(q, k, v, mask, HEADS)
        torch.cuda.synchronize()
        errs = []
        for part in (slice(0, 64), slice(rows - 64, rows)):
            plain = attention.attention_reference(q[part], k[part], v[part], mask[part], HEADS)
            errs.append((kernel[part] - plain).abs().max().item())
        ms = time_ms(lambda: attention.fused_attention(q, k, v, mask, HEADS), reps=5, warmup=1)
    bound_ms, by = attention_bound(rows, NS, NS, torch.float32, True)
    log(11, f"(e) K1 on the suite's first 982x982 decoder input [{rows}, {NS}, {MODEL_DIM}] "
            f"fp32 ({mask.float().mean().item():.1%} of keys masked): rows 0-63 max-abs "
            f"{errs[0]:.3e}, rows {rows - 64}-{rows - 1} {errs[1]:.3e} against the plain version "
            f"(gate 1e-5); {ms:.3f} ms a launch, bound {bound_ms:.3f} ms ({by}), "
            f"{bound_ms / ms:.1%} of it")
    assert all(np.isfinite(e) and e <= 1e-5 for e in errs), errs
    del q, k, v, mask, kernel
    torch.cuda.empty_cache()

    # (f) the harness on the card against the CPU, bridged weights, pinned noise
    idx = np.asarray(data["testing_idx"])[:8]
    batch = tuple(tuple(t.numpy() for t in m) for m in multimodal_tuple(data, idx, "cpu"))
    model = eval_goldstein._restore(EVAL_CKPT, train_photospectra.build_model(
        eval_goldstein._config_for(EVAL_CKPT, PhotoSpectraMMVAEConfig)))
    with pinned_noise(seed):
        card = harness.mmvae_reconstruction_suite(model, batch, K=4, chunk_size=8, device="cuda")
        cpu = harness.mmvae_reconstruction_suite(copy.deepcopy(model).cpu(), batch, K=4,
                                                 chunk_size=8, device="cpu")
    rel = {key: np.abs(card[key] - cpu[key]).max() / np.abs(cpu[key]).max() for key in cpu}
    log(11, "(f) harness card vs CPU, 8 events, K = 4, pinned noise, max-abs over max |CPU|: "
            + ", ".join(f"{key} {r:.3e}" for key, r in rel.items()) + " (gate 1e-4)")
    assert card.keys() == cpu.keys() and all(r <= 1e-4 for r in rel.values()), rel

    # (g) eval_goldstein end to end after the warm call (a), peak memory, a
    # profile of one suite chunk
    spent = []
    suite_fn = eval_goldstein.mmvae_reconstruction_suite

    def timed_suite(*args, **kwargs):
        t = time.perf_counter()
        result = suite_fn(*args, **kwargs)
        spent.append(time.perf_counter() - t)
        return result

    eval_goldstein.mmvae_reconstruction_suite = timed_suite
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        eval_goldstein.main([f"mm_ckpt={EVAL_CKPT}", f"K={K_EVAL}",
                             f"out={os.path.join(out, 'timed')}"])
        wall = time.perf_counter() - t0
    finally:
        eval_goldstein.mmvae_reconstruction_suite = suite_fn
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(11, f"(g) eval_goldstein K={K_EVAL} on {n_test} test events: wall {wall:.3f} s, "
            f"{n_test / wall:.1f} events/s, the harness {spent[0]:.3f} s ({spent[0] / wall:.1%} "
            f"of the wall); peak device memory {peak:.0f} MiB")
    first = tuple(tuple(a[:SUITE_CHUNK] for a in m) for m in multimodal_tuple(
        data, np.asarray(data["testing_idx"]), "cpu"))
    busy = profile_calls(lambda: harness.mmvae_reconstruction_suite(
        model, first, K=K_EVAL, chunk_size=SUITE_CHUNK), f"one suite chunk ({SUITE_CHUNK} events, "
        f"K = {K_EVAL}, R = {rows})", n=1, top=10, phase=11)
    log(11, f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    assert not failures, failures
    return totals["K1"], dict(ms=ms, bound=bound_ms, by=by, wall=wall, events_s=n_test / wall,
                              peak=peak, busy=busy)


# -- the image VAE -----------------------------------------------------------------

# (label, rows, grid length) of phase 12(a): the hybrid decoder's 900
# patch tokens, the per-pixel decoder's 3,600 and the MNIST config's 400,
# each at the train step's R = 32
IMAGE_GRIDS = [("hybrid", B_IMAGE, IMAGE_TOKENS), ("pixel", B_IMAGE, PIXEL_TOKENS),
               ("mnist", B_IMAGE, MNIST_TOKENS)]
REF_ROWS = 8  # rows per call of the plain versions in phase 12 (3,600² logits: 1.7 GB)


def by_rows(plain, tensors, seed, rows=REF_ROWS):
    """``plain(*chunk, seed)`` (a plain version over [R, ...] inputs) on
    ``rows`` rows at a time, the outputs concatenated along R. Row r's
    dropout mask is keyed by seed + (r·H + h)·1024 (ops/attention.py::
    dropout_keep), so the chunk from row r0 takes seed + r0·H·1024 and the
    result equals one call over all rows."""
    parts = []
    for r0 in range(0, tensors[0].shape[0], rows):
        s = None if seed is None else seed + r0 * HEADS * 1024
        out = plain(*(t[r0:r0 + rows] for t in tensors), s)
        parts.append(out if isinstance(out, (tuple, list)) else (out,))
    outs = [torch.cat(p) for p in zip(*parts)]
    return outs if len(outs) > 1 else outs[0]


def image_stack_launches(rows, lq, lk_context):
    """K1 launches of one image TransformerStack: per layer a self-attention
    (lq x lq, unmasked) and a cross-attention (lq x lk_context)."""
    return LAYERS * (int(routes_to_kernel(rows, HEADS, lq, lq))
                     + int(routes_to_kernel(rows, HEADS, lq, lk_context)))


def image_tokens(cfg):
    """(decoder queries, encoder context tokens) of an ImageVAEConfig."""
    patches = (cfg.img_size // cfg.patch_size) ** 2
    return (patches if cfg.hybrid else cfg.img_size ** 2), patches + 2 * cfg.focal_loc


def image_forward_launches(cfg, rows, K):
    """K1 launches of one HostImgVAE forward on ``rows`` images: the encoder's
    2·latent_len bottleneck queries over the patch tokens on B rows, the
    decoder's queries over the latent tokens on K·B rows."""
    dec, ctx = image_tokens(cfg)
    return (image_stack_launches(rows, 2 * LATENT_LEN, ctx)
            + image_stack_launches(K * rows, dec, LATENT_LEN))


def image_step_prediction(cfg):
    """Launches per train_image step (COUNTERS order): the whole forward in
    train mode (dropout 0.1), so every routed grid launches K1 at rate 0.1
    in the forward and again in remat's re-run, and K2 once; a plain
    Laplace likelihood, so no K3 or K4."""
    n = image_forward_launches(cfg, cfg.train.batch_size, cfg.train.K)
    return (2 * n, 2 * n, n, 0, 0)


def phase_image_kernels():
    """Phase 12(a): K1 at rate 0 and 0.1 and K2 at rate 0.1 on the image
    grids at R = 32, unmasked, against their plain versions (by_rows) with
    phase 3's gates; K1's keep rate at 900x900. Returns the worst fp32
    errors."""
    worst = dict.fromkeys(("attention_fwd", "attention_fwd_dropout", "attention_bwd"), 0.0)
    for i, (label, rows, n) in enumerate(IMAGE_GRIDS):
        q, k, v, _ = attention_inputs(rows, n, n, False, seed=500 + i)
        dout = randn_like(q, 600 + i)
        for rate, seed, name in ((0.0, None, "attention_fwd"),
                                 (DROPOUT, 5000 + i, "attention_fwd_dropout")):
            ref = by_rows(lambda q_, k_, v_, s: attention.attention_reference(
                q_, k_, v_, None, HEADS, rate, s), (q, k, v), seed)
            out = attention.fused_attention(q, k, v, None, HEADS, rate, seed)
            out16 = attention.fused_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), None,
                                              HEADS, rate, seed)
            torch.cuda.synchronize()
            err32, err16 = (out - ref).abs().max().item(), _rel(out16, ref)
            log(12, f"(a) attention_fwd rate {rate} R={rows} {n}x{n} ({label}): fp32 max-abs "
                    f"{err32:.3e}, bf16 rel {err16:.3e}")
            assert np.isfinite(err32) and err32 <= 1e-5, (label, rate, err32)
            assert np.isfinite(err16) and err16 <= 2e-2, (label, rate, err16)
            worst[name] = max(worst[name], err32)
            del ref, out, out16
        want = by_rows(lambda q_, k_, v_, d_, s: attention.attention_backward_reference(
            q_, k_, v_, None, d_, HEADS, DROPOUT, s), (q, k, v, dout), 7000 + i)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            out, m, l = attention.fused_attention_fwd(qd, kd, vd, None, HEADS, DROPOUT, 7000 + i)
            grads = attention.fused_attention_bwd(qd, kd, vd, None, out, m, l, dout.to(dtype),
                                                  HEADS, DROPOUT, 7000 + i)
            torch.cuda.synchronize()
            errs[dtype] = [_rel(g, w) for g, w in zip(grads, want)]
            if dtype == torch.float32:
                worst["attention_bwd"] = max(worst["attention_bwd"], *(
                    (g - w).abs().max().item() for g, w in zip(grads, want)))
        log(12, f"(a) attention_bwd rate {DROPOUT} R={rows} {n}x{n} ({label}): dq, dk, dv rel "
                f"fp32 " + ", ".join(f"{e:.2e}" for e in errs[torch.float32]) + "; bf16 "
                + ", ".join(f"{e:.2e}" for e in errs[torch.bfloat16]))
        assert all(np.isfinite(e) and e <= 1e-4 for e in errs[torch.float32]), label
        assert all(np.isfinite(e) and e <= 2e-2 for e in errs[torch.bfloat16]), label
        del q, k, v, dout, want
        torch.cuda.empty_cache()
    keep_rate_check(rows=B_IMAGE, length=IMAGE_TOKENS, phase=12)
    return worst


def image_batch(n, seed=0, device="cuda"):
    """``n`` synthetic 60x60x3 images as the model's input on ``device``."""
    return image_tuple(make_images(n=n, img_size=IMG, seed=seed), device)


def phase_image_checkpoint():
    """Phase 12(b): the bridged synthetic_image_4-4_patch2 checkpoint's
    posterior-mean reconstruction decode(encode(x)).loc of the 8 reference
    images on the card (through K1) against the JAX package's
    (artifacts/ckpt_torch/.../jax_reconstruction.npy) and against the port
    on the CPU (the plain version): max-abs over max |reference| ≤ 1e-4."""
    cfg = eval_goldstein._config_for(IMAGE_CKPT, ImageVAEConfig)
    model = eval_goldstein._restore(IMAGE_CKPT, train_image.build_model(cfg)).eval()
    ref = np.load(IMAGE_REF)
    locs = {}
    for device in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(device)
        x = image_batch(ref.shape[0], device=device)
        before = attention.launches
        with torch.inference_mode():
            locs[device] = m.decode(m.encode(x)[None], x).loc[0].cpu().numpy()
        if device == "cuda":
            launched = attention.launches - before
            want = image_forward_launches(cfg, ref.shape[0], 1)
            assert launched == want, (launched, want)
    scale = np.abs(ref).max()
    rel_jax = np.abs(locs["cuda"] - ref).max() / scale
    rel_cpu = np.abs(locs["cuda"] - locs["cpu"]).max() / np.abs(locs["cpu"]).max()
    rel_cpu_jax = np.abs(locs["cpu"] - ref).max() / scale
    log(12, f"(b) {IMAGE_CKPT} reconstruction of {ref.shape[0]} images {ref.shape[1:]}, "
            f"K1 launches {launched}: card vs JAX max-abs/max {rel_jax:.3e}, card vs CPU "
            f"{rel_cpu:.3e}, CPU vs JAX {rel_cpu_jax:.3e} (gate 1e-4)")
    assert rel_jax <= 1e-4 and rel_cpu <= 1e-4, (rel_jax, rel_cpu)


def image_driver_args(seed, root, *extra):
    return driver_args(seed, root, "train.save_every=1", *extra)


def phase_image_training(seed):
    """Phase 12(c): train_image.main at the defaults (synthetic 512 images,
    B = 32: 16 steps an epoch) for IMAGE_EPOCHS epochs, each epoch's
    launches against image_step_prediction; samples/s per epoch (host
    clock from one epoch's end to the next, the save included); peak
    memory; then one epoch of the per-pixel decoder and one of the MNIST
    config; a run of one epoch resumed to IMAGE_EPOCHS, bitwise the first;
    a profile of one step. Returns the launches of each run and the
    numbers."""
    root = os.path.join(SMOKE_DIR, "image")
    shutil.rmtree(root, ignore_errors=True)
    res = {}
    for label, overrides, epochs in (("image", (), IMAGE_EPOCHS),
                                     ("pixel", ("hybrid=false",), 1),
                                     ("mnist", ("dataset=mnist",), 1)):
        dataset, _, cfg = train_image.parse_image_cli(list(overrides))
        per_step = image_step_prediction(cfg)
        mark, epoch_s = {}, []

        def on_epoch(epoch, state, loss):
            now, counts = time.perf_counter(), kernel_counts()
            steps = state.step - mark["step"]
            got = tuple(c - p for c, p in zip(counts, mark["counts"]))
            log(12, f"(c) {label} epoch {epoch + 1}: loss {loss:.6f}, {steps} steps, "
                    f"{now - mark['t']:.3f} s, launches {dict(zip(COUNTERS, got))}")
            assert np.isfinite(loss) and got == tuple(steps * w for w in per_step), (got, steps)
            epoch_s.append((now - mark["t"], steps))
            mark.update(t=time.perf_counter(), counts=kernel_counts(), step=state.step)

        log(12, f"(c) {label}: predicted launches per step {dict(zip(COUNTERS, per_step))}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        mark.update(t=time.perf_counter(), counts=kernel_counts(), step=0)
        state, losses = train_image.main(
            [*overrides, *image_driver_args(seed, os.path.join(root, label),
                                            f"train.epochs={epochs}")], callback=on_epoch)
        launches = dict(zip(COUNTERS, kernel_counts()))
        rates = [cfg.train.batch_size * n / t for t, n in epoch_s]
        peak = torch.cuda.max_memory_allocated() / 2**20
        log(12, f"(c) {label} ({dataset}, {cfg.img_size}x{cfg.img_size}x{cfg.in_channels}, "
                f"patch {cfg.patch_size}, hybrid {cfg.hybrid}): losses {losses}, launches "
                f"{launches}; samples/s per epoch {', '.join(f'{r:.1f}' for r in rates)}; "
                f"peak memory {peak:.0f} MiB")
        assert all(launches[k] > 0 for k in ("K1 rate>0", "K1", "K2")), launches
        if label == "image":
            assert losses[-1] < losses[0], losses
            res["state"], res["cfg"] = state, cfg
        res[label] = dict(launches=launches, rates=rates, peak=peak, losses=losses)

    # kill and resume: one epoch, then resumed to IMAGE_EPOCHS in another
    # directory, bitwise the default run (no atomics on the path: the
    # convolutions run cuDNN's deterministic algorithms, K2 sums in a fixed
    # order)
    state, cfg = res.pop("state"), res.pop("cfg")
    resumed_dir = os.path.join(root, "resumed")
    train_image.main(image_driver_args(seed, resumed_dir, "train.epochs=1"))
    resumed, resumed_losses = train_image.main(image_driver_args(
        seed, resumed_dir, f"train.epochs={IMAGE_EPOCHS}", "train.resume=true"))
    bitwise = all(torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                                     resumed.model.parameters()))
    log(12, f"(c) 1 epoch, then resumed to {IMAGE_EPOCHS}: losses {resumed_losses} vs "
            f"{res['image']['losses']}, parameters bitwise equal: {bitwise}; "
            f"max-abs difference over max |param| {_params_rel(state.model, resumed.model):.3e}")
    assert bitwise and resumed_losses == res["image"]["losses"], resumed_losses

    # one step of the default run's model under the profiler
    step = make_train_step(state.model, optimizer_from_config(cfg.train),
                           lambda m, b, s: objectives.elbo(m, b, cfg.train.K, seed=s))
    batch = image_batch(B_IMAGE, seed=seed + 40)
    res["busy"] = profile_calls(lambda: step(state, batch), f"train_image step (B = {B_IMAGE})",
                                n=2, top=10, phase=12)
    return res


def phase_try_image():
    """Phase 12(d): try_models model=image on the bridged checkpoint at
    K = 100 and n = 4 (the decoder on R = 400 rows, K1 at rate 0): its K1
    launches against the prediction, finite reconstructions of the right
    shape in its .npy, the figure where matplotlib is installed; K1 on the
    captured input of the decoder's first 900x900 self-attention against
    its plain version on all 400 rows (phase 3's gate); then the latency of
    the reconstruction itself (median of 10, host clock ending in a
    sync)."""
    out = os.path.join(SMOKE_DIR, "try_image")
    shutil.rmtree(out, ignore_errors=True)
    cfg = eval_goldstein._config_for(IMAGE_CKPT, ImageVAEConfig)
    want = image_forward_launches(cfg, N_TRY, K_TRY)
    rows, store = K_TRY * N_TRY, []
    reset_counts()
    t0 = time.perf_counter()
    with capture_attention(rows, IMAGE_TOKENS, IMAGE_TOKENS, store):
        recon = try_models.main(["model=image", f"mm_ckpt={IMAGE_CKPT}", f"K={K_TRY}",
                                 f"n={N_TRY}", f"out={out}"])
    wall = time.perf_counter() - t0
    launches = dict(zip(COUNTERS, kernel_counts()))
    try:
        import matplotlib  # noqa: F401
        drawn = os.path.exists(os.path.join(out, "image_reconstructions.png"))
        assert drawn, "matplotlib is installed but no figure was written"
    except ImportError:
        drawn = False
    saved = np.load(os.path.join(out, "image_reconstructions.npy"))
    log(12, f"(d) try_models model=image K={K_TRY} n={N_TRY}: {wall:.3f} s with its set-up, "
            f"launches {launches} (K1 predicted {want}), reconstructions {recon.shape} saved "
            f"as .npy, figure written: {drawn}")
    assert launches["K1"] == want and launches["K1 rate>0"] == 0, (launches, want)
    assert recon.shape == (K_TRY, N_TRY, 3, IMG, IMG) and np.isfinite(recon).all()
    assert np.array_equal(saved, recon)

    q, k, v, mask = store
    del store[:]
    assert mask is None
    with torch.inference_mode():
        kernel = attention.fused_attention(q, k, v, None, HEADS)
        plain = by_rows(lambda q_, k_, v_, _: attention.attention_reference(
            q_, k_, v_, None, HEADS), (q, k, v), None)
        torch.cuda.synchronize()
        err = (kernel - plain).abs().max().item()
    log(12, f"(d) K1 on try_image's captured decoder self-attention input [{rows}, "
            f"{IMAGE_TOKENS}, {MODEL_DIM}] fp32, unmasked: max-abs {err:.3e} against the plain "
            f"version on all rows (gate 1e-5; max |plain| {plain.abs().max().item():.3e})")
    assert np.isfinite(err) and err <= 1e-5, err
    del q, k, v, kernel, plain
    torch.cuda.empty_cache()

    model = eval_goldstein._restore(IMAGE_CKPT, train_image.build_model(cfg)).cuda().eval()
    x = image_batch(N_TRY)
    g = torch.Generator("cuda").manual_seed(0)
    lat = []
    with torch.inference_mode():
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.reconstruct(x, K_TRY, generator=g)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
    med = statistics.median(lat[2:])
    log(12, f"(d) HostImgVAE.reconstruct K={K_TRY} of {N_TRY} images (R = {K_TRY * N_TRY}): "
            f"median {med * 1e3:.2f} ms over 10 calls after 2 warm ones")
    return launches["K1"], med


def phase_image_times():
    """Phase 12(e): each kernel at the image path's shapes, fp32, unmasked,
    beside its bound, as device time per call under torch.profiler (a
    launch here takes ~0.1 ms, about the wrapper's host time, so CUDA
    events around one call would time the host): K1 rate 0 and rate 0.1
    (with its statistics) and K2 at rate 0.1 on 900x900, 3,600x3,600 and
    400x400 at R = 32, K1 rate 0 on 900x900 at try_image's R = 400; at
    900x900, R = 32 also the plain versions and scaled_dot_product_attention
    without a mask (timed here only), many kernels a call each, with CUDA
    events as phases 6 and 9 time them."""
    res = {}
    shapes = [("image", B_IMAGE, IMAGE_TOKENS), ("pixel", B_IMAGE, PIXEL_TOKENS),
              ("mnist", B_IMAGE, MNIST_TOKENS), ("image_r400", K_TRY * N_TRY, IMAGE_TOKENS)]
    for label, rows, n in shapes:
        q, k, v, _ = attention_inputs(rows, n, n, False, seed=800)
        calls = {"fwd0": lambda: attention.fused_attention(q, k, v, None, HEADS)}
        r = res[label] = {"b_f0": attention_bound(rows, n, n, torch.float32, False)}
        if label != "image_r400":
            dout, word = randn_like(q, 801), seed_word(3)
            out, m, l = attention.fused_attention_fwd(q, k, v, None, HEADS, DROPOUT, 3)
            calls["fwd"] = lambda: attention.fused_attention_fwd(q, k, v, None, HEADS, DROPOUT,
                                                                 word)
            calls["bwd"] = lambda: attention.fused_attention_bwd(q, k, v, None, out, m, l, dout,
                                                                 HEADS, DROPOUT, word)
            r["b_f"] = attention_bound(rows, n, n, torch.float32, False, stats=True)
            r["b_b"] = attention_bwd_bound(rows, n, n, torch.float32)
        for key, fn in calls.items():
            r[key], kernels, _ = device_kernels(fn)
            assert kernels == 1, (label, key, kernels)
        if label == "image":
            slow = {"plain_f0": lambda: attention.attention_reference(q, k, v, None, HEADS),
                    "plain_f": lambda: attention.attention_reference(q, k, v, None, HEADS,
                                                                     DROPOUT, 3),
                    "plain_b": lambda: attention.attention_backward_reference(
                        q, k, v, None, dout, HEADS, DROPOUT, 3),
                    "lib_f0": sdpa_call(q, k, v, None), "lib_f": sdpa_call(q, k, v, None, DROPOUT),
                    "lib_b": sdpa_bwd_call(q, k, v, None, DROPOUT)}
            r.update({key: time_ms(fn, reps=5, warmup=1) for key, fn in slow.items()})
        log(12, f"(e) R={rows} {n}x{n} fp32 ({label}), device ms per call: K1 rate 0 "
                f"{r['fwd0']:.4f} (bound {r['b_f0'][0]:.4f}, {r['b_f0'][1]})" + (
                    f"; K1 rate 0.1 {r['fwd']:.4f} (bound {r['b_f'][0]:.4f}); K2 {r['bwd']:.4f} "
                    f"(bound {r['b_b'][0]:.4f}, {r['b_b'][1]})" if "fwd" in r else "") + (
                    f"; CUDA events, ms per call: plain rate 0 {r['plain_f0']:.3f}, rate 0.1 "
                    f"{r['plain_f']:.3f}, backward {r['plain_b']:.3f}; library sdpa rate 0 "
                    f"{r['lib_f0']:.4f}, rate 0.1 {r['lib_f']:.4f}, backward {r['lib_b']:.4f}"
                    if "plain_f0" in r else ""))
        del q, k, v, calls
        torch.cuda.empty_cache()
    return res


def phase_image(seed):
    """Phase 12, the image VAE. Returns the keys its kernels add to the
    kernels line, and the worst fp32 errors of (a)."""
    t_phase = time.perf_counter()
    worst = phase_image_kernels()
    phase_image_checkpoint()
    train = phase_image_training(seed)
    try_launches, latency = phase_try_image()
    t = phase_image_times()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    img = train["image"]
    log(12, f"train_image (B = {B_IMAGE}, K = 1, dropout {DROPOUT}, fp32): samples/s per epoch "
            f"{', '.join(f'{r:.1f}' for r in img['rates'])}, median of epochs 2-{IMAGE_EPOCHS} "
            f"{statistics.median(img['rates'][1:]):.1f} (epoch 1 of a fresh process warms cuBLAS "
            f"and the allocator), peak memory {img['peak']:.0f} MiB, device busy "
            f"{train['busy']:.1%} of a profiled step; reconstruct K={K_TRY} of {N_TRY} images "
            f"{latency * 1e3:.2f} ms; on {smi}")
    log(12, f"phase 12 took {time.perf_counter() - t_phase:.1f} s")

    def grid_keys(kind):
        """(ms, bound) keys of a row: kind 'f0' (K1 rate 0), 'f' (rate 0.1), 'b' (K2)."""
        keys = {}
        for label in ("image", "pixel", "mnist"):
            keys[f"ms_{label}"] = t[label][{"f0": "fwd0", "f": "fwd", "b": "bwd"}[kind]]
            keys[f"bound_ms_{label}"] = t[label][f"b_{kind}"][0]
        keys.update(plain_ms_image=t["image"][f"plain_{kind}"],
                    library_ms_image=t["image"][f"lib_{kind}"])
        return keys

    def launch_keys(counter, image_launches):
        return {"launches_image": image_launches,
                "launches_pixel": train["pixel"]["launches"][counter],
                "launches_mnist": train["mnist"]["launches"][counter]}

    rate0 = {lbl: train[lbl]["launches"]["K1"] - train[lbl]["launches"]["K1 rate>0"]
             for lbl in ("pixel", "mnist")}
    extra = {
        "attention_fwd": {"launches_image": try_launches, "launches_pixel": rate0["pixel"],
                          "launches_mnist": rate0["mnist"], **grid_keys("f0"),
                          "ms_image_r400": t["image_r400"]["fwd0"],
                          "bound_ms_image_r400": t["image_r400"]["b_f0"][0]},
        "attention_fwd_dropout": {**launch_keys("K1 rate>0", img["launches"]["K1 rate>0"]),
                                  **grid_keys("f")},
        "attention_bwd": {**launch_keys("K2", img["launches"]["K2"]), **grid_keys("b")},
    }
    return extra, worst


# -- contrastive pretraining and the regression heads -------------------------------

def batch_rows(batch, start, stop):
    """Events start..stop of a nested tuple of tensors."""
    return tuple(tuple(t[start:stop] for t in m) for m in batch)


def encoder_launches_of(rows, queries, context, selfattn):
    """K1 launches of one encoder TransformerStack forward on ``rows``
    events: per layer the queries' self-attention, the context
    self-attention where ``selfattn``, and the cross-attention."""
    return LAYERS * (int(routes_to_kernel(rows, HEADS, queries, queries))
                     + selfattn * int(routes_to_kernel(rows, HEADS, context, context))
                     + int(routes_to_kernel(rows, HEADS, queries, context)))


def contrastive_step_prediction(cfg):
    """Launches per train_contrastive step (COUNTERS order): both towers in
    train mode (latent_len queries over the light curve, and over the
    spectrum plus its phase token), so every routed grid launches K1 at the
    dropout rate in the forward and again in remat's re-run, and K2 once;
    no likelihood, so no K3 or K4."""
    sa, rows, q = cfg.model.selfattn, cfg.train.batch_size, cfg.model.latent_len
    n = encoder_launches_of(rows, q, LP, sa) + encoder_launches_of(rows, q, CONTEXT, sa)
    rate = 2 * n if cfg.model.dropout > 0 else 0
    return (rate, 2 * n, n, 0, 0)


def regression_step_prediction(modality, backbone):
    """Launches per train_regression step at the default configs: a frozen
    backbone's encoder (2·latent_len VAE queries, or latent_len tower
    queries) runs in eval mode once, with no gradient to re-run it for; an
    end-to-end encoder trains as a contrastive tower does."""
    context = LP if modality == "photometry" else CONTEXT
    latent_len = ContrastiveConfig().model.latent_len
    queries = 2 * latent_len if backbone == "mmvae" else latent_len
    n = encoder_launches_of(B_CONTRA, queries, context, False)
    if backbone == "end2end":
        return (2 * n, 2 * n, n, 0, 0)
    return (0, n, 0, 0, 0)


def phase_contrastive_checkpoint():
    """Phase 13(a): the bridged goldstein_contrastive_4-4_proj8 on the card,
    dropout off, on the 103 test events: z1 and z2 against the JAX
    package's (jax_projections.npz) within 1e-4 of max |z|, the InfoNCE
    over batches of 32 within 1e-4 of the JAX value; no kernel launched
    (every grid is below the dispatch thresholds)."""
    cfg = eval_goldstein._config_for(CONTRA_CKPT, ContrastiveConfig)
    model = eval_goldstein._restore(CONTRA_CKPT, train_contrastive.build_model(cfg))
    model = model.cuda().eval()
    data = resolve_dataset(None, "goldstein")
    x = multimodal_tuple(data, idx=np.asarray(data["testing_idx"]), device="cuda")
    ref = np.load(CONTRA_REF)
    reset_counts()
    with torch.inference_mode():
        z1, z2 = model(x)
        ce = [-objectives.neg_info_nce(model, batch_rows(x, s, s + B_CONTRA),
                                       cfg.temperature).item()
              for s in range(0, z1.shape[0] - B_CONTRA + 1, B_CONTRA)]
    launches = dict(zip(COUNTERS, kernel_counts()))
    rel = [np.abs(z.cpu().numpy() - ref[k]).max() / np.abs(ref[k]).max()
           for z, k in ((z1, "z1"), (z2, "z2"))]
    err = np.abs(np.asarray(ce) - ref["info_nce"]).max()
    log(13, f"(a) {CONTRA_CKPT} on {z1.shape[0]} test events: z1, z2 {tuple(z1.shape)} against "
            f"JAX max-abs/max {rel[0]:.3e}, {rel[1]:.3e} (gate 1e-4); InfoNCE over batches of "
            f"{B_CONTRA} {np.array2string(np.asarray(ce), precision=6)} (mean "
            f"{np.mean(ce):.6f}; ln {B_CONTRA} = {np.log(B_CONTRA):.6f}), JAX "
            f"{np.array2string(ref['info_nce'], precision=6)}, max-abs {err:.3e} (gate 1e-4); "
            f"launches {launches}")
    assert z1.shape == ref["z1"].shape and all(r <= 1e-4 for r in rel), rel
    assert err <= 1e-4, err
    assert all(v == 0 for v in launches.values()), launches


def epoch_timer(phase, label, per_step, timer):
    """A train_loop callback that appends each epoch's host time (epoch end
    to epoch end, the save included) to ``timer`` and checks its launches
    against ``per_step`` per step; ``start()`` marks the run's start."""
    mark = {}

    def start():
        torch.cuda.synchronize()
        mark.update(t=time.perf_counter(), counts=kernel_counts(), step=0)

    def on_epoch(epoch, state, loss):
        now, counts = time.perf_counter(), kernel_counts()
        steps = state.step - mark["step"]
        got = tuple(c - p for c, p in zip(counts, mark["counts"]))
        log(phase, f"{label} epoch {epoch + 1}: loss {loss:.6f}, {steps} steps, "
                   f"{now - mark['t']:.3f} s, launches {dict(zip(COUNTERS, got))}")
        assert np.isfinite(loss) and got == tuple(steps * w for w in per_step), (got, steps)
        timer.times.append(now - mark["t"])
        mark.update(t=time.perf_counter(), counts=kernel_counts(), step=state.step)

    return start, on_epoch


def phase_contrastive_training(seed):
    """Phase 13(b): train_contrastive.main at ContrastiveConfig's defaults
    (B = 32, dropout 0.1, the augmentation each epoch) for CONTRA_EPOCHS
    epochs: finite losses, launches as predicted (none), samples/s as
    StepTimer's mean over epochs 2-3, peak memory; a run of 2 epochs
    resumed to 3, bitwise the first; the device's busy share of one
    profiled step."""
    root = os.path.join(SMOKE_DIR, "contrastive")
    shutil.rmtree(root, ignore_errors=True)
    cfg = ContrastiveConfig()
    per_step = contrastive_step_prediction(cfg)
    timer = StepTimer(skip=1)
    start, on_epoch = epoch_timer(13, "(b) train_contrastive", per_step, timer)
    torch.cuda.reset_peak_memory_stats()
    start()
    state, losses = train_contrastive.main(
        driver_args(seed, os.path.join(root, "a"), f"train.epochs={CONTRA_EPOCHS}",
                    "train.save_every=1"), callback=on_epoch)
    peak = torch.cuda.max_memory_allocated() / 2**20
    steps = state.step // CONTRA_EPOCHS
    rate = timer.summary(items_per_step=steps * cfg.train.batch_size)["items_per_sec"]
    assert np.isfinite(losses).all() and len(losses) == CONTRA_EPOCHS, losses

    train_contrastive.main(driver_args(seed, os.path.join(root, "b"),
                                       f"train.epochs={CONTRA_EPOCHS - 1}"))
    resumed, resumed_losses = train_contrastive.main(driver_args(
        seed, os.path.join(root, "b"), f"train.epochs={CONTRA_EPOCHS}", "train.resume=true"))
    bitwise = all(torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                                     resumed.model.parameters()))
    log(13, f"(b) {CONTRA_EPOCHS - 1} epochs, then resumed to {CONTRA_EPOCHS}: losses "
            f"{resumed_losses} vs {losses}, parameters bitwise equal: {bitwise}")
    assert bitwise and resumed_losses == losses, resumed_losses

    step = make_train_step(state.model, optimizer_from_config(cfg.train),
                           lambda m, b, s: objectives.neg_info_nce(m, b, cfg.temperature, seed=s))
    data = resolve_dataset(None, "goldstein", seed=seed)
    batch = multimodal_tuple(data, idx=np.asarray(data["training_idx"])[:B_CONTRA],
                             device="cuda")
    busy = profile_calls(lambda: step(state, batch), f"train_contrastive step (B = {B_CONTRA})",
                         n=2, top=8, phase=13)
    log(13, f"(b) train_contrastive ({CONTRA_EPOCHS} epochs of {steps} steps, B = "
            f"{cfg.train.batch_size}, dropout {cfg.model.dropout}, fp32): losses {losses}; "
            f"samples/s {rate:.1f} (StepTimer over epochs 2-{CONTRA_EPOCHS}; epoch times "
            f"{', '.join(f'{t:.3f}' for t in timer.times)} s), peak memory {peak:.0f} MiB, "
            f"device busy {busy:.1%} of a profiled step")
    return dict(rate=rate, peak=peak, busy=busy, losses=losses)


def hold_attention(q, k, v, mask, label, phase):
    """K1 at rate 0 and 0.1 and K2 at rate 0.1 on one fp32 input (a path
    that trains in fp32) against their plain versions (by_rows), with phase
    3's fp32 gates: forward max-abs ≤ 1e-5, gradients ≤ 1e-4 of max
    |plain|. The kernels on the bf16-rounded input are printed beside them,
    against the plain version on the same rounded input and on the fp32
    one, not gated: phase 3 holds bf16 at these shapes on its random
    inputs, and on a real input's near-uniform attention dq is a small
    difference of large terms, which bf16 rounds coarsely. Returns the
    worst fp32 max-abs errors."""
    worst = {}
    dout = randn_like(q, 1300)
    q16, k16, v16, d16 = (t.bfloat16() for t in (q, k, v, dout))
    rounded = [t.float() for t in (q16, k16, v16, d16)]
    for rate, seed, name in ((0.0, None, "attention_fwd"),
                             (DROPOUT, 1301, "attention_fwd_dropout")):
        ref, ref16 = (by_rows(lambda q_, k_, v_, m_, s: attention.attention_reference(
            q_, k_, v_, m_, HEADS, rate, s), (*inputs, mask), seed)
            for inputs in ((q, k, v), rounded[:3]))
        out = attention.fused_attention(q, k, v, mask, HEADS, rate, seed)
        out16 = attention.fused_attention(q16, k16, v16, mask, HEADS, rate, seed)
        torch.cuda.synchronize()
        err32, err16, err16_fp32 = ((out - ref).abs().max().item(), _rel(out16, ref16),
                                    _rel(out16, ref))
        log(phase, f"{label} attention_fwd rate {rate}: fp32 max-abs {err32:.3e}; bf16 rel "
                   f"{err16:.3e} (against the plain version on fp32 inputs {err16_fp32:.3e}; "
                   f"not gated)")
        assert np.isfinite(err32) and err32 <= 1e-5, (label, rate, err32)
        worst[name] = err32
    want, want16 = (by_rows(lambda q_, k_, v_, m_, d_, s: attention.attention_backward_reference(
        q_, k_, v_, m_, d_, HEADS, DROPOUT, s), (*inputs[:3], mask, inputs[3]), 1302)
        for inputs in ((q, k, v, dout), rounded))
    errs = {}
    for dtype, qd, kd, vd, dd in ((torch.float32, q, k, v, dout),
                                  (torch.bfloat16, q16, k16, v16, d16)):
        out, m, l = attention.fused_attention_fwd(qd, kd, vd, mask, HEADS, DROPOUT, 1302)
        grads = attention.fused_attention_bwd(qd, kd, vd, mask, out, m, l, dd, HEADS, DROPOUT,
                                              1302)
        torch.cuda.synchronize()
        errs[dtype] = [_rel(g, w) for g, w in zip(grads, want if dtype == torch.float32
                                                  else want16)]
        if dtype == torch.float32:
            worst["attention_bwd"] = max((g - w).abs().max().item() for g, w in zip(grads, want))
        else:
            errs["bf16_fp32"] = [_rel(g, w) for g, w in zip(grads, want)]
    logits = attention._logits(q, k, None, HEADS)
    log(phase, f"{label} attention_bwd rate {DROPOUT}: dq, dk, dv rel fp32 "
               + ", ".join(f"{e:.2e}" for e in errs[torch.float32]) + "; bf16 "
               + ", ".join(f"{e:.2e}" for e in errs[torch.bfloat16]) + " (against the plain "
               "version on fp32 inputs " + ", ".join(f"{e:.2e}" for e in errs["bf16_fp32"])
               + f"; not gated); max |logit| {logits.abs().max().item():.3f}")
    del logits
    assert all(np.isfinite(e) and e <= 1e-4 for e in errs[torch.float32]), label
    return worst


def phase_contrastive_selfattn(seed):
    """Phase 13(c): train_contrastive model.selfattn=true for one epoch,
    the spectra tower's context self-attention over 982 bins and the phase
    token on K1 and K2: launches per step as contrastive_step_prediction
    derives them from routes_to_kernel; K1 and K2 on the captured
    [32, 983, 32] key-padded input against their plain versions with phase
    3's gates; then their device times beside the bounds, the plain
    versions and scaled_dot_product_attention on that input. Returns the
    run's launches, the worst fp32 errors and the times."""
    root = os.path.join(SMOKE_DIR, "contrastive_selfattn")
    shutil.rmtree(root, ignore_errors=True)
    cfg = parse_overrides(ContrastiveConfig(), ["model.selfattn=true"])
    per_step = contrastive_step_prediction(cfg)
    log(13, f"(c) selfattn: predicted launches per step {dict(zip(COUNTERS, per_step))}")
    assert per_step[1] > 0 and per_step[2] > 0, per_step
    timer, store = StepTimer(skip=0), []
    start, on_epoch = epoch_timer(13, "(c) train_contrastive model.selfattn=true", per_step,
                                  timer)
    reset_counts()
    start()
    with capture_attention(B_CONTRA, CONTEXT, CONTEXT, store):
        state, losses = train_contrastive.main(
            driver_args(seed, root, "model.selfattn=true", "train.epochs=1"), callback=on_epoch)
    launches = dict(zip(COUNTERS, kernel_counts()))
    assert np.isfinite(losses).all()
    assert tuple(launches.values()) == tuple(state.step * w for w in per_step), launches

    q, k, v, mask = (t.detach() for t in store)
    del store[:]
    assert mask is not None and not bool(mask[:, -1].any())  # the phase token is observed
    worst = hold_attention(q, k, v, mask, f"(c) captured [{B_CONTRA}, {CONTEXT}, {MODEL_DIM}] "
                                          f"({mask.float().mean().item():.1%} of keys masked)", 13)
    dout, word = randn_like(q, 1310), seed_word(3)
    out, m, l = attention.fused_attention_fwd(q, k, v, mask, HEADS, DROPOUT, 3)
    dev = {"fwd0": lambda: attention.fused_attention(q, k, v, mask, HEADS),
           "fwd": lambda: attention.fused_attention_fwd(q, k, v, mask, HEADS, DROPOUT, word),
           "bwd": lambda: attention.fused_attention_bwd(q, k, v, mask, out, m, l, dout, HEADS,
                                                        DROPOUT, word)}
    t = {}
    for key, fn in dev.items():
        t[key], kernels, _ = device_kernels(fn)
        assert kernels == 1, (key, kernels)
    slow = {"plain_f0": lambda: attention.attention_reference(q, k, v, mask, HEADS),
            "plain_f": lambda: attention.attention_reference(q, k, v, mask, HEADS, DROPOUT, 3),
            "plain_b": lambda: attention.attention_backward_reference(q, k, v, mask, dout, HEADS,
                                                                      DROPOUT, 3),
            "lib_f0": sdpa_call(q, k, v, mask), "lib_f": sdpa_call(q, k, v, mask, DROPOUT),
            "lib_b": sdpa_bwd_call(q, k, v, mask, DROPOUT)}
    t.update({key: time_ms(fn, reps=5, warmup=1) for key, fn in slow.items()})
    t["b_f0"] = attention_bound(B_CONTRA, CONTEXT, CONTEXT, torch.float32, True)
    t["b_f"] = attention_bound(B_CONTRA, CONTEXT, CONTEXT, torch.float32, True, stats=True)
    t["b_b"] = attention_bwd_bound(B_CONTRA, CONTEXT, CONTEXT, torch.float32)
    log(13, f"(c) R={B_CONTRA} {CONTEXT}x{CONTEXT} masked fp32, device ms per call: K1 rate 0 "
            f"{t['fwd0']:.4f} (bound {t['b_f0'][0]:.4f}, {t['b_f0'][1]}), rate 0.1 "
            f"{t['fwd']:.4f} (bound {t['b_f'][0]:.4f}); K2 {t['bwd']:.4f} (bound "
            f"{t['b_b'][0]:.4f}, {t['b_b'][1]}); CUDA events, ms per call: plain rate 0 "
            f"{t['plain_f0']:.3f}, rate 0.1 {t['plain_f']:.3f}, backward {t['plain_b']:.3f}; "
            f"library sdpa rate 0 {t['lib_f0']:.4f}, rate 0.1 {t['lib_f']:.4f}, backward "
            f"{t['lib_b']:.4f}; epoch {timer.times[0]:.3f} s")
    del q, k, v, mask, dout, out, m, l, dev, slow
    torch.cuda.empty_cache()
    return launches, worst, t


def phase_regression_training(seed):
    """Phase 13(d): train_regression.main for one epoch for each modality
    and backbone at RegressionConfig's defaults: mmvae over the bridged
    flagship, contrast over the bridged contrastive checkpoint, end2end
    from scratch. With a frozen backbone every backbone parameter is
    bitwise its checkpoint's and has no optimizer state; every trainable
    parameter moved from its initial value (train_loop's initialisation
    under the run's seed); launches as the dispatch rule predicts (none).
    Returns samples/s of each run."""
    root = os.path.join(SMOKE_DIR, "regression")
    shutil.rmtree(root, ignore_errors=True)
    cfg = RegressionConfig()
    rates = {}
    for modality in train_regression.MODALITIES:
        for backbone in train_regression.BACKBONES:
            ckpt = REGRESSION_BACKBONES[backbone]
            timer = StepTimer(skip=0)
            per_step = regression_step_prediction(modality, backbone)
            start, on_epoch = epoch_timer(13, f"(d) {modality} {backbone}", per_step, timer)
            reset_counts()
            start()
            state, losses = train_regression.main(
                [f"modality={modality}", f"backbone={backbone}",
                 *([f"backbone_ckpt={ckpt}"] if ckpt else []),
                 *driver_args(seed, root, "train.epochs=1")], callback=on_epoch)
            head, frozen = train_regression.build_head(modality, backbone, ckpt, seed, cfg)
            init_params(head, torch.Generator().manual_seed(fold_in(seed, 0)))
            initial = head.state_dict()
            trainable = {id(p) for p in state.trainable_parameters()}
            n_frozen = n_moved = 0
            for name, p in state.model.named_parameters():
                if frozen and name in frozen:
                    assert torch.equal(p.cpu(), frozen[name]), name
                    assert id(p) not in trainable and p not in state.optimizer.state, name
                    n_frozen += 1
                else:
                    assert id(p) in trainable and not torch.equal(p.cpu(), initial[name]), name
                    n_moved += 1
            samples = state.step * cfg.train.batch_size
            rates[(modality, backbone)] = samples / timer.times[0]
            log(13, f"(d) train_regression modality={modality} backbone={backbone}: loss "
                    f"{losses[0]:.6f}, {state.step} steps, {rates[(modality, backbone)]:.1f} "
                    f"samples/s (one epoch, host clock, the save included); {n_frozen} frozen "
                    f"parameters bitwise their checkpoint's and outside AdamW, {n_moved} "
                    f"trainable parameters all moved")
            assert np.isfinite(losses).all() and n_moved == len(trainable)
            assert (n_frozen > 0) == (backbone != "end2end")
    return rates


def phase_regression_eval():
    """Phase 13(e): eval_regression.main on the bridged
    goldstein_photometry2param_mmvae head with the copied normalizing JSON:
    absdiff [103, 4] within 1e-4 absolute of the JAX package's CPU result
    (jax_absdiff.npy); the per-parameter means beside the shipped TPU
    file's; events/s of the driver (its set-up included) and of the head's
    forward alone (median of 10 calls)."""
    out = os.path.join(SMOKE_DIR, "regression_eval")
    shutil.rmtree(out, ignore_errors=True)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    absdiff = eval_regression.main(["modality=photometry", "backbone=mmvae",
                                    f"head_ckpt={HEAD_CKPT}",
                                    f"train.ckpt_dir={os.path.dirname(HEAD_CKPT)}", f"out={out}"])
    wall = time.perf_counter() - t0
    launches = dict(zip(COUNTERS, kernel_counts()))
    ref, tpu = np.load(HEAD_REF), np.load(HEAD_TPU)["mean"]
    err = np.abs(absdiff - ref).max()
    head, _ = train_regression.build_head("photometry", "mmvae")
    head = eval_goldstein._restore(HEAD_CKPT, head).cuda().eval()
    data = resolve_dataset(None, "goldstein")
    x = photometry_tuple(data, idx=np.asarray(data["testing_idx"]), device="cuda")
    lat = []
    with torch.inference_mode():
        for _ in range(12):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            head(x)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
    forward = statistics.median(lat[2:])
    n = absdiff.shape[0]
    log(13, f"(e) eval_regression {HEAD_CKPT}: absdiff {absdiff.shape} max-abs {err:.3e} against "
            f"the JAX CPU result (gate 1e-4); |error|/sigma per parameter "
            f"{np.array2string(absdiff.mean(0), precision=4)}, JAX CPU "
            f"{np.array2string(ref.mean(0), precision=4)}, the shipped TPU file "
            f"{np.array2string(tpu, precision=4)}; the driver {wall:.3f} s for {n} events "
            f"({n / wall:.1f} events/s, set-up included), the head's forward on all {n} "
            f"{forward * 1e3:.3f} ms ({n / forward:.0f} events/s); launches {launches}")
    assert absdiff.shape == ref.shape and err <= 1e-4, err
    assert all(v == 0 for v in launches.values()), launches
    return dict(events_s=n / wall, forward_events_s=n / forward, wall=wall)


def phase_contrastive(seed):
    """Phase 13, contrastive pretraining and the regression heads. Returns
    the keys its kernels add to the kernels line, and the worst fp32
    errors of (c)."""
    t_phase = time.perf_counter()
    phase_contrastive_checkpoint()
    train = phase_contrastive_training(seed)
    launches, worst, t = phase_contrastive_selfattn(seed)
    rates = phase_regression_training(seed)
    ev = phase_regression_eval()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(13, f"train_contrastive (B = {B_CONTRA}, dropout {DROPOUT}, fp32): {train['rate']:.1f} "
            f"samples/s, peak memory {train['peak']:.0f} MiB, device busy {train['busy']:.1%} of "
            f"a profiled step; train_regression samples/s "
            + ", ".join(f"{m}/{b} {r:.1f}" for (m, b), r in rates.items())
            + f"; eval_regression {ev['events_s']:.1f} events/s (the head's forward "
            f"{ev['forward_events_s']:.0f}); on {smi}")
    log(13, f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    extra = {
        "attention_fwd": {"launches_contrastive_selfattn": launches["K1"] - launches["K1 rate>0"],
                          "ms_contrastive_selfattn": t["fwd0"],
                          "bound_ms_contrastive_selfattn": t["b_f0"][0],
                          "plain_ms_contrastive_selfattn": t["plain_f0"],
                          "library_ms_contrastive_selfattn": t["lib_f0"]},
        "attention_fwd_dropout": {"launches_contrastive_selfattn": launches["K1 rate>0"],
                                  "ms_contrastive_selfattn": t["fwd"],
                                  "bound_ms_contrastive_selfattn": t["b_f"][0],
                                  "plain_ms_contrastive_selfattn": t["plain_f"],
                                  "library_ms_contrastive_selfattn": t["lib_f"]},
        "attention_bwd": {"launches_contrastive_selfattn": launches["K2"],
                          "ms_contrastive_selfattn": t["bwd"],
                          "bound_ms_contrastive_selfattn": t["b_b"][0],
                          "plain_ms_contrastive_selfattn": t["plain_b"],
                          "library_ms_contrastive_selfattn": t["lib_b"]},
    }
    return extra, worst


# -- multi-GPU on one card -----------------------------------------------------------

# phase 14: the flagship step at B_TRAIN = 192 over the mesh (96 events a rank
# on two ranks), and DP serving at K_SERVE over a ladder with bucket 64, where
# the 982x5 cross-attention routes to K1 only with the global rows (6,400 ≥
# 3,417; a rank's 3,200 alone would not)
DP_BUCKETS = (8, 32, 64, 128)
HELD_ROWS = 32  # rows of a rank's captured K1/K2 input held against the plain versions


def one_process_step(seed, batch, dropout):
    """(loss, parameters on the CPU) of one flagship step in this process."""
    model = flagship(seed, dropout)
    opt = adamw(LR)
    state = TrainState.create(model, opt, seed=seed)
    step = make_train_step(model, opt, m_iwae_loss, accum_reduction="sum")
    state, loss = step(state, batch)
    return loss.item(), {k: v.detach().cpu() for k, v in model.state_dict().items()}


@contextlib.contextmanager
def capture_kernel_input(store):
    """Keep the first K1 call at a dropout rate above 0 on the 982x982 grid
    as the layers hand it over: (q, k, v, mask, heads, rate, seed)."""
    real = layers.fused_attention

    def capturing(q, k, v, mask, heads, rate, seed):
        if not store and rate > 0 and q.shape[1] == k.shape[1] == NS:
            store.extend((q.detach().clone(), k.detach().clone(), v.detach().clone(), mask,
                          heads, rate, seed))
        return real(q, k, v, mask, heads, rate, seed)

    layers.fused_attention = capturing
    try:
        yield
    finally:
        layers.fused_attention = real


def hold_rank_kernels(q, k, v, mask, heads, rate, seed, phase):
    """K1 and K2 on the first HELD_ROWS rows of a rank's captured input,
    with the rank's seed, against their plain versions (8 rows a call; row
    r's mask is keyed by seed + (r·heads + h)·1024; on bf16 inputs the
    plain versions take them widened to fp32): phase 3's gates, in fp32
    forward max-abs ≤ 1e-5 and gradients ≤ 1e-4 of max |plain|, in bf16
    the forward, dk and dv ≤ 2e-2 of max |plain|, and dq is returned
    ungated: on near-uniform attention bf16 K2's dq errs as the JAX
    kernel's does (ROADMAP Queue 3), so the caller holds the masks with
    the fp32 kernels on the widened input. Returns (forward max-abs, worst
    gradient max-abs, the gradients' relative errors, the forward's)."""
    q, k, v = (t[:HELD_ROWS].contiguous() for t in (q, k, v))
    mask = None if mask is None else mask[:HELD_ROWS].contiguous()
    dout = randn_like(q, 1400)
    ref, want = [], []
    for r0 in range(0, q.shape[0], REF_ROWS):
        s = slice(r0, r0 + REF_ROWS)
        s_seed = (seed + r0 * heads * 1024) & 0xFFFFFFFF
        m_s = None if mask is None else mask[s]
        qs, ks, vs, ds = (t[s].float() for t in (q, k, v, dout))
        ref.append(attention.attention_reference(qs, ks, vs, m_s, heads, rate, s_seed))
        want.append(attention.attention_backward_reference(qs, ks, vs, m_s, ds, heads, rate,
                                                           s_seed))
    ref = torch.cat(ref)
    want = [torch.cat(w) for w in zip(*want)]
    out, m, l = attention.fused_attention_fwd(q, k, v, mask, heads, rate, seed)
    grads = attention.fused_attention_bwd(q, k, v, mask, out, m, l, dout, heads, rate, seed)
    torch.cuda.synchronize()
    err_f = (out.float() - ref).abs().max().item()
    rel_b = [_rel(g, w) for g, w in zip(grads, want)]
    rel_f = _rel(out, ref)
    assert np.isfinite(err_f) and all(np.isfinite(e) for e in rel_b), (err_f, rel_b)
    if q.dtype == torch.bfloat16:
        assert rel_f <= 2e-2 and all(e <= 2e-2 for e in rel_b[1:]), (rel_f, rel_b)
    else:
        assert err_f <= 1e-5 and all(e <= 1e-4 for e in rel_b), (err_f, rel_b)
    return (err_f, max((g.float() - w).abs().max().item() for g, w in zip(grads, want)), rel_b,
            rel_f)


def rank_keep_rate(seed, heads, rows=8):
    """K1's keep rate under a rank's seed (``keep_rate_check``'s measure:
    q = 0, v = 1): (keep, its distance from 230/256 in sigmas)."""
    q = torch.zeros(rows, NS, heads * (MODEL_DIM // HEADS), device="cuda")
    out = attention.fused_attention(q, q, torch.ones_like(q), None, heads, DROPOUT, seed)
    keep = out.double().mean().item() * (1.0 - DROPOUT)
    p, n = 230 / 256, rows * heads * NS * NS
    return keep, abs(keep - p) / (p * (1 - p) / n) ** 0.5


def all_ranks(values):
    """``values`` (a list of floats) of every rank, one row per rank: an
    all-reduce of a zeroed [world, n] tensor on this rank's device."""
    import torch.distributed as dist

    world, r = dist.get_world_size(), dist.get_rank()
    t = torch.zeros(world, len(values), dtype=torch.float64, device="cuda")
    t[r] = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t)
    return t.cpu().tolist()


def rank_step(seed, batch, dropout, steps=1, hold=True):
    """A rank of phase 14: ``steps`` flagship steps on the global batch
    over this rank's mesh (tensor-parallel where its model axis is > 1),
    the kernels' launches of the first step counted from 0. Returns the
    first step's loss, the whole parameters after it, every rank's
    launches, the captured K1 input's seed, rows, heads and keep rate, the
    time of the last step, the peak memory and (with ``hold``) the errors
    of K1/K2 held on each rank's captured input with that rank's seed (a
    rank whose kernels disagree raises, and fails the launch)."""
    mesh = parallel.current_mesh()
    model = flagship(seed, dropout)
    opt = adamw(LR)
    state = TrainState.create(model, opt, seed=seed)
    if mesh.model > 1:
        parallel.shard_state_tp(state, mesh)
    step = make_train_step(model, opt, m_iwae_loss, accum_reduction="sum", mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    store = []
    reset_counts()
    with capture_kernel_input(store):
        state, loss = step(state, batch)
        loss = loss.item()
    counts = kernel_counts()
    params = {k: v.detach().cpu() for k, v in
              parallel.gather_state_tp(state, mesh)["model"].items()}
    times = []
    for _ in range(steps - 1):
        t0 = time.perf_counter()
        state, l = step(state, batch)
        l.item()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**20
    held = hold_rank_kernels(*store, phase=14) if store and hold else None
    seed_k1 = store[6] if store else None
    rows_k1, heads_k1 = (store[0].shape[0], store[4]) if store else (0, 0)
    keep = rank_keep_rate(seed_k1, heads_k1) if store else (0.0, 0.0)
    errs = [held[0], held[1], max(held[2])] if held else [-1.0, -1.0, -1.0]
    table = all_ranks([*counts, -1 if seed_k1 is None else seed_k1, rows_k1, heads_k1, *keep,
                       peak, times[-1] if times else 0.0, *errs])
    return loss, params, table


def tp_ranks_program(seed, batch):
    """Phase 14 (c) on both ranks of the 1x2 mesh: the step at dropout 0
    and 0.1."""
    return rank_step(seed, batch, 0.0), rank_step(seed, batch, DROPOUT, steps=2)


def dp_ranks_program(seed, batch, photo, spec):
    """Phase 14 (b) and (d) on both ranks of the 2x1 mesh: the step at
    dropout 0 and 0.1, then DP serving."""
    b0 = rank_step(seed, batch, 0.0)
    b1 = rank_step(seed, batch, DROPOUT, steps=2)
    mesh = parallel.current_mesh()
    server = InferenceServer(flagship(seed), buckets=DP_BUCKETS, seed=seed, mesh=mesh)
    served = {}
    for n, bucket in ((20, 32), (60, 64)):
        g = torch.Generator("cuda").manual_seed(seed)
        server.crossmodal_ci(tuple(a[:n] for a in photo), tuple(a[:n] for a in spec),
                             K=K_SERVE, generator=g)  # builds nothing new; warms the allocator
        torch.cuda.synchronize()
        reset_counts()
        g = torch.Generator("cuda").manual_seed(seed)
        t0 = time.perf_counter()
        out = server.crossmodal_ci(tuple(a[:n] for a in photo), tuple(a[:n] for a in spec),
                                   K=K_SERVE, generator=g)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        served[bucket] = ([t.cpu() for t in out], all_ranks([attention.launches, dt]))
    return b0, b1, served


def _params_close(got, want):
    """max |got − want| over max |want|, over every parameter."""
    return (max((got[k] - want[k]).abs().max().item() for k in want)
            / max(w.abs().max().item() for w in want.values()))


def _check_step(label, loss, params, want_loss, want_params, rtol, ptol):
    rel_loss = abs(loss - want_loss) / abs(want_loss)
    rel_params = _params_close(params, want_params)
    bitwise = loss == want_loss and all(torch.equal(params[k], want_params[k])
                                        for k in want_params)
    log(14, f"{label}: loss {loss:.6f} against one process {want_loss:.6f} (relative "
            f"{rel_loss:.3e}); parameters after the step within {rel_params:.3e} of max |param|"
            f"{' (bitwise equal)' if bitwise else ''}")
    assert bitwise or (rel_loss <= rtol and rel_params <= ptol), (label, rel_loss, rel_params)


def _check_launches(label, table, want, phase=14):
    for r, row in enumerate(table):
        got = tuple(int(x) for x in row[:5])
        log(phase, f"{label} rank {r}: launches {dict(zip(COUNTERS, got))} (predicted "
                f"{dict(zip(COUNTERS, want))})")
        assert got == want, (label, r, got, want)
    return [tuple(int(x) for x in row[:5]) for row in table]


def _check_masks(label, table, phase=14, length=NS):
    """Each rank's K1 keep rate within 4 sigma of 230/256, the ranks' block
    seeds [seed, seed + rows·heads·1024) disjoint, and each rank's K1/K2
    held on its own captured input with its own seed (``rank_step``).
    Returns the worst forward and gradient max-abs errors over the ranks."""
    spans = []
    for r, row in enumerate(table):
        seed, rows, heads, keep, sigmas = int(row[5]), int(row[6]), int(row[7]), row[8], row[9]
        log(phase, f"{label} rank {r}: K1 seed {seed} over [{rows}, {length}, {length}] x "
                f"{heads} heads, keep rate {keep:.6f} ({sigmas:.2f} sigma)")
        assert sigmas <= 4, (label, r, keep)
        spans.append((seed, seed + rows * heads * 1024))
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        assert a1 <= b0 or b1 <= a0, (label, spans)
    for r, row in enumerate(table):
        err_f, err_b, rel_b = row[12:15]
        assert err_f >= 0, (label, r, "no K1/K2 input captured")
        held = min(HELD_ROWS, int(row[6]))
        log(phase, f"{label} rank {r}: K1/K2 on its captured input ({held} rows, seed "
                f"{int(row[5])}) against the plain versions: forward max-abs {err_f:.3e}, "
                f"gradients max-abs {err_b:.3e} (worst of dq, dk, dv relative {rel_b:.2e})")
    return max(row[12] for row in table), max(row[13] for row in table)


def phase_multigpu(seed):
    """Phase 14, multi-GPU on one card (``parallel``): (a) a world-1 NCCL
    group runs the DDP flagship step at B = 192, equal to the one-process
    step; (b) two ranks share the card over gloo, 96 events each, at
    dropout 0 and 0.1 (against the one-process step: loss within 1e-4
    relative, parameters within 1e-3 of max |param|; at 0.1 every rank's
    launches as predicted with global rows, K1/K2 held against their plain
    versions on every rank's captured input with its shard seed, the
    ranks' masks disjoint streams); (c) a 1x2 tensor-parallel step (2 heads of packed
    width 16 a rank), at dropout 0 against one process and at 0.1 with K1/K2
    held; (d) DP crossmodal_ci at K = 100 over the two ranks against one
    process on the same generator, within 1e-5 relative, K1 launches per
    rank as global-row routing predicts. Returns the per-rank launches and
    the worst K1/K2 errors."""
    t_phase = time.perf_counter()
    # a rank that hangs fails the phase within the script's time limit
    parallel.mesh.LAUNCH_TIMEOUT, parallel.mesh.GROUP_TIMEOUT = 420.0, 300.0
    torch.cuda.empty_cache()
    batch = make_batch(B_TRAIN, seed + 14)
    photo, spec = make_batch(64, seed + 15)
    loss0, params0 = one_process_step(seed, to_device(batch, torch.device("cuda")), 0.0)
    loss1, params1 = one_process_step(seed, to_device(batch, torch.device("cuda")), DROPOUT)
    pred0, pred1 = (train_step_prediction(B_TRAIN, d) for d in (0.0, DROPOUT))
    res = {}

    world1 = parallel.make_mesh(["cuda:0"])
    assert world1.backend == "nccl", world1
    loss, params, table = parallel.launch(rank_step, world1, seed, batch, DROPOUT, 1, False)
    _check_step("(a) world-1 NCCL DDP step, dropout 0.1", loss, params, loss1, params1, 1e-6,
                1e-6)
    res["nccl"] = _check_launches("(a)", table, pred1)

    two = parallel.make_mesh(["cuda:0", "cuda:0"])
    assert two.backend == "gloo", two
    b0, b1, served = parallel.launch(dp_ranks_program, two, seed, batch, photo, spec)
    _check_step("(b) 2 ranks, dropout 0", b0[0], b0[1], loss0, params0, 1e-4, 1e-3)
    _check_launches("(b) dropout 0", b0[2], pred0)
    # each rank's K1 masks are its rows' block of the one process's (shard
    # seed) and its generator draws its part of the whole step's
    _check_step("(b) 2 ranks, dropout 0.1", b1[0], b1[1], loss1, params1, 1e-4, 1e-3)
    res["dp"] = _check_launches("(b) dropout 0.1", b1[2], pred1)
    worst = _check_masks("(b)", b1[2])

    tp = parallel.make_mesh(["cuda:0", "cuda:0"], data=1, model=2)
    c0, c1 = parallel.launch(tp_ranks_program, tp, seed, batch)
    _check_step("(c) 1x2 tensor parallel, dropout 0", c0[0], c0[1], loss0, params0, 1e-4, 1e-3)
    res["tp"] = _check_launches("(c) dropout 0.1", c1[2], pred1)
    assert all(int(row[7]) == HEADS // 2 for row in c1[2])  # 2 heads of width 16 a rank
    assert np.isfinite(c1[0]), c1[0]  # TP head shards draw other (equally valid) masks
    tp_worst = _check_masks("(c)", c1[2])
    worst = tuple(max(a, b) for a, b in zip(worst, tp_worst))

    server = InferenceServer(flagship(seed), buckets=DP_BUCKETS, seed=seed)
    res["serving"] = []
    for n, bucket in ((20, 32), (60, 64)):
        g = torch.Generator("cuda").manual_seed(seed)
        want = server.crossmodal_ci(tuple(a[:n] for a in photo), tuple(a[:n] for a in spec),
                                    K=K_SERVE, generator=g)
        got, table = served[bucket]
        rel = max(_rel(x.cuda(), w) for x, w in zip(got, want))
        predicted = encoder_launches(0, bucket) + decoder_launches(1, K_SERVE * bucket)
        local = encoder_launches(0, bucket // 2) + decoder_launches(1, K_SERVE * bucket // 2)
        launches = [int(row[0]) for row in table]
        log(14, f"(d) crossmodal_ci K={K_SERVE} n={n} (bucket {bucket}) on 2 ranks: within "
                f"{rel:.3e} of one process; K1 launches per rank {launches} (predicted "
                f"{predicted} with the global rows, {local} with a rank's own); "
                + ", ".join(f"rank {r} {row[1] * 1e3:.1f} ms, {n / 2 / row[1]:.1f} events/s"
                            for r, row in enumerate(table)))
        assert rel <= 1e-5, (bucket, rel)
        assert launches == [predicted] * 2, (bucket, launches, predicted)
        res["serving"].append(launches)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    for label, table, events in (("(b) DP 2x1", b1[2], B_TRAIN // 2),
                                 ("(c) TP 1x2", c1[2], B_TRAIN)):
        log(14, f"{label}, two ranks on one card, B = {B_TRAIN}, dropout {DROPOUT}, fp32: "
                + "; ".join(f"rank {r}: {events} events a step, {row[11] * 1e3:.1f} ms = "
                            f"{events / row[11]:.1f} samples/s, peak memory {row[10]:.0f} MiB"
                            for r, row in enumerate(table))
                + f" (not a scaling number); on {smi}")
    log(14, f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return res, worst


# -- extras and migration ------------------------------------------------------------

# phase 15: TransformerModel at the flagship's block widths over a spectrum-
# length sequence and the spectra decoder's 5-token context (4 latent tokens
# and the phase token); RelativeMultiHeadAttention over the same grid on
# EXTRAS_RELATIVE events; the stand-in reference pickle served at K_EXTRAS
EXTRAS_CONTEXT = LATENT_LEN + 1
EXTRAS_RELATIVE = 8
K_EXTRAS = 4
STAND_IN = '''"""A stand-in for the reference VAESNe package: a module whose
state_dict() holds the reference's parameter names."""
import torch


class photospecMMVAE(torch.nn.Module):
    def __init__(self, tensors):
        super().__init__()
        self.tensors = dict(tensors)

    def state_dict(self, *args, **kwargs):
        return dict(self.tensors)
'''


def extras_rows():
    """The fewest rows for which TransformerModel's 982x982 self-attention
    routes to the kernels."""
    rows = 1
    while not routes_to_kernel(rows, HEADS, NS, NS):
        rows += 1
    return rows


def extras_prediction(rows, rate, backward):
    """K1/K2 launches of one TransformerModel call: each routed grid of a
    layer (self-attention 982x982, cross-attention 982x5, context
    self-attention 5x5) launches K1 once; with a backward, remat re-runs
    the block's forward (K1 again) and K2 runs once."""
    grids = LAYERS * sum(routes_to_kernel(rows, HEADS, lq, lk) for lq, lk in (
        (NS, NS), (NS, EXTRAS_CONTEXT), (EXTRAS_CONTEXT, EXTRAS_CONTEXT)))
    k1 = 2 * grids if backward else grids
    return (k1 if rate > 0 else 0, k1, grids if backward else 0, 0, 0)


@contextlib.contextmanager
def plain_attention():
    """The layers' routed attentions on the plain version (the same
    dropout hash), on whatever device the tensors lie."""
    real = layers.fused_attention
    layers.fused_attention = attention.attention_reference
    try:
        yield
    finally:
        layers.fused_attention = real


def phase_transformer_model(seed):
    """Phase 15(a): TransformerModel(32, 4 heads, ff 32, 4 layers) over
    [R, 982, 32] with a key-padding mask and a [R, 5, 32] context, R the
    fewest rows that route: the forward at rate 0 and a backward at
    dropout 0.1 against the same module on the plain path on the card,
    with phase 3's fp32 gates (forward max-abs ≤ 1e-5, gradients ≤ 1e-4 of
    max |plain|), the launches as extras_prediction; K1/K2 on the captured
    self-attention input against their plain versions, timed beside their
    bounds. Returns the launches of both runs, the worst errors and the
    times."""
    rows = extras_rows()
    log(15, f"(a) TransformerModel: R = {rows}, the fewest rows for which the {NS}x{NS} "
            f"self-attention routes (routes_to_kernel)")
    model = init_params(TransformerModel(MODEL_DIM, HEADS, FF_DIM, LAYERS, dropout=DROPOUT),
                        torch.Generator().manual_seed(seed + 15)).cuda()
    g = torch.Generator("cuda").manual_seed(seed + 15)
    x = torch.randn(rows, NS, MODEL_DIM, device="cuda", generator=g)
    ctx = torch.randn(rows, EXTRAS_CONTEXT, MODEL_DIM, device="cuda", generator=g)
    mask = torch.rand(rows, NS, device="cuda", generator=g) < 0.2
    w = torch.randn(rows, NS, MODEL_DIM, device="cuda", generator=g)
    launches = {}

    model.eval()
    store = []
    with torch.no_grad():
        reset_counts()
        with capture_attention(rows, NS, NS, store):
            out = model(x, ctx, mask)
        torch.cuda.synchronize()
        launches["forward"] = dict(zip(COUNTERS, kernel_counts()))
        with plain_attention():
            ref = model(x, ctx, mask)
    err_f = (out - ref).abs().max().item()
    want = dict(zip(COUNTERS, extras_prediction(rows, 0.0, False)))
    log(15, f"(a) forward at rate 0: launches {launches['forward']} (predicted {want}); "
            f"against the plain path on the card max-abs {err_f:.3e}")
    assert launches["forward"] == want, (launches["forward"], want)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert np.isfinite(err_f) and err_f <= 1e-5, err_f

    model.train()
    params = [x.requires_grad_(), ctx.requires_grad_(), *model.parameters()]

    def grads():
        return torch.autograd.grad((model(x, ctx, mask, seed=seed) * w).sum(), params)

    reset_counts()
    got = grads()
    torch.cuda.synchronize()
    launches["backward"] = dict(zip(COUNTERS, kernel_counts()))
    with plain_attention():
        want_g = grads()
    x.requires_grad_(False)
    ctx.requires_grad_(False)
    # a key projection's bias adds one constant to every logit of a query,
    # which the softmax cancels: its gradient is 0 up to round-off, so it is
    # held against the largest gradient of all, the rest each against its own
    names = ["x", "context"] + [n for n, _ in model.named_parameters()]
    scale = max(b.abs().max().item() for b in want_g)
    rel = max(_rel(a, b) for n, a, b in zip(names, got, want_g) if not n.endswith("k_proj.bias"))
    zero = max((a - b).abs().max().item() / scale
               for n, a, b in zip(names, got, want_g) if n.endswith("k_proj.bias"))
    want = dict(zip(COUNTERS, extras_prediction(rows, DROPOUT, True)))
    log(15, f"(a) forward and backward at dropout {DROPOUT}: launches {launches['backward']} "
            f"(predicted {want}); gradients of x, the context and {len(params) - 2} parameters "
            f"against the plain path on the card, worst relative {rel:.3e}; the key "
            f"projections' biases (0 up to round-off) {zero:.3e} of the largest gradient")
    assert launches["backward"] == want, (launches["backward"], want)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert np.isfinite(rel) and rel <= 1e-4, rel
    assert np.isfinite(zero) and zero <= 1e-4, zero

    q, k, v, m = (t.detach() for t in store)
    del store[:]
    worst = hold_attention(q, k, v, m, f"(a) captured [{rows}, {NS}, {MODEL_DIM}] "
                                       f"({m.float().mean().item():.1%} of keys masked)", 15)
    dout, word = randn_like(q, 1510), seed_word(5)
    o, mx, l = attention.fused_attention_fwd(q, k, v, m, HEADS, DROPOUT, 5)
    t = {}
    for key, fn in (("fwd0", lambda: attention.fused_attention(q, k, v, m, HEADS)),
                    ("fwd", lambda: attention.fused_attention_fwd(q, k, v, m, HEADS, DROPOUT,
                                                                  word)),
                    ("bwd", lambda: attention.fused_attention_bwd(q, k, v, m, o, mx, l, dout,
                                                                  HEADS, DROPOUT, word))):
        t[key], kernels, _ = device_kernels(fn)
        assert kernels == 1, (key, kernels)
    t.update({"plain_f0": time_ms(lambda: attention.attention_reference(q, k, v, m, HEADS)),
              "plain_f": time_ms(lambda: attention.attention_reference(q, k, v, m, HEADS,
                                                                       DROPOUT, 5)),
              "plain_b": time_ms(lambda: attention.attention_backward_reference(
                  q, k, v, m, dout, HEADS, DROPOUT, 5)),
              "lib_f0": time_ms(sdpa_call(q, k, v, m)),
              "lib_f": time_ms(sdpa_call(q, k, v, m, DROPOUT)),
              "lib_b": time_ms(sdpa_bwd_call(q, k, v, m, DROPOUT))})
    t["b_f0"] = attention_bound(rows, NS, NS, torch.float32, True)
    t["b_f"] = attention_bound(rows, NS, NS, torch.float32, True, stats=True)
    t["b_b"] = attention_bwd_bound(rows, NS, NS, torch.float32)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(15, f"(a) R={rows} {NS}x{NS} masked fp32, device ms per launch: K1 rate 0 "
            f"{t['fwd0']:.4f} (bound {t['b_f0'][0]:.4f}, {t['b_f0'][1]}), rate {DROPOUT} "
            f"{t['fwd']:.4f} (bound {t['b_f'][0]:.4f}); K2 {t['bwd']:.4f} (bound "
            f"{t['b_b'][0]:.4f}, {t['b_b'][1]}); CUDA events, ms per call: plain rate 0 "
            f"{t['plain_f0']:.3f}, rate {DROPOUT} {t['plain_f']:.3f}, backward "
            f"{t['plain_b']:.3f}; library sdpa rate 0 {t['lib_f0']:.4f}, rate {DROPOUT} "
            f"{t['lib_f']:.4f}, backward {t['lib_b']:.4f}; on {smi}")
    return launches, worst, t


def phase_relative_attention(seed):
    """Phase 15(b): RelativeMultiHeadAttention (E 32, 4 heads, 982x982,
    one event fully masked, the mask 0 where masked) on the card against
    the CPU, max-abs ≤ 1e-5 of max |CPU|, and its time: the one attention
    of the port that no kernel serves."""
    model = init_params(RelativeMultiHeadAttention(MODEL_DIM, HEADS),
                        torch.Generator().manual_seed(seed + 16)).eval()
    g = torch.Generator().manual_seed(seed + 16)
    q = torch.randn(EXTRAS_RELATIVE, NS, MODEL_DIM, generator=g)
    kv = torch.randn(EXTRAS_RELATIVE, NS, MODEL_DIM, generator=g)
    keep = torch.rand(EXTRAS_RELATIVE, 1, 1, NS, generator=g) >= 0.2
    keep[0] = False
    with torch.no_grad():
        cpu = model(q, kv, kv, keep)
        model.cuda()
        qc, kvc, keepc = q.cuda(), kv.cuda(), keep.cuda()
        card = model(qc, kvc, kvc, keepc)
        rel = _rel(card.cpu(), cpu)
        ms = time_ms(lambda: model(qc, kvc, kvc, keepc))
        dev, kernels, _ = device_kernels(lambda: model(qc, kvc, kvc, keepc), n=20)
    dh = MODEL_DIM // HEADS
    # q, k, v and the output [B, L, E] and the mask moved once; 8·hd flop per
    # (query, key, head): QKᵀ, Q·R_kᵀ, A·V and A·R_v
    b = bound(4 * EXTRAS_RELATIVE * NS * MODEL_DIM * 4 + EXTRAS_RELATIVE * NS,
              EXTRAS_RELATIVE * HEADS * NS * NS * 8 * dh, PEAK_FLOPS[torch.float32])
    log(15, f"(b) RelativeMultiHeadAttention [{EXTRAS_RELATIVE}, {NS}, {MODEL_DIM}], 4 heads, "
            f"masked (event 0 fully): card against CPU relative {rel:.3e}; {ms:.3f} ms per call "
            f"(CUDA events), device {dev:.3f} ms in {kernels} kernels, bound of the attention "
            f"alone {b[0]:.4f} ms ({b[1]}); no kernel serves it")
    assert card.shape == q.shape and bool(torch.isfinite(card).all())
    assert np.isfinite(rel) and rel <= 1e-5, rel
    return ms, dev


def phase_gumbel(seed):
    """Phase 15(c): GumbelSoftmax over the [8, 982, 32] tokens with a fixed
    generator on the card, and the CPU on the same draw: logits, probs and
    the soft and hard samples within 1e-5 of max |CPU|, the hard sample
    one-hot, its gradient the soft one's."""
    model = init_params(GumbelSoftmax(MODEL_DIM, 8), torch.Generator().manual_seed(seed + 17))
    x = torch.randn(8, NS, MODEL_DIM, generator=torch.Generator().manual_seed(seed + 17))
    model.cuda()
    u = torch.rand((8 * NS, 8), generator=torch.Generator("cuda").manual_seed(seed + 17),
                   device="cuda")
    a = model(x.cuda(), 0.5, False, generator=torch.Generator("cuda").manual_seed(seed + 17))
    assert torch.equal(a[2], model(x.cuda(), 0.5, False, u=u)[2])
    worst = 0.0
    for hard in (False, True):
        card = model(x.cuda(), 0.5, hard, u=u)
        cpu = copy.deepcopy(model).cpu()(x, 0.5, hard, u=u.cpu())
        worst = max(worst, *(_rel(c.detach().cpu(), p.detach()) for c, p in zip(card, cpu)))
        if hard:
            y = card[2].detach()  # (1 − y) + y may round off 1 by an ulp
            assert bool(((y == 0).sum(-1) == 7).all()) and bool(((y - 1).abs().amin(-1)
                                                                  <= 1e-6).all())
    w = torch.randn(8 * NS, 8, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    gs = [torch.autograd.grad((model(x.cuda(), 0.5, hard, u=u)[2] * w).sum(),
                              list(model.parameters())) for hard in (False, True)]
    st = max(_rel(h, s) for h, s in zip(gs[1], gs[0]))
    log(15, f"(c) GumbelSoftmax [{8 * NS}, 8] on the card against the CPU, the same draw: "
            f"worst relative {worst:.3e}; straight-through gradient against the soft one "
            f"{st:.3e}")
    assert np.isfinite(worst) and worst <= 1e-5, worst
    assert np.isfinite(st) and st <= 1e-5, st


def phase_reference_pickle(seed):
    """Phase 15(d): a stand-in whole-module reference pickle (class
    photospecMMVAE of a VAESNe package written under build/) of the
    flagship's weights under the reference's names, imported through
    import_reference_pickle into a PhotoSpecMMVAE on the card, bitwise the
    weights it was made from; crossmodal_ci at K = K_EXTRAS on the card
    against the CPU port on the same weights and pinned posterior noise,
    max-abs ≤ 1e-4 of max |CPU| (phase 5's serving gate). Returns the K1
    launches of the card's call."""
    root = os.path.join(SMOKE_DIR, "reference_pickle")
    shutil.rmtree(root, ignore_errors=True)
    pkg = os.path.join(root, "package")
    os.makedirs(os.path.join(pkg, "VAESNe"))
    with open(os.path.join(pkg, "VAESNe", "__init__.py"), "w"):
        pass
    with open(os.path.join(pkg, "VAESNe", "models.py"), "w") as f:
        f.write(STAND_IN)
    source = flagship(seed, dropout=0.0)
    sys.path.insert(0, pkg)
    try:
        from VAESNe import models as stand_in

        torch.save(stand_in.photospecMMVAE(torch_port.to_reference_state_dict(
            source.state_dict())), os.path.join(root, "model.pth"))
    finally:
        sys.path.remove(pkg)
        for name in [m for m in sys.modules if m == "VAESNe" or m.startswith("VAESNe.")]:
            del sys.modules[name]
    state = torch_port.import_reference_pickle(os.path.join(root, "model.pth"),
                                               package_path=pkg)
    assert all(t.device.type == "cuda" for t in state.values())
    model = flagship(seed + 1, dropout=0.0).cuda()
    model.load_state_dict(state, strict=True)
    assert all(torch.equal(v.cpu(), source.state_dict()[k]) for k, v in model.state_dict().items())
    n = 4
    photo, spec = make_batch(n, seed + 18)
    card = InferenceServer(model, buckets=BUCKETS, seed=seed)
    cpu = InferenceServer(source.eval(), buckets=BUCKETS, seed=seed, device="cpu")
    want = encoder_launches(0, BUCKETS[0]) + decoder_launches(1, K_EXTRAS * BUCKETS[0])
    with pinned_noise(seed + 18):
        reset_counts()
        got = card.crossmodal_ci(photo, spec, K=K_EXTRAS, alpha=0.1)
        torch.cuda.synchronize()
        launches = dict(zip(COUNTERS, kernel_counts()))
        ref = cpu.crossmodal_ci(photo, spec, K=K_EXTRAS, alpha=0.1)
    rel = max(_rel(a.cpu(), b) for a, b in zip(got, ref))
    log(15, f"(d) stand-in photospecMMVAE pickle → import_reference_pickle → PhotoSpecMMVAE on "
            f"the card (weights bitwise); crossmodal_ci K={K_EXTRAS} n={n}: K1 launches "
            f"{launches['K1']} (predicted {want}), card against CPU relative {rel:.3e}")
    assert launches["K1"] == want and launches["K2"] == 0, (launches, want)
    assert all(t.shape == (n, NS) and bool(torch.isfinite(t).all()) for t in got)
    assert np.isfinite(rel) and rel <= 1e-4, rel
    shutil.rmtree(root, ignore_errors=True)
    return launches["K1"]


def phase_extras(seed):
    """Phase 15, the extras and the reference migration. Returns the keys
    its kernels add to the kernels line, and the worst fp32 errors of (a)."""
    t_phase = time.perf_counter()
    launches, worst, t = phase_transformer_model(seed)
    rel_ms, rel_dev = phase_relative_attention(seed)
    phase_gumbel(seed)
    served = phase_reference_pickle(seed)
    log(15, f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    fwd, bwd = launches["forward"], launches["backward"]
    extra = {
        "attention_fwd": {"launches_extras": fwd["K1"] + served,
                          "ms_extras": t["fwd0"], "bound_ms_extras": t["b_f0"][0],
                          "plain_ms_extras": t["plain_f0"], "library_ms_extras": t["lib_f0"],
                          "relative_attention_ms": rel_ms,
                          "relative_attention_device_ms": rel_dev},
        "attention_fwd_dropout": {"launches_extras": bwd["K1 rate>0"],
                                  "ms_extras": t["fwd"], "bound_ms_extras": t["b_f"][0],
                                  "plain_ms_extras": t["plain_f"],
                                  "library_ms_extras": t["lib_f"]},
        "attention_bwd": {"launches_extras": bwd["K2"], "ms_extras": t["bwd"],
                          "bound_ms_extras": t["b_b"][0], "plain_ms_extras": t["plain_b"],
                          "library_ms_extras": t["lib_b"]},
    }
    return extra, worst


# -- the compute switches ------------------------------------------------------------

@contextlib.contextmanager
def switch(name, value):
    """The environment with ``name`` set to ``value`` for the block, as it
    was after it."""
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


@contextlib.contextmanager
def kernel_inputs(record):
    """Record the dtype of q at each K1 and K2 call and of loc at each K3
    call (sets under "K1", "K2", "K3"), and count the grid_loglik forwards
    on the card whose grid routes to K3 ("grids")."""
    fwd, bwd = attention.fused_attention_fwd, attention.fused_attention_bwd
    k3, grid = distributions.masked_laplace_loglik, distributions.MaskedGridLaplace.grid_loglik

    def fwd_spy(q, *args, **kwargs):
        record.setdefault("K1", set()).add(q.dtype)
        return fwd(q, *args, **kwargs)

    def bwd_spy(q, *args, **kwargs):
        record.setdefault("K2", set()).add(q.dtype)
        return bwd(q, *args, **kwargs)

    def k3_spy(loc, *args, **kwargs):
        record.setdefault("K3", set()).add(loc.dtype)
        return k3(loc, *args, **kwargs)

    def grid_spy(self, x):
        n = int(np.prod(self.loc.shape[2:]))
        record["grids"] = record.get("grids", 0) + (self.loc.is_cuda
                                                    and laplace_routes_to_kernel(n))
        return grid(self, x)

    attention.fused_attention_fwd, attention.fused_attention_bwd = fwd_spy, bwd_spy
    distributions.masked_laplace_loglik = k3_spy
    distributions.MaskedGridLaplace.grid_loglik = grid_spy
    try:
        yield
    finally:
        attention.fused_attention_fwd, attention.fused_attention_bwd = fwd, bwd
        distributions.masked_laplace_loglik = k3
        distributions.MaskedGridLaplace.grid_loglik = grid


def phase_bf16_driver(seed, fp32_rate, fp32_busy):
    """Phase 16(a): VAESNE_BF16=1 train_photospectra.main at the flagship
    widths for BF16_EPOCHS epochs: every epoch's launches equal phase 10's
    fp32 prediction (the precision changes no routing), K1 and K2 take bf16
    q, k, v and K3 bf16 loc, one K3 per routed grid_loglik forward; a copy
    of the run's epoch-2 checkpoint resumed to epoch 3 equals the run
    bitwise; the parameters and AdamW's moments are fp32; samples/s of
    epoch 2 and the busy share of the profiled epoch 3, beside phase 10's
    fp32 numbers. Returns the run's launches."""
    root = os.path.join(SMOKE_DIR, "bf16")
    shutil.rmtree(root, ignore_errors=True)
    dir_a, dir_b = os.path.join(root, "a"), os.path.join(root, "b")
    per_step = train_step_prediction(B_DRIVER, DROPOUT)
    prof = epoch_profiler()
    rates, mark, window, record = [], {}, {}, {}

    def on_epoch(epoch, state, loss):
        now, counts = time.perf_counter(), kernel_counts()
        steps = state.step - mark["step"]
        got = tuple(c - p for c, p in zip(counts, mark["counts"]))
        log(16, f"(a) bf16 epoch {epoch + 1}: loss {loss:.6f}, {steps} steps, "
                f"{now - mark['t']:.3f} s, launches {dict(zip(COUNTERS, got))}")
        assert np.isfinite(loss) and got == tuple(steps * w for w in per_step), (epoch, got)
        if epoch + 2 == BF16_EPOCHS:  # epoch 2: warm and unprofiled; its checkpoint resumes
            rates.append(B_DRIVER * steps / (now - mark["t"]))
            shutil.copytree(flagship_ckpt(dir_a), flagship_ckpt(dir_b))
            torch.cuda.synchronize()
            prof.start()
            window.update(t=time.perf_counter(), step=state.step)
        elif epoch + 1 == BF16_EPOCHS:
            window.update(wall_us=(now - window["t"]) * 1e6, steps=state.step - window["step"])
            prof.stop()
        mark.update(t=time.perf_counter(), counts=kernel_counts(), step=state.step)

    with switch("VAESNE_BF16", "1"):
        reset_counts()
        mark.update(t=time.perf_counter(), counts=kernel_counts(), step=0)
        captured = counters.captures
        with kernel_inputs(record):
            state_a, losses_a = train_photospectra.main(
                driver_args(seed, dir_a, f"train.epochs={BF16_EPOCHS}", "train.save_every=1"),
                callback=on_epoch)
        launches = dict(zip(COUNTERS, kernel_counts()))
        # the CUDA graph's replays rerun K3 without grid_loglik's Python: it
        # runs in the warm-up step and the capture of each graph alone
        captured = counters.captures - captured
        python_steps = 2 * captured if captured else launches["K3"] // per_step[3]
        state_b, losses_b = train_photospectra.main(driver_args(
            seed, dir_b, f"train.epochs={BF16_EPOCHS}", "train.resume=true", "train.save_every=1"))
    log(16, f"(a) main path (VAESNE_BF16=1 train_photospectra, {BF16_EPOCHS} epochs): launches "
            f"{launches}; K1 q {record['K1']}, K2 q {record['K2']}, K3 loc {record['K3']}; "
            f"{record['grids']} routed grid_loglik forwards in the {python_steps} steps that ran "
            f"them ({per_step[3]} K3 a step)")
    assert record["K1"] == record["K2"] == record["K3"] == {torch.bfloat16}, record
    assert record["grids"] == python_steps * per_step[3] > 0, (record["grids"], python_steps)
    bitwise = losses_b == losses_a and state_b.step == state_a.step and all(
        torch.equal(x, y) for x, y in zip(state_a.model.parameters(), state_b.model.parameters()))
    moments = [t for st in state_a.optimizer.state.values() for t in st.values()
               if torch.is_tensor(t) and t.dim() > 0]
    fp32 = all(p.dtype == torch.float32 for p in state_a.model.parameters()) and moments and all(
        t.dtype == torch.float32 for t in moments)
    log(16, f"(a) epoch 2's checkpoint resumed to {BF16_EPOCHS} against the run: losses "
            f"{losses_b} vs {losses_a}, bitwise equal {bitwise}; parameters and AdamW moments "
            f"fp32 {fp32}")
    assert bitwise and fp32
    busy = report_profile(prof, window["wall_us"], 1, f"epoch {BF16_EPOCHS} of VAESNE_BF16=1 "
                          f"train_photospectra.main ({window['steps']} steps)", top=10, phase=16)
    (rate,) = rates
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(16, f"(a) bf16 driver: epoch 2 {rate:.1f} samples/s (fp32, phase 10: median of epochs "
            f"2-{DRIVER_EPOCHS} {fp32_rate:.1f}); device busy "
            f"{busy:.1%} of the profiled epoch (fp32, phase 10: {fp32_busy:.1%}); on {smi}")
    return launches


def phase_remat_off(seed):
    """Phase 16(b): bench.py's setting, the B = 192 m-IWAE step with
    VAESNE_REMAT=0, in bf16 and fp32, against remat on from the same
    weights: launches per step as train_step_prediction(remat=False) (K1 at
    rate 0.1 once a routed grid, with no re-run; K2 unchanged), the first
    step's loss and every gradient bitwise remat on's; samples/s (median of
    steps 2-REMAT_STEPS) and peak memory both ways. Returns the remat-off
    bf16 step's launches."""
    batch = to_device(make_batch(B_TRAIN, seed + 10), torch.device("cuda"))
    per_step = {}
    for precision in ("bf16", "fp32"):
        first, numbers = {}, {}
        for remat in ("1", "0"):
            with switch("VAESNE_REMAT", remat):
                model = flagship(seed)
            stacks = [m for m in model.modules() if isinstance(m, layers.TransformerStack)]
            assert stacks and all(m.remat == (remat == "1") for m in stacks)
            want = train_step_prediction(B_TRAIN, DROPOUT, remat=remat == "1")
            opt = adamw(LR)
            state = TrainState.create(model, opt, seed=seed)
            step = make_train_step(model, opt, m_iwae_loss, precision=precision)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for i in range(REMAT_STEPS):
                before = kernel_counts()
                t0 = time.perf_counter()
                state, loss = step(state, batch)
                loss_v = loss.item()
                times.append(time.perf_counter() - t0)
                got = tuple(b - a for a, b in zip(before, kernel_counts()))
                assert np.isfinite(loss_v) and got == want, (precision, remat, i, got, want)
                if i == 0:
                    first[remat] = [loss.detach().clone()] + [
                        p.grad.clone() for p in model.parameters() if p.grad is not None]
            med = statistics.median(times[1:])
            numbers[remat] = (B_TRAIN / med, torch.cuda.max_memory_allocated() / 2**20)
            if remat == "0":
                per_step[precision] = dict(zip(COUNTERS, got))
            log(16, f"(b) {precision} step, VAESNE_REMAT={remat}: launches per step "
                    f"{dict(zip(COUNTERS, got))} (predicted {dict(zip(COUNTERS, want))}); median "
                    f"of steps 2-{REMAT_STEPS} {med * 1e3:.2f} ms = {B_TRAIN / med:.1f} samples/s; "
                    f"peak memory {numbers[remat][1]:.0f} MiB")
            del model, state, step, opt
            torch.cuda.empty_cache()
        same = len(first["1"]) == len(first["0"]) > 1 and all(
            torch.equal(a, b) for a, b in zip(first["1"], first["0"]))
        log(16, f"(b) {precision}: remat off against on, the first step's loss and "
                f"{len(first['0']) - 1} gradients bitwise equal {same}; samples/s "
                f"{numbers['0'][0]:.1f} off, {numbers['1'][0]:.1f} on; peak memory "
                f"{numbers['0'][1]:.0f} MiB off, {numbers['1'][1]:.0f} MiB on")
        assert same
    return per_step["bf16"]


def phase_bf16_eval(fp32_events_s):
    """Phase 16(c): VAESNE_BF16=1 eval_goldstein at K = 100 on the bridged
    flagship, a warm call and a timed one: K1 takes bf16 q with phase 11's
    launches per chunk; phase 11's gates against artifacts/eval/ (a miss
    is reported as a finding, not a failure of this script); events/s
    beside phase 11's fp32. Returns the K1 launches."""
    out = os.path.join(SMOKE_DIR, "eval_bf16")
    shutil.rmtree(out, ignore_errors=True)
    record, failures = {}, []
    n_test = len(resolve_dataset(None)["testing_idx"])
    reset_counts()
    with switch("VAESNE_BF16", "1"), kernel_inputs(record):
        eval_goldstein.main([f"mm_ckpt={EVAL_CKPT}", f"K={K_EVAL}",
                             f"out={os.path.join(out, 'warm')}"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = eval_goldstein.main([f"mm_ckpt={EVAL_CKPT}", f"K={K_EVAL}",
                                       f"out={os.path.join(out, 'timed')}"])
        wall = time.perf_counter() - t0
    want = 2 * -(-n_test // SUITE_CHUNK) * suite_chunk_prediction(SUITE_CHUNK)
    launches = dict(zip(COUNTERS, kernel_counts()))
    log(16, f"(c) main path (VAESNE_BF16=1 eval_goldstein twice): launches {launches} "
            f"(K1 predicted {want}); K1 q {record.get('K1')}")
    assert launches["K1"] == want and record.get("K1") == {torch.bfloat16}, (launches, record)
    assert all(np.isfinite(metrics[k]).any() for k in ("mm_mse", "mm_coverage_mean"))
    eval_gates("(c) VAESNE_BF16=1 eval_goldstein K=100", metrics, EVAL_REF["latent"], failures,
               phase=16)
    if failures:
        log(16, f"(c) FINDING: bf16 evaluation misses phase 11's gates {failures} (reported, "
                f"not a failure of this script: ROADMAP Queue 3)")
    log(16, f"(c) bf16 eval_goldstein K={K_EVAL} on {n_test} test events: wall {wall:.3f} s, "
            f"{n_test / wall:.1f} events/s (fp32, phase 11: {fp32_events_s:.1f})")
    return launches["K1"]


def mask_marginals_check(rows=8, length=NS, phase=16):
    """K1's and K2's dropout masks against the plain mask at the current
    width: with q = k = 0 every weight is 1/Lk, so with v = 1 K1's output at
    (row, query, head) is #kept in that query's row over Lk(1 − rate), and
    with dout = 1 K2's dv at (row, key, head) is #kept in that key's column
    over Lk(1 − rate); both counts must be the plain mask's."""
    z = torch.zeros(rows, length, MODEL_DIM, device="cuda")
    ones = torch.ones_like(z)
    out, m, l = attention.fused_attention_fwd(z, z, ones, None, HEADS, DROPOUT, 77)
    _, _, dv = attention.fused_attention_bwd(z, z, ones, None, out, m, l, ones, HEADS, DROPOUT,
                                             77)
    keep = attention.dropout_keep(77, rows, HEADS, length, length, DROPOUT, "cuda")
    scale = length * (1.0 - DROPOUT)

    def counts(t):  # [R, L, E] -> [R, H, L], the first column of each head
        return (t.reshape(rows, length, HEADS, -1)[..., 0] * scale).round().permute(0, 2, 1)

    same_rows = torch.equal(counts(out), keep.sum(-1).float())
    same_cols = torch.equal(counts(dv), keep.sum(-2).float())
    log(phase, f"(d) w = {attention.dropout_bits()}: K1's kept count per query and K2's per key "
               f"equal the plain mask's: {same_rows}, {same_cols}")
    assert same_rows and same_cols


def phase_dropout_widths():
    """Phase 16(d): VAESNE_DROPOUT_BITS=16 and 32 at phase 9's R = 768
    inputs, rate 0.1: K1 and K2 against their plain versions with phase 3's
    gates in fp32 and bf16, their times beside phase 9's at 8 bits, the
    keep rate 1 − round(2ʷ·0.1)/2ʷ within 4σ and the forward's and
    backward's masks the plain mask. Returns {(kernel, dtype, w): ms}."""
    rows, chunk, dseed = M * K_TRAIN * B_TRAIN, 64, 5
    q, k, v, mask = attention_inputs(rows, NS, NS, True, seed=8, full_row=True)
    dout = randn_like(q, 42)
    slices = chunk_slices(rows, chunk)
    times = {}
    for w in (16, 32):
        with switch("VAESNE_DROPOUT_BITS", str(w)):
            want_out = torch.cat([attention.attention_reference(
                q[s], k[s], v[s], mask[s], HEADS, DROPOUT, chunk_seed(dseed, s)) for s in slices])
            want_grads = [torch.cat(g) for g in zip(*[attention.attention_backward_reference(
                q[s], k[s], v[s], mask[s], dout[s], HEADS, DROPOUT, chunk_seed(dseed, s))
                for s in slices])]
            for dtype in (torch.float32, torch.bfloat16):
                qd, kd, vd, dd = (t.to(dtype) for t in (q, k, v, dout))
                out, m, l = attention.fused_attention_fwd(qd, kd, vd, mask, HEADS, DROPOUT, dseed)
                grads = attention.fused_attention_bwd(qd, kd, vd, mask, out, m, l, dd, HEADS,
                                                      DROPOUT, dseed)
                torch.cuda.synchronize()
                rel = [_rel(out, want_out)] + [_rel(g, t) for g, t in zip(grads, want_grads)]
                err_f = (out.float() - want_out).abs().max().item()
                times[("fwd", dtype, w)] = time_ms(lambda: attention.fused_attention_fwd(
                    qd, kd, vd, mask, HEADS, DROPOUT, dseed))
                times[("bwd", dtype, w)] = time_ms(lambda: attention.fused_attention_bwd(
                    qd, kd, vd, mask, out, m, l, dd, HEADS, DROPOUT, dseed))
                name = str(dtype).split(".")[-1]
                log(16, f"(d) VAESNE_DROPOUT_BITS={w} R={rows} 982x982 {name} rate 0.1 against "
                        f"the plain versions: K1 max-abs {err_f:.3e} (rel {rel[0]:.2e}); K2 dq, "
                        f"dk, dv rel " + ", ".join(f"{e:.2e}" for e in rel[1:])
                        + f"; K1 {times[('fwd', dtype, w)]:.3f} ms, K2 "
                        f"{times[('bwd', dtype, w)]:.3f} ms")
                assert all(np.isfinite(e) for e in rel), (w, name, rel)
                if dtype == torch.float32:
                    assert err_f <= 1e-5 and all(e <= 1e-4 for e in rel[1:]), (w, err_f, rel)
                else:
                    assert all(e <= 2e-2 for e in rel), (w, rel)
                del out, m, l, grads, qd, kd, vd, dd
            keep_rate_check(phase=16)
            mask_marginals_check()
            del want_out, want_grads
            torch.cuda.empty_cache()
    del q, k, v, mask, dout
    torch.cuda.empty_cache()
    return times


def phase_queue3():
    """Phase 16(e): the port's K2 in bf16 (after K1 in bf16, whose output
    feeds the row term) and in fp32 on Queue 3's near-uniform input, against
    the plain version in fp32 on the same bf16-grid values, beside the JAX
    kernel's bf16 error on that input (committed, from the CPU). There dq is
    a small difference of large terms: the keys share one large mean, and
    dq = Σ p(dp − D)(k − k̄) + k̄·Σ p(dp − D), whose second sum is 0 in exact
    arithmetic, so round-off in D = Σ dout·o reaches dq multiplied by |k̄|.
    The fp32 kernel's dk and dv hold phase 3's gate; dq in fp32 and bf16 is
    printed, not gated. Returns {rate: [dq, dk, dv] relative bf16 errors}."""
    with open(QUEUE3) as f:
        committed = json.load(f)["jax_dq_dk_dv"]
    q, k, v, dout, mask = (torch.from_numpy(a).cuda() for a in near_uniform_attention_inputs())
    res = {}
    for rate, seed in (("0", None), ("0.1", 1302)):
        r = float(rate)
        want = attention.attention_backward_reference(q, k, v, mask, dout, HEADS, r, seed)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            qd, kd, vd, dd = (t.to(dtype) for t in (q, k, v, dout))
            out, m, l = attention.fused_attention_fwd(qd, kd, vd, mask, HEADS, r, seed)
            grads = attention.fused_attention_bwd(qd, kd, vd, mask, out, m, l, dd, HEADS, r, seed)
            torch.cuda.synchronize()
            errs[dtype] = [_rel(g, t) for g, t in zip(grads, want)]
        log(16, f"(e) Queue 3 input [{QUEUE3_ROWS}, {CONTEXT}, {MODEL_DIM}] rate {rate}: the "
                f"port's K2 dq, dk, dv relative to the fp32 plain version: bf16 "
                + ", ".join(f"{e:.3e}" for e in errs[torch.bfloat16]) + "; fp32 "
                + ", ".join(f"{e:.3e}" for e in errs[torch.float32]) + "; the JAX kernel in "
                "bf16 against its fp32 run (interpret mode, CPU): "
                + ", ".join(f"{e:.3e}" for e in committed[rate]) + " (bf16 gate 2e-2)")
        assert all(np.isfinite(e) for e in errs[torch.bfloat16] + errs[torch.float32]), errs
        assert all(e <= 1e-4 for e in errs[torch.float32][1:]), errs
        res[rate] = errs[torch.bfloat16]
    return res


def vae_part_launches(vae, n, rows, part):
    """K1 launches of one encode or decode of ``vae`` over ``rows`` rows of
    an n-point grid at its own widths: per layer a self-attention and a
    cross-attention, as stack_launches counts them (a spectrum's context
    carries the phase token)."""
    spectra = isinstance(vae, SpectraVAE)
    tower = vae.enc if part == "encode" else vae.dec
    stack = next(m for m in tower.modules() if isinstance(m, layers.TransformerStack))
    heads = stack.block_0.self_attn.num_heads
    lq, lc = ((2 * vae.latent_len, n + spectra) if part == "encode"
              else (n, vae.latent_len + spectra))
    return stack.num_layers * (int(routes_to_kernel(rows, heads, lq, lq))
                               + int(routes_to_kernel(rows, heads, lq, lc)))


def phase_bridged_checkpoints():
    """Phase 16(f): the four newly bridged checkpoints through
    InferenceServer.from_checkpoint on the card: each modality's embed and
    posterior-mean decode of REFERENCE_EVENTS events within 1e-4 of max
    |JAX| (jax_reference.npz beside each), K1's launches as the dispatch
    rule predicts (the 982x982 spectra decoder routes at any R). Returns
    the K1 launches."""
    from vaesne_tpu_torch import data as tdata

    total = 0
    for name, (kind, builder) in BRIDGED_VAES.items():
        path = os.path.join("artifacts", "ckpt_torch", name)
        ref = np.load(os.path.join(path, "jax_reference.npz"))
        maker = tdata.make_goldstein_like if kind == "goldstein" else tdata.make_ztf_like
        n_events = REFERENCE_EVENTS["n"]
        x = getattr(tdata, builder)(maker(**REFERENCE_EVENTS), idx=np.arange(n_events),
                                    device="cpu")
        server = InferenceServer.from_checkpoint(path, buckets=(n_events,))
        multimodal = builder == "multimodal_tuple"
        for m, xm in enumerate(x if multimodal else (x,)):
            vae = server.model.vaes[m] if multimodal else server.model
            n = xm[0].shape[-1]
            want = sum(vae_part_launches(vae, n, n_events, part) for part in ("encode", "decode"))
            assert not isinstance(vae, SpectraVAE) or vae_part_launches(
                vae, n, 1, "decode") == vae.dec.blocks.num_layers, name
            before = attention.launches
            z = server.embed(tuple(a.numpy() for a in xm), modality=m)
            with torch.inference_mode():
                loc = vae.decode(z[None], to_device(xm, torch.device("cuda"))).loc[0]
            torch.cuda.synchronize()
            got = attention.launches - before
            errs = [np.abs(t.cpu().numpy() - ref[f"{key}_{m}"]).max()
                    / np.abs(ref[f"{key}_{m}"]).max() for key, t in (("embed", z), ("decode", loc))]
            log(16, f"(f) {name} modality {m} ({vae.modality_name}, {n} points): embed and "
                    f"posterior-mean decode within {errs[0]:.3e}, {errs[1]:.3e} of max |JAX| "
                    f"(gate 1e-4); K1 launches {got} (predicted {want})")
            assert all(e <= 1e-4 for e in errs) and got == want, (name, m, errs, got, want)
            total += got
    return total


def phase_switches(seed, fp32_rate=float("nan"), fp32_busy=float("nan"),
                   fp32_events_s=float("nan")):
    """Phase 16: the JAX package's compute switches, each set for its own
    sub-phase and restored after it. Returns the keys it adds to the
    kernels line."""
    t_phase = time.perf_counter()
    spent = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        spent[label] = time.perf_counter() - t0
        return out

    drivers = timed("a", phase_bf16_driver, seed, fp32_rate, fp32_busy)
    remat0 = timed("b", phase_remat_off, seed)
    eval_k1 = timed("c", phase_bf16_eval, fp32_events_s)
    widths = timed("d", phase_dropout_widths)
    queue3 = timed("e", phase_queue3)
    bridged = timed("f", phase_bridged_checkpoints)
    assert not any(name in os.environ for name in SWITCHES)
    log(16, f"phase 16 took {time.perf_counter() - t_phase:.1f} s: "
            + ", ".join(f"({k}) {v:.1f} s" for k, v in spent.items()))
    f32, b16 = torch.float32, torch.bfloat16
    by_width = {kind: {f"ms{d}_w{w}": widths[(kind, dt, w)] for w in (16, 32)
                       for dt, d in ((f32, ""), (b16, "_bf16"))} for kind in ("fwd", "bwd")}
    return {
        "attention_fwd": {"launches_drivers_bf16": drivers["K1"] - drivers["K1 rate>0"],
                          "launches_step_remat0": remat0["K1"] - remat0["K1 rate>0"],
                          "launches_eval_bf16": eval_k1, "launches_bridged": bridged},
        "attention_fwd_dropout": {"launches_drivers_bf16": drivers["K1 rate>0"],
                                  "launches_step_remat0": remat0["K1 rate>0"], **by_width["fwd"]},
        "attention_bwd": {"launches_drivers_bf16": drivers["K2"],
                          "launches_step_remat0": remat0["K2"], **by_width["bwd"],
                          "queue3_dq_rel_bf16": queue3["0.1"][0],
                          "queue3_dq_rel_bf16_rate0": queue3["0"][0]},
        "laplace_fwd": {"launches_drivers_bf16": drivers["K3"],
                        "launches_step_remat0": remat0["K3"]},
        "laplace_bwd": {"launches_drivers_bf16": drivers["K4"],
                        "launches_step_remat0": remat0["K4"]},
    }


# -- the CUDA graph of the train step (train.scan_epoch) --------------------------

GRAPH_EPOCHS = 3  # epoch 1 holds the warm-up step and the capture, 2 is timed, 3 profiled
GRAPH_STEPS = 4   # steps an epoch of the B = 192 step's runs


def _state_tensors(state):
    """The parameters, then every tensor of AdamW's state (moments and step
    counts), in order."""
    return [*state.model.parameters(), *(t for st in state.optimizer.state.values()
                                         for t in st.values() if torch.is_tensor(t))]


def _same_state(a, b):
    """True where two TrainStates hold bitwise the same parameters, AdamW
    state, step and generator."""
    ta, tb = _state_tensors(a), _state_tensors(b)
    return (a.step == b.step and len(ta) == len(tb) and torch.equal(a.generator.get_state(),
                                                                   b.generator.get_state())
            and all(torch.equal(x, y) for x, y in zip(ta, tb)))


def loop_pair(seed, label, main, argv, per_step, batch_size, epochs, profile=False,
              resume=False, hold=False, phase=17, length=NS):
    """``main(argv)`` with train.scan_epoch=true (the graph) and false (the
    step loop), from one seed: each epoch's launches against ``per_step``;
    epoch 2's samples/s (host clock from one epoch's end to the next, the
    save included; ``batch_size`` events a step), epoch 3's busy share
    (``profile``: device activity alone) and the run's peak memory; each
    run's launches; the two runs' parameters, AdamW state, step,
    generator and losses bitwise equal; with ``resume`` the graph run's
    epoch-2 checkpoint resumed under the graph to ``epochs``, bitwise the
    graph run. Inside a rank of a mesh (``argv`` names it in train.mesh)
    rank 0, which leads the run, alone runs the callback's checks, times and
    profile (of its own kernels), every rank checks the bitwise
    equalities, and each run's numbers carry the per-rank ``table``
    (``_rank_table``: the run's launches; with ``hold`` each rank's K1/K2
    held on the graph's last replayed step's ``length``x``length`` input
    with its shard seed). Returns {"graph": numbers, "eager": numbers}."""
    mesh = parallel.current_mesh()
    lead = parallel.mesh.rank() == 0
    out, states = {}, {}
    base = os.path.join(SMOKE_DIR, "graph", "".join(ch if ch.isalnum() else "_" for ch in label))
    if lead:
        shutil.rmtree(base, ignore_errors=True)
    if mesh is not None:
        torch.distributed.barrier()
    for scan, name in (("true", "graph"), ("false", "eager")):
        root = os.path.join(base, name)
        prof = epoch_profiler() if profile and lead else None
        mark, times, window = {}, [], {}

        def on_epoch(epoch, state, loss):
            now, counts = time.perf_counter(), kernel_counts()
            steps = state.step - mark["step"]
            got = tuple(c - p for c, p in zip(counts, mark["counts"]))
            log(phase, f"{label} {name} epoch {epoch + 1}: loss {loss:.6f}, {steps} steps, "
                       f"{now - mark['t']:.3f} s, launches {dict(zip(COUNTERS, got))}")
            assert np.isfinite(loss) and got == tuple(steps * w for w in per_step), (got, steps)
            times.append((now - mark["t"], steps))
            if epoch == 1 and resume and name == "graph":
                shutil.copytree(root, os.path.join(base, "resumed"))
            if prof is not None and epoch == 1:
                torch.cuda.synchronize()
                prof.start()
                window.update(t=time.perf_counter())
            elif prof is not None and epoch == 2:
                window.update(wall_us=(now - window["t"]) * 1e6)
                prof.stop()
            mark.update(t=time.perf_counter(), counts=kernel_counts(), step=state.step)

        store = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        captured, start = counters.captures, kernel_counts()
        mark.update(t=time.perf_counter(), counts=start, step=0)
        with capture_graph_kernel_input(store, length) if hold and name == "graph" else (
                contextlib.nullcontext()):
            state, losses = main([*argv, *driver_args(seed, root, f"train.epochs={epochs}",
                                                       "train.save_every=1",
                                                       f"train.scan_epoch={scan}")],
                                 callback=on_epoch)
        captured = counters.captures - captured
        launches = tuple(b - a for a, b in zip(start, kernel_counts()))
        assert captured == (name == "graph"), (name, captured)  # one graph, kept across epochs
        numbers = dict(peak=torch.cuda.max_memory_allocated() / 2**20, losses=losses,
                       steps=state.step, launches=dict(zip(COUNTERS, launches)),
                       rate=batch_size * times[1][1] / times[1][0] if lead and epochs > 1
                       else None)
        if prof is not None:
            numbers["busy"] = report_profile(prof, window["wall_us"], 1,
                                             f"{label} {name}, epoch 3", top=8, phase=phase)
        if mesh is not None:
            numbers["table"] = _rank_table(launches, store, numbers["peak"], phase)
        out[name], states[name] = numbers, state
        if lead:
            log(phase, f"{label} {name}: losses {losses}; peak memory {numbers['peak']:.0f} MiB"
                       + (f"; epoch 2 {numbers['rate']:.1f} samples/s" if epochs > 1 else ""))
    bitwise = [out["graph"]["losses"] == out["eager"]["losses"]
               and _same_state(states["graph"], states["eager"])]
    if resume:
        state, losses = main([*argv, *driver_args(seed, os.path.join(base, "resumed"),
                                                   f"train.epochs={epochs}", "train.resume=true",
                                                   "train.save_every=1")])
        bitwise.append(losses == out["graph"]["losses"] and _same_state(state, states["graph"]))
    ranks = [bitwise] if mesh is None else all_ranks([float(b) for b in bitwise])
    if lead:
        log(phase, f"{label}: graph against the step loop, parameters, AdamW state, step, "
                   f"generator and losses bitwise equal {[bool(row[0]) for row in ranks]} (a "
                   f"rank each; max-abs difference over max |param| "
                   f"{_params_rel(states['graph'].model, states['eager'].model):.3e})"
                   + (f"; the graph run's epoch-2 checkpoint resumed to {epochs} under the "
                      f"graph bitwise the run {[bool(row[1]) for row in ranks]}"
                      if resume else ""))
    assert all(all(row) for row in ranks), (label, ranks)
    return out


def graph_step_pair(seed, precision, remat):
    """bench.py's B = 192 m-IWAE step (K = 2, dropout 0.1, AdamW 1e-4, clip
    10) at ``precision`` with VAESNE_REMAT=``remat``, as make_scan_epoch
    epochs of GRAPH_STEPS steps over GRAPH_STEPS·192 events, the graph
    against the step loop from the same weights: launches per step as
    train_step_prediction, epoch 2's samples/s (host clock, ending in the
    epoch's one sync), epoch 3's busy share, peak memory, and the two runs
    bitwise equal. Returns {"graph": numbers, "eager": numbers}."""
    data = to_device(make_batch(GRAPH_STEPS * B_TRAIN, seed + 11), torch.device("cuda"))
    want = train_step_prediction(B_TRAIN, DROPOUT, remat=remat == "1")
    out, states = {}, {}
    for graph, name in ((True, "graph"), (False, "eager")):
        with switch("VAESNE_REMAT", remat):
            model = flagship(seed)
        opt = adamw(LR)
        state = TrainState.create(model, opt, seed=seed)
        run = training.make_scan_epoch(model, opt, m_iwae_loss, precision=precision, graph=graph)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        numbers, prof = {}, epoch_profiler()
        for epoch in range(GRAPH_EPOCHS):
            before = kernel_counts()
            if epoch == 2:
                prof.start()
            t0 = time.perf_counter()
            state, loss = run(state, data, torch.Generator().manual_seed(epoch), B_TRAIN)
            wall = time.perf_counter() - t0
            got = tuple(b - a for a, b in zip(before, kernel_counts()))
            assert np.isfinite(loss) and got == tuple(GRAPH_STEPS * w for w in want), (got, want)
            if epoch == 1:
                numbers["rate"] = GRAPH_STEPS * B_TRAIN / wall
            elif epoch == 2:
                prof.stop()
                numbers["busy"] = report_profile(
                    prof, wall * 1e6, GRAPH_STEPS, f"B = {B_TRAIN} step {precision} "
                    f"VAESNE_REMAT={remat} {name}", top=6, phase=17)
        numbers["peak"] = torch.cuda.max_memory_allocated() / 2**20
        out[name], states[name] = numbers, state
        log(17, f"(c) B = {B_TRAIN} step, {precision}, VAESNE_REMAT={remat}, {name}: "
                f"{numbers['rate']:.1f} samples/s (epoch 2, {GRAPH_STEPS} steps), busy "
                f"{numbers['busy']:.1%} of epoch 3, peak memory {numbers['peak']:.0f} MiB; "
                f"launches per step {dict(zip(COUNTERS, want))}")
        del model, opt, run
        torch.cuda.empty_cache()
    same = _same_state(states["graph"], states["eager"])
    log(17, f"(c) B = {B_TRAIN} step, {precision}, VAESNE_REMAT={remat}: graph against the "
            f"step loop bitwise equal {same} after {GRAPH_EPOCHS} epochs")
    assert same
    return out


def phase_graph(seed):
    """Phase 17: train.scan_epoch, one CUDA graph of the train step per
    geometry, replayed at every step after a warm-up step, against the step
    loop (train.scan_epoch=false), bitwise: (a) the flagship driver
    (train_photospectra, B = 16, K = 2, dropout 0.1, 25 steps an epoch) in
    fp32 over GRAPH_EPOCHS epochs, its epoch-2 checkpoint resumed under the
    graph, then in bf16 and with train.accum_steps=2 (one epoch on
    small_dataset), every epoch's launches phase 10's prediction; (b)
    train_image (fp32, then a bf16 run resumed from its epoch-2
    checkpoint), train_contrastive (the defaults, then
    model.selfattn=true) and a frozen-backbone train_regression; (c)
    samples/s, busy share and peak memory of graph and step loop for the
    B = 16 driver in fp32 and bf16, bench.py's B = 192 step in fp32 and bf16
    with remat on and off, train_image and train_contrastive. Returns the
    keys it adds to the kernels line."""
    t_phase = time.perf_counter()
    per_step = train_step_prediction(B_DRIVER, DROPOUT)
    res = {}
    res["driver fp32"] = loop_pair(seed, "(a) driver fp32", train_photospectra.main, [], per_step,
                                   B_DRIVER, GRAPH_EPOCHS, profile=True, resume=True)
    with switch("VAESNE_BF16", "1"):
        res["driver bf16"] = loop_pair(seed, "(a) driver bf16", train_photospectra.main, [],
                                       per_step, B_DRIVER, GRAPH_EPOCHS, profile=True)
    accum = tuple(2 * w for w in train_step_prediction(B_DRIVER // 2, DROPOUT))
    loop_pair(seed, "(a) driver accum 2", train_photospectra.main,
              ["train.accum_steps=2", f"data={small_dataset(seed)}"], accum, B_DRIVER, 1)
    t_a = time.perf_counter() - t_phase

    image_cfg = train_image.parse_image_cli([])[2]
    res["image"] = loop_pair(seed, "(b) train_image", train_image.main, [],
                             image_step_prediction(image_cfg), image_cfg.train.batch_size,
                             GRAPH_EPOCHS, profile=True)
    with switch("VAESNE_BF16", "1"):
        loop_pair(seed, "(b) train_image bf16", train_image.main, [],
                  image_step_prediction(image_cfg), image_cfg.train.batch_size, GRAPH_EPOCHS,
                  resume=True)
    contra = ContrastiveConfig()
    res["contrastive"] = loop_pair(seed, "(b) train_contrastive", train_contrastive.main, [],
                                   contrastive_step_prediction(contra), B_CONTRA, GRAPH_EPOCHS,
                                   profile=True)
    selfattn = parse_overrides(contra, ["model.selfattn=true"])
    loop_pair(seed, "(b) train_contrastive selfattn", train_contrastive.main,
              ["model.selfattn=true"], contrastive_step_prediction(selfattn), B_CONTRA, 1)
    loop_pair(seed, "(b) train_regression frozen mmvae", train_regression.main,
              ["modality=photometry", "backbone=mmvae", f"backbone_ckpt={EVAL_CKPT}"],
              regression_step_prediction("photometry", "mmvae"), B_CONTRA, 1)
    t_b = time.perf_counter() - t_phase - t_a

    for precision in ("fp32", "bf16"):
        for remat in ("1", "0"):
            res[f"step {precision} remat {remat}"] = graph_step_pair(seed, precision, remat)
    t_c = time.perf_counter() - t_phase - t_a - t_b
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    for name, r in res.items():
        g, e = r["graph"], r["eager"]
        log(17, f"(c) {name}: graph {g['rate']:.1f} against the step loop {e['rate']:.1f} "
                f"samples/s ({g['rate'] / e['rate']:.2f}x); busy {g['busy']:.1%} against "
                f"{e['busy']:.1%}; peak memory {g['peak']:.0f} against {e['peak']:.0f} MiB; "
                f"on {smi}")
    log(17, f"phase 17 took {time.perf_counter() - t_phase:.1f} s: (a) {t_a:.1f} s, (b) "
            f"{t_b:.1f} s, (c) {t_c:.1f} s")
    launches = res["driver fp32"]["graph"]["launches"]
    return {"attention_fwd": {"launches_graph": launches["K1"] - launches["K1 rate>0"]},
            **{name: {"launches_graph": launches[c]}
               for name, c in (("attention_fwd_dropout", "K1 rate>0"), ("attention_bwd", "K2"),
                               ("laplace_fwd", "K3"), ("laplace_bwd", "K4"))}}


# -- the data-parallel CUDA graph of the train step (train.scan_epoch under train.mesh) -



@contextlib.contextmanager
def capture_graph_kernel_input(store, length=NS):
    """During a CUDA graph's capture, turn each K1 seed at a rate above 0
    into the graph's seed word before the call (the word the call would
    take; the host rewrites it before each replay) and keep the first
    ``length``x``length`` call's input as clones made inside the graph, so
    that every replay refills them with its step's input: after a run, (q,
    k, v, mask, heads, rate, word) hold its last step's input and the
    rank's shard seed."""
    real = layers.fused_attention

    def capturing(q, k, v, mask, heads, rate, seed):
        if rate > 0 and torch.cuda.is_current_stream_capturing():
            seed = rng.seed_word(seed, q.device)
            if not store and q.shape[1] == k.shape[1] == length:
                store.extend((q.detach().clone(), k.detach().clone(), v.detach().clone(),
                              None if mask is None else mask.clone(), heads, rate, seed))
        return real(q, k, v, mask, heads, rate, seed)

    layers.fused_attention = capturing
    try:
        yield
    finally:
        layers.fused_attention = real


def _rank_table(counts, store, peak, phase=18):
    """Every rank's row in phase 14's layout (``_check_launches``,
    ``_check_masks``): launches, then the K1 seed, rows, heads and keep
    rate of the held input ``store`` (``capture_graph_kernel_input``), peak
    memory, no time, and K1/K2's errors held on that input with that seed
    (-1 where nothing was held)."""
    seed_k1, rows_k1, heads_k1, keep, errs = -1, 0, 0, (0.0, 0.0), [-1.0, -1.0, -1.0]
    if store:
        q, k, v, mask, heads, rate, word = store
        seed_k1, rows_k1, heads_k1 = int(word.item()) & 0xFFFFFFFF, q.shape[0], heads
        if q.dtype == torch.bfloat16:
            held = hold_rank_kernels(q, k, v, mask, heads, rate, seed_k1, phase=phase)
            log(phase, f"rank {parallel.mesh.rank()}: bf16 K1/K2 on the last replayed step's input "
                    f"against the plain versions: forward rel {held[3]:.2e} (gate 2e-2), dq, "
                    f"dk, dv rel " + ", ".join(f"{e:.2e}" for e in held[2])
                    + " (dk, dv gate 2e-2; dq: Queue 3)")
            q, k, v = q.float(), k.float(), v.float()  # the masks, at the fp32 gates
        held = hold_rank_kernels(q, k, v, mask, heads, rate, seed_k1, phase=phase)
        errs = [held[0], held[1], max(held[2])]
        keep = rank_keep_rate(seed_k1, heads)
    return all_ranks([*counts, seed_k1, rows_k1, heads_k1, *keep, peak, 0.0, *errs])


def rank_step_pair(seed):
    """bench.py's B = 192 m-IWAE step over this rank's mesh (96 events a
    rank on two), as make_scan_epoch epochs of GRAPH_STEPS steps, the DP
    graph against the DDP step loop from the same weights: every rank's
    launches per step as the global-row prediction, epoch 2's samples/s a
    rank (host clock, ending in the epoch's one sync), rank 0's busy share
    of its own kernels in epoch 3, every rank's peak memory, the two runs
    bitwise equal on every rank. Returns (rank 0's numbers, per-rank [rate,
    peak] of each run)."""
    import torch.distributed as dist

    mesh = parallel.current_mesh()
    r = dist.get_rank()
    device = torch.device("cuda", torch.cuda.current_device())
    data = to_device(make_batch(GRAPH_STEPS * B_TRAIN, seed + 11), device)
    want = train_step_prediction(B_TRAIN, DROPOUT)
    out, states, ranks = {}, {}, {}
    for graph, name in ((True, "graph"), (False, "eager")):
        model = flagship(seed)
        opt = adamw(LR)
        state = TrainState.create(model, opt, seed=seed)
        run = training.make_scan_epoch(model, opt, m_iwae_loss, accum_reduction="sum",
                                       mesh=mesh, graph=graph)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        numbers, prof = {}, epoch_profiler() if r == 0 else None
        for epoch in range(GRAPH_EPOCHS):
            before = kernel_counts()
            if epoch == 2 and prof is not None:
                prof.start()
            t0 = time.perf_counter()
            state, loss = run(state, data, torch.Generator().manual_seed(epoch), B_TRAIN)
            wall = time.perf_counter() - t0
            got = tuple(b - a for a, b in zip(before, kernel_counts()))
            assert np.isfinite(loss) and got == tuple(GRAPH_STEPS * w for w in want), (got, want)
            if epoch == 1:
                numbers["rate"] = GRAPH_STEPS * B_TRAIN // mesh.data / wall
            elif epoch == 2 and prof is not None:
                prof.stop()
                numbers["busy"] = report_profile(
                    prof, wall * 1e6, GRAPH_STEPS, f"(d) B = {B_TRAIN} DP step {name}, rank 0's "
                    f"kernels", top=6, phase=18)
        numbers["peak"] = torch.cuda.max_memory_allocated() / 2**20
        ranks[name] = all_ranks([numbers["rate"], numbers["peak"]])
        out[name], states[name] = numbers, state
        del model, opt, run
        torch.cuda.empty_cache()
    same = all_ranks([float(_same_state(states["graph"], states["eager"]))])
    if r == 0:
        log(18, f"(d) B = {B_TRAIN} DP step ({B_TRAIN // mesh.data} events a rank): graph "
                f"against the DDP step loop bitwise equal after {GRAPH_EPOCHS} epochs on ranks "
                f"{[bool(row[0]) for row in same]}")
    assert all(row[0] for row in same)
    return out, ranks


def gloo_all_reduce_ms(numel, reps=20):
    """Median host milliseconds of one all-reduce of an fp32 buffer of
    ``numel`` elements on the card over this process's world (the DP
    graph's stage between its replays), each ending in a sync."""
    import torch.distributed as dist

    buf = torch.zeros(numel, device="cuda")
    dist.all_reduce(buf)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def step_loop_line(driver, argv):
    """``driver.main(argv)`` on this rank with its standard output kept:
    the lines that say the step loop runs, and which collective kept it."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        driver.main(argv)
    return [line for line in buf.getvalue().splitlines() if "step loop" in line]


def rank_loop_pair(seed, label, argv, per_step, epochs, **kw):
    """``loop_pair`` of the flagship driver on this rank's mesh."""
    mesh = parallel.current_mesh()
    return loop_pair(seed, label, train_photospectra.main,
                     [*argv, f"train.mesh={mesh.data}x{mesh.model}"], per_step,
                     B_DRIVER // mesh.data, epochs, phase=18, **kw)


def dp_graph_world1_program(seed, per_step, npz):
    """Phase 18(a) in the rank of a world-1 NCCL group: an epoch on the
    small dataset."""
    return rank_loop_pair(seed, "(a) world-1 NCCL", [f"data={npz}"], per_step, 1)


def dp_graph_two_ranks_program(seed, per_step, npz):
    """Phase 18 (b), (d) and DP train_contrastive's (c) on both ranks of
    the 2x1 gloo mesh."""
    per_accum = tuple(2 * w for w in train_step_prediction(B_DRIVER // 2, DROPOUT))
    res = {"fp32": rank_loop_pair(seed, "(b) 2 ranks fp32", [], per_step, GRAPH_EPOCHS,
                                  resume=True, profile=True, hold=True)}
    with switch("VAESNE_BF16", "1"):
        res["bf16"] = rank_loop_pair(seed, "(b) 2 ranks bf16", [f"data={npz}"], per_step, 1,
                                     hold=True)
    res["accum"] = rank_loop_pair(seed, "(b) 2 ranks accum 2",
                                  ["train.accum_steps=2", f"data={npz}"], per_accum, 1)
    model = flagship(seed)
    numel = sum(p.numel() for p in model.parameters())
    res["reduce_ms"] = all_ranks([gloo_all_reduce_ms(numel + 1)])
    res["step"] = rank_step_pair(seed)
    root = os.path.join(SMOKE_DIR, "dp_graph", "contrastive")
    res["contrastive"] = step_loop_line(train_contrastive, [
        f"data={npz}", *driver_args(seed, root, "train.epochs=1", "train.mesh=2x1")])
    return res, numel


def tp_step_loop_program(seed, npz):
    """Phase 18(c) on both ranks of the 1x2 mesh: the flagship driver for
    an epoch on the small dataset."""
    root = os.path.join(SMOKE_DIR, "dp_graph", "tp")
    return step_loop_line(train_photospectra, [
        f"data={npz}", *driver_args(seed, root, "train.epochs=1", "train.mesh=1x2")])


def phase_dp_graph(seed):
    """Phase 18: train.scan_epoch under a data-parallel train.mesh, the DP
    graph (two CUDA graphs a rank around the eager gradient all-reduce)
    against the DDP step loop. Returns the keys it adds to the kernels
    line: launches_graph_dp, rank 0's launches of (b)'s fp32 graph run (3
    epochs; each rank's are checked equal to the prediction)."""
    t_phase = time.perf_counter()
    parallel.mesh.LAUNCH_TIMEOUT, parallel.mesh.GROUP_TIMEOUT = 600.0, 300.0
    torch.cuda.empty_cache()
    per_step = train_step_prediction(B_DRIVER, DROPOUT)
    npz = small_dataset(seed)

    world1 = parallel.make_mesh(["cuda:0"])
    assert world1.backend == "nccl", world1
    a = parallel.launch(dp_graph_world1_program, world1, seed, per_step, npz)["graph"]
    _check_launches("(a) world-1 NCCL graph run", a["table"],
                    tuple(a["steps"] * w for w in per_step), phase=18)
    t_a = time.perf_counter() - t_phase

    two = parallel.make_mesh(["cuda:0", "cuda:0"])
    assert two.backend == "gloo", two
    b, numel = parallel.launch(dp_graph_two_ranks_program, two, seed, per_step, npz)
    launches = {}
    worst = {}
    for key in ("fp32", "bf16"):
        graph = b[key]["graph"]
        table = graph["table"]
        launches[key] = _check_launches(f"(b) 2 ranks {key} graph run", table,
                                        tuple(graph["steps"] * w for w in per_step), phase=18)
        worst[key] = _check_masks(f"(b) {key}, the last replayed step", table, phase=18)
        rows, heads = int(table[0][6]), int(table[0][7])
        offset = (int(table[1][5]) - int(table[0][5])) % 2**32
        log(18, f"(b) {key}: rank 1's K1 seed minus rank 0's = {offset} = rows {rows} x heads "
                f"{heads} x 1024: {offset == rows * heads * 1024}")
        assert offset == rows * heads * 1024, (key, offset, rows, heads)
    per_accum = tuple(2 * w for w in train_step_prediction(B_DRIVER // 2, DROPOUT))
    _check_launches("(b) 2 ranks accum 2 graph run", b["accum"]["graph"]["table"],
                    tuple(b["accum"]["graph"]["steps"] * w for w in per_accum), phase=18)
    t_b = time.perf_counter() - t_phase - t_a

    tp = parallel.make_mesh(["cuda:0", "cuda:0"], data=1, model=2)
    tp_lines = parallel.launch(tp_step_loop_program, tp, seed, npz)
    log(18, f"(c) 1x2 tensor parallel train_photospectra: {tp_lines}")
    assert len(tp_lines) == 1 and "runs copy_to_model, reduce_from_model inside" in tp_lines[0], (
        tp_lines)
    log(18, f"(c) 2x1 train_contrastive: {b['contrastive']} (no step-loop line: the graph "
            f"splits its step at InfoNCE's gather, phase 19)")
    assert not b["contrastive"], b["contrastive"]
    t_c = time.perf_counter() - t_phase - t_a - t_b

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    step_out, step_ranks = b["step"]
    g, e = b["fp32"]["graph"], b["fp32"]["eager"]
    log(18, f"(d) two ranks on one card, not a scaling number; on {smi}")
    log(18, f"(d) driver B = {B_DRIVER}, {B_DRIVER // 2} events a rank, fp32, rank 0: graph "
            f"{g['rate']:.1f} against the DDP step loop {e['rate']:.1f} samples/s a rank "
            f"({g['rate'] / e['rate']:.2f}x); rank 0's kernels busy {g['busy']:.1%} against "
            f"{e['busy']:.1%} of epoch 3; peak memory {g['peak']:.0f} against {e['peak']:.0f} "
            f"MiB")
    gs, es = step_out["graph"], step_out["eager"]
    log(18, f"(d) B = {B_TRAIN} step, {B_TRAIN // 2} events a rank, fp32: graph "
            f"{[round(row[0], 1) for row in step_ranks['graph']]} against the DDP step loop "
            f"{[round(row[0], 1) for row in step_ranks['eager']]} samples/s a rank "
            f"({gs['rate'] / es['rate']:.2f}x on rank 0); rank 0's kernels busy "
            f"{gs['busy']:.1%} against {es['busy']:.1%}; peak memory "
            f"{[round(row[1]) for row in step_ranks['graph']]} against "
            f"{[round(row[1]) for row in step_ranks['eager']]} MiB")
    step_ms = 1e3 * (B_DRIVER // 2) / g["rate"]
    reduce_ms = max(row[0] for row in b["reduce_ms"])
    log(18, f"(d) the gloo all-reduce of the {numel + 1} fp32 gradients and loss "
            f"({(numel + 1) * 4 / 2**20:.2f} MiB) through the host: {reduce_ms:.3f} ms median "
            f"(worst rank), against the graph's {step_ms:.3f} ms a driver step (rank 0, epoch 2)")
    log(18, f"phase 18 took {time.perf_counter() - t_phase:.1f} s: (a) {t_a:.1f} s, (b, d) "
            f"{t_b:.1f} s, (c) {t_c:.1f} s")
    fp32 = dict(zip(COUNTERS, launches["fp32"][0]))
    return ({"attention_fwd": {"launches_graph_dp": fp32["K1"] - fp32["K1 rate>0"]},
             **{name: {"launches_graph_dp": fp32[c]}
                for name, c in (("attention_fwd_dropout", "K1 rate>0"), ("attention_bwd", "K2"),
                                ("laplace_fwd", "K3"), ("laplace_bwd", "K4"))}},
            worst["fp32"])


# -- train_contrastive's data-parallel CUDA graph (the step split at InfoNCE's gather) -

def dp_contrastive_program(seed, npz):
    """Phase 19 (a)-(c) on both ranks of the 2x1 gloo mesh: ``loop_pair``
    of train_contrastive for each configuration, then the time of each of
    a step's eager collectives, all-reduces of buffers of their sizes (the
    gathered projections and their gradients, [B, proj_dim] in fp32; the
    packed gradients and loss)."""
    mesh = parallel.current_mesh()
    cfg = ContrastiveConfig()
    selfattn = parse_overrides(cfg, ["model.selfattn=true"])
    half = B_CONTRA // mesh.data
    on_mesh, sa = f"train.mesh={mesh.data}x{mesh.model}", "model.selfattn=true"
    per_step = contrastive_step_prediction(selfattn)

    def pair(label, argv, want, epochs, **kw):
        return loop_pair(seed, label, train_contrastive.main, [*argv, on_mesh], want, half,
                         epochs, phase=19, length=CONTEXT, **kw)

    res = {"fp32": pair("(a) selfattn fp32", [sa], per_step, GRAPH_EPOCHS, profile=True,
                        resume=True, hold=True)}
    with switch("VAESNE_BF16", "1"):
        res["bf16"] = pair("(a) selfattn bf16", [sa, f"data={npz}"], per_step, 1, hold=True)
    pair("(b) default towers", [f"data={npz}"], contrastive_step_prediction(cfg), 1)
    micro = parse_overrides(selfattn, [f"train.batch_size={B_CONTRA // 2}"])
    pair("(b) selfattn accum 2", [sa, "train.accum_steps=2", f"data={npz}"],
         tuple(2 * w for w in contrastive_step_prediction(micro)), 1)
    numel = sum(p.numel() for p in train_contrastive.build_model(selfattn).parameters())
    sizes = [B_CONTRA * cfg.proj_dim] * 4 + [numel + 1]
    res["collectives_ms"] = all_ranks([gloo_all_reduce_ms(n) for n in sizes])
    return res, sizes


def phase_dp_contrastive(seed):
    """Phase 19: train_contrastive at train.mesh=2 on two gloo ranks sharing
    the card, each (micro)batch's step as CUDA graphs of the towers, the
    InfoNCE head and the towers' backward with the gather's all-reduces
    (and the gradient all-reduce) eager between them, against the DDP step
    loop. Returns the keys it adds to the kernels line and the worst fp32
    K1/K2 errors on the ranks' replayed inputs."""
    t_phase = time.perf_counter()
    parallel.mesh.LAUNCH_TIMEOUT, parallel.mesh.GROUP_TIMEOUT = 600.0, 300.0
    torch.cuda.empty_cache()
    npz = small_dataset(seed)
    two = parallel.make_mesh(["cuda:0", "cuda:0"])
    assert two.backend == "gloo", two
    res, sizes = parallel.launch(dp_contrastive_program, two, seed, npz)
    selfattn = parse_overrides(ContrastiveConfig(), ["model.selfattn=true"])
    per_step = contrastive_step_prediction(selfattn)
    launches, worst = {}, {}
    for key in ("fp32", "bf16"):
        graph = res[key]["graph"]
        table = graph["table"]
        launches[key] = _check_launches(f"(a) selfattn {key} graph run", table,
                                        tuple(graph["steps"] * w for w in per_step), phase=19)
        worst[key] = _check_masks(f"(a) {key}, the last replayed step", table, phase=19,
                                  length=CONTEXT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    g, e = res["fp32"]["graph"], res["fp32"]["eager"]
    log(19, f"(c) two ranks on one card, not a scaling number; on {smi}")
    log(19, f"(c) train_contrastive model.selfattn=true, B = {B_CONTRA}, {B_CONTRA // 2} events "
            f"a rank, fp32, rank 0: graph {g['rate']:.1f} against the DDP step loop "
            f"{e['rate']:.1f} samples/s a rank ({g['rate'] / e['rate']:.2f}x); rank 0's kernels "
            f"busy {g['busy']:.1%} against {e['busy']:.1%} of epoch 3; peak memory "
            f"{g['peak']:.0f} against {e['peak']:.0f} MiB")
    step_ms = 1e3 * (B_CONTRA // 2) / g["rate"]
    ms = [max(row[i] for row in res["collectives_ms"]) for i in range(len(sizes))]
    names = ("gather z1", "gather z2", "gather backward z1", "gather backward z2",
             "gradient all-reduce")
    log(19, "(c) eager collectives of a step, gloo through the host, median ms (worst rank): "
            + ", ".join(f"{n} ({k} fp32) {t:.3f}" for n, k, t in zip(names, sizes, ms))
            + f"; together {sum(ms):.3f} ms, {sum(ms) / step_ms:.1%} of the graph's "
              f"{step_ms:.3f} ms a step (rank 0, epoch 2)")
    log(19, f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    fp32 = {r: dict(zip(COUNTERS, row)) for r, row in enumerate(launches["fp32"])}
    return ({name: {f"launches_graph_dp_contrastive_rank{r}": fp32[r][c] for r in fp32}
             for name, c in (("attention_fwd_dropout", "K1 rate>0"), ("attention_bwd", "K2"))},
            tuple(max(w[i] for w in worst.values()) for i in (0, 1)))


def epoch_profiler():
    """A profiler for the busy share of a driver's epoch: device activity
    alone (an epoch's host ops would cost the profiler minutes to gather,
    and slow the host it measures), started and stopped by the caller."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA], acc_events=True)


def _device_us(event):
    return getattr(event, "self_device_time_total", None) or getattr(
        event, "self_cuda_time_total", 0)


def _is_kernel(event):
    """A device-side event (a kernel or copy), not the host op that
    launched it, which reports the same device time again, nor a named
    range on the device's timeline (``Optimizer.step``), which spans
    kernels counted on their own."""
    from torch.autograd import DeviceType

    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def profile_calls(call, label, n=3, top=8, phase=6):
    """Where the time of ``call`` goes: device time by kernel under
    torch.profiler, and the device's busy share of the (profiled) wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return report_profile(prof, wall_us, n, label, top, phase)


def report_profile(prof, wall_us, n, label, top, phase):
    """Log the device time by kernel of a finished profile over ``n`` calls
    in ``wall_us``; returns the device's busy share of that wall."""
    events = [e for e in prof.key_averages() if _is_kernel(e) and _device_us(e) > 0]
    busy_us = sum(_device_us(e) for e in events)
    log(phase, f"profile {label}: {n} calls, wall {wall_us / n / 1e3:.2f} ms/call under the "
               f"profiler, device busy {busy_us / n / 1e3:.2f} ms/call ({busy_us / wall_us:.1%})")
    for e in sorted(events, key=_device_us, reverse=True)[:top]:
        log(phase, f"  {_device_us(e) / n / 1e3:8.3f} ms/call {e.count / n:6.1f} launches/call "
                   f"{e.key[:100]}")
    return busy_us / wall_us


def device_kernels(call, n=100):
    """(device ms per call, kernels per call, {kernel: launches per call})
    of ``call`` under torch.profiler over ``n`` calls: each kernel's mean
    time times its launches per call (rounded: the profiler may drop a few
    of the first events), summed; the host's launch cost between kernels is
    left out."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile now and then records no kernel time at all
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if _is_kernel(e) and e.count > 0]
        if any(_device_us(e) > 0 for e in events):
            break
    per_call = {e.key: max(1, round(e.count / n)) for e in events}
    busy_us = sum(_device_us(e) / e.count * per_call[e.key] for e in events)
    assert busy_us > 0, "the profiler saw no device time"
    names = {kernel_name(k): c for k, c in per_call.items()}
    return busy_us / 1e3, sum(per_call.values()), names


def kernel_name(key):
    """A profiler key without namespaces, return type and argument list,
    cut to 60 characters."""
    name = key.replace("(anonymous namespace)::", "").replace("at::native::", "")
    return (name[5:] if name.startswith("void ") else name).split("(")[0][:60]


def device_ms(call, n=100):
    """Device milliseconds per ``call`` (see ``device_kernels``)."""
    return device_kernels(call, n)[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only", file=sys.stderr)
        return 1
    sm_clock = phase_environment()
    phase_build()
    errs = phase_kernel_vs_plain()
    model = flagship(args.seed)
    cpu_model = copy.deepcopy(model).eval()
    serving_launches = phase_serving(model, args.seed)
    phase_card_vs_cpu(model, cpu_model, args.seed)
    res, plain = phase_times(model, args.seed, sm_clock)
    del model, cpu_model
    torch.cuda.empty_cache()
    train_launches, train = phase_training(args.seed)
    phase_train_card_vs_cpu(args.seed)
    t = phase_train_times(train, args.seed, sm_clock)
    del train
    torch.cuda.empty_cache()
    drivers, drivers_serving, rate, busy = phase_drivers(args.seed)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(10, f"flagship driver (B = {B_DRIVER}, K = {K_TRAIN}, dropout {DROPOUT}, fp32): median "
            f"{rate:.1f} samples/s over epochs 2-{DRIVER_EPOCHS}; device busy {busy:.1%} of a "
            f"profiled epoch; on {smi}")
    torch.cuda.empty_cache()
    eval_launches, ev = phase_evaluation(args.seed)
    log(11, f"eval_goldstein (K = {K_EVAL}, fp32): {ev['events_s']:.1f} events/s, wall "
            f"{ev['wall']:.3f} s, peak memory {ev['peak']:.0f} MiB, device busy {ev['busy']:.1%} "
            f"of a profiled suite chunk; on {smi}")
    torch.cuda.empty_cache()
    image_extra, image_errs = phase_image(args.seed)
    torch.cuda.empty_cache()
    contrastive_extra, contrastive_errs = phase_contrastive(args.seed)
    for name, err in (*image_errs.items(), *contrastive_errs.items()):
        errs[name] = max(errs[name], err)
    multi, (err_f, err_b) = phase_multigpu(args.seed)
    errs["attention_fwd_dropout"] = max(errs["attention_fwd_dropout"], err_f)
    errs["attention_bwd"] = max(errs["attention_bwd"], err_b)
    torch.cuda.empty_cache()
    extras_extra, extras_errs = phase_extras(args.seed)
    for name, err in extras_errs.items():
        errs[name] = max(errs[name], err)
    torch.cuda.empty_cache()
    switches_extra = phase_switches(args.seed, rate, busy, ev["events_s"])
    torch.cuda.empty_cache()
    graph_extra = phase_graph(args.seed)
    torch.cuda.empty_cache()
    dp_graph_extra, (err_f, err_b) = phase_dp_graph(args.seed)
    errs["attention_fwd_dropout"] = max(errs["attention_fwd_dropout"], err_f)
    errs["attention_bwd"] = max(errs["attention_bwd"], err_b)
    torch.cuda.empty_cache()
    dp_contrastive_extra, (err_f, err_b) = phase_dp_contrastive(args.seed)
    errs["attention_fwd_dropout"] = max(errs["attention_fwd_dropout"], err_f)
    errs["attention_bwd"] = max(errs["attention_bwd"], err_b)
    ms, bound_ms, by, lib = res[(800, torch.float32)]
    ms16, bound16, _, lib16 = res[(800, torch.bfloat16)]
    f32, b16 = t[torch.float32], t[torch.bfloat16]
    errs["attention_fwd_dropout"] = max(errs["attention_fwd_dropout"], t["err_f"])
    errs["attention_bwd"] = max(errs["attention_bwd"], t["err_b"])
    attn_src = "vaesne_tpu_torch/csrc/attention_{}.cu"
    lap_src = "vaesne_tpu_torch/csrc/laplace.cu"
    step_rows = K_TRAIN * B_TRAIN
    lap32, lap16 = t[("laplace", step_rows, torch.float32)], t[("laplace", step_rows,
                                                                  torch.bfloat16)]
    rows = [
        ("attention_fwd", "cuda", attn_src.format("fwd"), "vaesne_tpu/ops/attention.py:304",
         serving_launches, errs["attention_fwd"], ms, plain, (bound_ms, by), lib, ms16, lib16,
         drivers_serving, {"launches_eval": eval_launches, "ms_eval": ev["ms"],
                           "bound_ms_eval": ev["bound"]}),
        ("attention_fwd_dropout", "cuda", attn_src.format("fwd"),
         "vaesne_tpu/ops/attention.py:304", train_launches["K1 rate>0"],
         errs["attention_fwd_dropout"], f32["fwd"], t["plain_f"], f32["b_f"], f32["lib_f"],
         b16["fwd"], b16["lib_f"], drivers["K1 rate>0"]),
        ("attention_bwd", "cuda", attn_src.format("bwd"), "vaesne_tpu/ops/attention.py:353",
         train_launches["K2"], errs["attention_bwd"], f32["bwd"], t["plain_b"], f32["b_b"],
         f32["lib_b"], b16["bwd"], b16["lib_b"], drivers["K2"]),
        ("laplace_fwd", "cuda", lap_src, "vaesne_tpu/ops/laplace.py:30",
         train_launches["K3"], errs["laplace_fwd"], lap32["k3"], lap32["p3"], lap32["b3"], None,
         lap16["k3"], None, drivers["K3"]),
        ("laplace_bwd", "cuda", lap_src, "vaesne_tpu/ops/laplace.py:38",
         train_launches["K4"], errs["laplace_bwd"], lap32["k4"], lap32["p4"], lap32["b4"], None,
         lap16["k4"], None, drivers["K4"]),
    ]
    # ms/library_ms are fp32; ms_bf16/library_ms_bf16 the same calls on bf16
    # inputs; launches_drivers counts phase 10's path (K1 at rate 0: the
    # from_checkpoint serving), launches_eval phase 11's, with K1's fp32 time
    # and bound on its R = 12,800 decoder input (ms_eval, bound_ms_eval);
    # the attention rows add phase 12's: launches of train_image (K1 rate 0:
    # of try_image) at the hybrid, per-pixel and MNIST grids
    # (launches_{image,pixel,mnist}), fp32 times and bounds at R = 32 there
    # (ms_, bound_ms_), K1 rate 0 at try_image's R = 400 (_image_r400), the
    # plain version and SDPA at 900x900 (plain_ms_image, library_ms_image),
    # and phase 13(c)'s: launches of train_contrastive model.selfattn=true
    # (launches_contrastive_selfattn; K1 rate 0: none, it only trains) and,
    # on its captured [32, 983, 32] key-padded input, fp32 times, bounds,
    # plain versions and SDPA (*_contrastive_selfattn), and phase 14's per-rank
    # launches of one step at dropout 0.1: launches_nccl_world1,
    # launches_dp_rank{0,1} (2x1, 96 events a rank), launches_tp_rank{0,1}
    # (1x2), and on attention_fwd K1 at rate 0 per rank of DP crossmodal_ci
    # at buckets 32 and 64 (launches_dp_serving_rank{0,1}), and phase 15's:
    # launches of TransformerModel's forward at rate 0 and of the stand-in
    # pickle's crossmodal_ci (K1 rate 0), of its backward at 0.1 (K1 rate
    # 0.1, K2) (launches_extras), and on its captured [1, 982, 32] input the
    # fp32 times, bounds, plain versions and SDPA (*_extras); attention_fwd
    # also carries RelativeMultiHeadAttention's time per call and device time
    # at [8, 982, 32] (relative_attention_ms, _device_ms); and phase 16's:
    # launches of VAESNE_BF16=1 train_photospectra (launches_drivers_bf16;
    # K1 rate 0: its deterministic grids), of one bf16 B = 192 step at
    # VAESNE_REMAT=0 (launches_step_remat0), of bf16 eval_goldstein and the
    # four bridged checkpoints (attention_fwd: launches_eval_bf16,
    # launches_bridged), K1 at rate 0.1 and K2 at R = 768 with 16- and
    # 32-bit dropout draws (ms_w16, ms_w32, ms_bf16_w16, ms_bf16_w32), the
    # bf16 K2's dq error on Queue 3's input (queue3_dq_rel_bf16 at rate
    # 0.1, _rate0); the K1 rows and K2 also carry their bf16 bound at the
    # ms_bf16 shape (bound_ms_bf16); and phase 17's launches of
    # train_photospectra's 3 epochs under the CUDA graph of the step
    # (launches_graph; K1 rate 0: none), and phase 18's: rank 0's launches
    # of the same 3 epochs under the data-parallel graph on two gloo ranks
    # (launches_graph_dp; each rank's checked equal), and phase 19's: each
    # rank's launches of train_contrastive model.selfattn=true's 3 fp32
    # epochs under its data-parallel graph (launches_graph_dp_contrastive_
    # rank{0,1}). The Laplace
    # rows are at the step's [2, 192] slice and add, per slice [K, B] of LAPLACE_PATH (suffix _{K·B}) and
    # dtype, their device time, bound, torch.sum's time and the wrapper's
    # host time per call; no single library call computes K3 or K4
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    laplace_extra = {}
    for name, n in (("laplace_fwd", 3), ("laplace_bwd", 4)):
        extra = laplace_extra.setdefault(name, {})
        for _, k, b, _ in LAPLACE_PATH:
            for dtype, d in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
                r = t[("laplace", k * b, dtype)]
                extra.update({f"ms{d}_{k * b}": r[f"k{n}"], f"bound_ms{d}_{k * b}": r[f"b{n}"][0],
                              f"torch_sum_ms{d}_{k * b}": r["sum"],
                              f"host_ms{d}_{k * b}": r[f"host{n}"]})
    column = {"attention_fwd_dropout": 0, "attention_bwd": 2, "laplace_fwd": 3, "laplace_bwd": 4}
    multi_extra = {name: {"launches_nccl_world1": multi["nccl"][0][c],
                          **{f"launches_{kind}_rank{r}": multi[kind][r][c]
                             for kind in ("dp", "tp") for r in (0, 1)}}
                   for name, c in column.items()}
    multi_extra["attention_fwd"] = {f"launches_dp_serving_rank{r}": sum(
        launches[r] for launches in multi["serving"]) for r in (0, 1)}
    bf16_bounds = {"attention_fwd": bound16, "attention_fwd_dropout": b16["b_f"][0],
                   "attention_bwd": b16["b_b"][0]}
    print(json.dumps({"kernels": [
        dict(zip(keys, r[:8]), bound_ms=r[8][0], bound_by=r[8][1], library_ms=r[9],
             ms_bf16=r[10], library_ms_bf16=r[11], launches_drivers=r[12],
             **(r[13] if len(r) > 13 else {}), **laplace_extra.get(r[0], {}),
             **image_extra.get(r[0], {}), **contrastive_extra.get(r[0], {}),
             **multi_extra.get(r[0], {}), **extras_extra.get(r[0], {}),
             **switches_extra.get(r[0], {}), **graph_extra.get(r[0], {}),
             **dp_graph_extra.get(r[0], {}), **dp_contrastive_extra.get(r[0], {}),
             **({"bound_ms_bf16": bf16_bounds[r[0]]} if r[0] in bf16_bounds else {}))
        for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
