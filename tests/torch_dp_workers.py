"""Rank programs of the multi-GPU tests, run on gloo ranks on the CPU.

``parallel.launch`` spawns its ranks, which unpickle these functions by
module name: this module imports torch, numpy and the port alone, so no rank
imports jax. Each returns plain tensors, arrays or lists, which rank 0
hands back to the test."""

import contextlib
import time

import numpy as np
import torch

import vaesne_tpu_torch.distributions as tdist
from vaesne_tpu_torch import objectives as tobj
from vaesne_tpu_torch import training as ttr
from vaesne_tpu_torch.evaluation import batched_apply, masking_sweep, mmvae_reconstruction_suite
from vaesne_tpu_torch.parallel import (
    current_mesh,
    gather_state_tp,
    shard_data_parallel,
    shard_state_tp,
)
from vaesne_tpu_torch.parallel.mesh import data_group, model_group
from vaesne_tpu_torch.serving import InferenceServer


def noise(shape):
    """``torch_parity.noise``: numpy Laplace noise, a function of the shape."""
    return np.random.default_rng(list(shape) or [0]).laplace(size=shape).astype(np.float32)


@contextlib.contextmanager
def pinned_noise():
    """Laplace draws become loc + scale·noise(the whole batch's shape), of
    which the rank keeps its events (``draw_events``): ``fixed_noise`` of
    the parity tests, per rank."""
    original = tdist.Laplace.sample

    def sample(self, generator=None, sample_shape=()):
        shape = tdist._as_shape(sample_shape) + tuple(self.batch_shape)
        return self.loc + self.scale * tdist.draw_events(
            lambda full: torch.from_numpy(noise(full)), shape)

    tdist.Laplace.sample = sample
    try:
        yield
    finally:
        tdist.Laplace.sample = original


def train_steps(model, batch, steps, K=2, reduction="sum", pinned=True, accum_steps=1,
                lr=1e-3):
    """``steps`` m-IWAE steps of ``model`` on ``batch`` on this rank's mesh
    (tensor-parallel where its model axis is > 1): the losses and the whole
    parameters after them."""
    mesh = current_mesh()
    opt = ttr.adamw(lr)
    state = ttr.TrainState.create(model, opt, seed=0, device="cpu")
    if mesh.model > 1:
        shard_state_tp(state, mesh)
    step = ttr.make_train_step(model, opt, tobj.as_loss(tobj.m_iwae, K=K), accum_steps,
                               reduction, device="cpu", mesh=mesh)
    losses = []
    with pinned_noise() if pinned else contextlib.nullcontext():
        for _ in range(steps):
            state, loss = step(state, batch)
            losses.append(loss.item())
    return losses, gather_state_tp(state, mesh)["model"]


def info_nce_grads(model, batch, dtype=torch.float32):
    """One InfoNCE step of ``model`` on ``batch`` on this rank's mesh (in
    one process outside a rank), without the clip, with ``dtype`` the
    default dtype (the model and batch are cast to it): the loss and the
    gradient the step applied."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        model = model.to(dtype)
        as_np = torch.empty(0, dtype=dtype).numpy().dtype
        batch = tuple(tuple(a.astype(as_np) if a.dtype.kind == "f" else a for a in m)
                      for m in batch)
        opt = ttr.adamw(1e-3, grad_clip=None)
        state = ttr.TrainState.create(model, opt, seed=0, device="cpu")
        step = ttr.make_train_step(model, opt, tobj.as_loss(tobj.neg_info_nce), device="cpu",
                                   mesh=current_mesh())
        state, loss = step(state, batch)
    finally:
        torch.set_default_dtype(before)
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def groups_and_replication(model):
    """On a 2x2 mesh: check this rank's data and model groups (an
    all-reduce of a one-hot rank vector in each), then give its parameters
    and AdamW moments a rank-dependent offset and check that
    ``shard_data_parallel`` brings back rank 0's and slices the data.
    Returns the members of the data and model groups."""
    mesh = current_mesh()
    r = torch.distributed.get_rank()
    d, m = divmod(r, mesh.model)
    members = []
    for group in (data_group(mesh), model_group(mesh)):
        onehot = torch.zeros(mesh.size)
        onehot[r] = 1.0
        torch.distributed.all_reduce(onehot, group=group)
        members.append(onehot.nonzero().flatten().tolist())
    assert members == [[m, mesh.model + m], [mesh.model * d, mesh.model * d + 1]], (r, members)
    want = [p.detach().clone() for p in model.parameters()]
    state = ttr.TrainState.create(model, ttr.adamw(1e-3), seed=0, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(r)
            state.optimizer.state[p] = {"exp_avg": torch.full_like(p, float(r))}
    data = (torch.arange(8.0), np.arange(8))
    part, state = shard_data_parallel(data, state, mesh)
    assert torch.equal(part[0], torch.arange(4.0 * d, 4.0 * d + 4)), (r, part)
    assert np.array_equal(part[1], np.arange(4 * d, 4 * d + 4)), (r, part)
    for p, w in zip(model.parameters(), want):
        assert torch.equal(p, w) and not state.optimizer.state[p]["exp_avg"].any(), r
    return tuple(members)


def serve(model, photo, spec, K, seed):
    """Every task of a server on this rank's mesh, each call with a
    generator seeded ``seed``."""
    server = InferenceServer(model, mesh=current_mesh(), device="cpu", buckets=(4, 8))

    def g():
        return torch.Generator().manual_seed(seed)

    return {"embed0": server.embed(photo, modality=0),
            "embed1": server.embed(spec, modality=1),
            "crossmodal": server.crossmodal(photo, spec, K=K, generator=g()),
            "predictive": server.crossmodal(photo, spec, K=K, generator=g(), predictive=True),
            "ci": server.crossmodal_ci(photo, spec, K=K, generator=g()),
            "reconstruct": server.reconstruct((photo, spec), K=K, generator=g())}


def evaluate(model, test_batch, K, chunk):
    """The reconstruction suite and the masking sweep on this rank's mesh."""
    mesh = current_mesh()
    return (mmvae_reconstruction_suite(model, test_batch, K=K, chunk_size=chunk, seed=3,
                                       mesh=mesh, device="cpu"),
            masking_sweep(model, test_batch, (0.0, 0.5), K=K, chunk_size=chunk, mesh=mesh,
                          device="cpu"))


def double_plus_chunk_seed(chunk, seed):
    return chunk * 2 + seed % 7


def apply(data, chunk):
    """``batched_apply`` of ``double_plus_chunk_seed`` on this rank's mesh
    (in one process outside a rank)."""
    return batched_apply(double_plus_chunk_seed, data, chunk, mesh=current_mesh(), seed=5)


def fail_on_rank_one():
    """Rank 1 raises while rank 0 is still busy."""
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 failed")
    time.sleep(60)


def sleep_forever():
    time.sleep(600)
