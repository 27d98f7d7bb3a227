"""Rank programs of the multi-GPU tests, run on gloo ranks on the CPU.

``parallel.launch`` spawns its ranks, which unpickle these functions by
module name: this module imports torch, numpy and the port alone, so no rank
imports jax. Each returns plain tensors, arrays or lists, which rank 0
hands back to the test.

``ddp_train_step`` and ``ddp_epoch`` are the reference the port's
data-parallel step is held to: torch's ``DistributedDataParallel`` around
the objective, built here from the port's public pieces and none of its
data-parallel code (``chip_smoke.py`` phases 18 and 19 use them too)."""

import contextlib
import copy
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
from vaesne_tpu_torch.nn.layers import autocast, cudnn_fp32_deterministic, resolve_precision
from vaesne_tpu_torch.ops import partition
from vaesne_tpu_torch.parallel.mesh import data_group, model_group, shard_batch, shard_of
from vaesne_tpu_torch.serving import InferenceServer
from vaesne_tpu_torch.utils import fold_in


def noise(shape):
    """``torch_parity.noise``: numpy Laplace noise, a function of the shape."""
    return np.random.default_rng(list(shape) or [0]).laplace(size=shape).astype(np.float32)


def shared_noise(shape):
    """``noise`` drawn for one event and shared by every event (axis 1 of a
    posterior draw [K, B, ...]): an event's noise does not depend on where
    a shuffle put it."""
    one = noise(tuple(shape[:1]) + (1,) + tuple(shape[2:]))
    return np.ascontiguousarray(np.broadcast_to(one, shape))


@contextlib.contextmanager
def pinned_noise(shared=False):
    """Laplace draws become loc + scale·noise(the whole batch's shape), of
    which the rank keeps its events (``draw_events``): ``fixed_noise`` of
    the parity tests, per rank (``shared``: ``shared_noise``)."""
    original = tdist.Laplace.sample
    draw = shared_noise if shared else noise

    def sample(self, generator=None, sample_shape=()):
        shape = tdist._as_shape(sample_shape) + tuple(self.batch_shape)
        return self.loc + self.scale * tdist.draw_events(
            lambda full: torch.from_numpy(draw(full)), shape)

    tdist.Laplace.sample = sample
    try:
        yield
    finally:
        tdist.Laplace.sample = original


class _Objective(torch.nn.Module):
    """The step's loss as a module, so that DDP wraps the whole objective
    and the loss function still gets the model itself."""

    def __init__(self, model, neg_loss):
        super().__init__()
        self.model = model
        self.neg_loss = neg_loss

    def forward(self, batch, seed):
        return self.neg_loss(self.model, batch, seed)


def _sum_hook(group, bucket):
    """DDP comm hook: sum the bucket over the group (the default averages)."""
    work = torch.distributed.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def _microbatch(batch, i, accum_steps):
    """Part ``i`` of ``accum_steps`` equal parts of dim 0 of every array of
    ``batch`` (a nested tuple)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_microbatch(b, i, accum_steps) for b in batch)
    size = batch.shape[0] // accum_steps
    return batch[i * size:(i + 1) * size]


def ddp_train_step(model, optimizer, loss_fn, accum_steps=1, reduction="mean", device=None,
                   mesh=None, precision=None):
    """The data-parallel train step of ``training.make_train_step(mesh=)``
    as torch's DDP runs it, ``step(state, batch) -> (state, loss)``: DDP
    over the data group around the objective, built at the first step
    (its constructor broadcasts the data group's first rank's parameters
    and buffers), the gradients averaged by its reducer or, for a
    ``"sum"`` objective, summed by a comm hook; ``no_sync`` over every
    microbatch but the last (microbatch i of the global batch at
    ``fold_in(seed, i)``, each rank's slice of it under the shard), the
    gradients and loss divided by the microbatch count for ``"mean"``;
    the loss all-reduced (÷ n for ``"mean"``); the global-norm clip over
    the trainable gradients and the AdamW update. A data-parallel mesh
    only: a tensor-parallel model's clip norm spans the model group."""
    from torch.nn.parallel import DistributedDataParallel

    if mesh.model > 1:
        raise ValueError("the DDP reference runs a data-parallel mesh only")
    device = ttr.resolve_device(device)
    precision = resolve_precision(precision)
    shard = shard_of(mesh)
    wrapped = []

    def neg_loss(m, b, seed):
        with autocast(precision, device):
            return -loss_fn(m, shard_batch(b, mesh), seed)

    def step(state, batch):
        if not wrapped:
            ddp = DistributedDataParallel(_Objective(model, neg_loss),
                                          process_group=shard.data_group)
            if reduction == "sum":
                ddp.register_comm_hook(shard.data_group, _sum_hook)
            wrapped.append(ddp)
        ddp = wrapped[0]
        batch, seed = ttr.to_device(batch, device), ttr.draw_seed(state.generator)
        state.optimizer.zero_grad(set_to_none=True)
        with cudnn_fp32_deterministic(), partition.sharded(shard):
            if accum_steps == 1:
                loss = ddp(batch, seed)
                loss.backward()
                loss = loss.detach()
            else:
                loss = None
                for i in range(accum_steps):
                    micro = _microbatch(batch, i, accum_steps)
                    with ddp.no_sync() if i < accum_steps - 1 else contextlib.nullcontext():
                        part = ddp(micro, fold_in(seed, i))
                        part.backward()
                    loss = part.detach() if loss is None else loss + part.detach()
                if reduction == "mean":
                    torch._foreach_mul_([p.grad for p in model.parameters()
                                         if p.grad is not None], 1.0 / accum_steps)
                    loss = loss * (1.0 / accum_steps)
        torch.distributed.all_reduce(loss, group=shard.data_group)
        if reduction == "mean":
            loss = loss / shard.n_data
        if optimizer.grad_clip is not None:
            ttr.clip_by_global_norm([p.grad for p in state.trainable_parameters()
                                     if p.grad is not None], optimizer.grad_clip)
        state.optimizer.step()
        state.step += 1
        return state, loss

    return step


def ddp_epoch(model, optimizer, loss_fn, accum_steps=1, accum_reduction="mean", device=None,
              mesh=None, precision=None):
    """``ttr.train_epoch`` over ``ddp_train_step``: the DDP step loop,
    ``run(state, data, generator, batch_size) -> (state, mean loss)``, in
    ``training.make_scan_epoch``'s order of arguments."""
    step = ddp_train_step(model, optimizer, loss_fn, accum_steps, accum_reduction, device, mesh,
                          precision)

    def run(state, data, generator, batch_size):
        return ttr.train_epoch(state, step, data, batch_size, generator)

    return run


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


def scan_epochs(model, data, epochs, batch_size, K=2, reduction="sum", accum_steps=1,
                pinned=True, shared=False, device="cpu", skew=0.0, frozen=None, loss_fn=None):
    """``epochs`` epochs on this rank's mesh of ``make_scan_epoch`` with
    ``graph=True`` (the data-parallel graph's stages; eager on the CPU) and
    of ``ddp_epoch`` (the DDP step loop), each from a copy of ``model``
    whose parameters this rank first moves by rank·``skew`` (both start
    from rank 0's), the parameters whose names start with ``frozen``
    frozen, the loss ``loss_fn`` (None: m-IWAE at ``K``). For each: the
    epoch losses, the state dict on the CPU and every rank's parameters
    after the run, and the epoch function's ``step_loop_reason``."""
    import torch.distributed as dist

    from vaesne_tpu_torch.parallel.mesh import to_host

    torch.set_num_threads(1)  # small models: the ranks' threads would only contend
    mesh = current_mesh()
    out = {}
    for graph in (True, False):
        m = copy.deepcopy(model)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(dist.get_rank() * skew)
        opt = ttr.adamw(1e-3)
        trainable = None if frozen is None else {
            name: not name.startswith(frozen) for name, _ in m.named_parameters()}
        state = ttr.TrainState.create(m, opt, seed=0, device=device, trainable=trainable)
        args = (m, opt, loss_fn or tobj.as_loss(tobj.m_iwae, K=K), accum_steps, reduction,
                device)
        run = ttr.make_scan_epoch(*args, mesh=mesh) if graph else ddp_epoch(*args, mesh=mesh)
        losses = []
        with pinned_noise(shared) if pinned else contextlib.nullcontext():
            for epoch in range(epochs):
                state, loss = run(state, data, torch.Generator().manual_seed(10 + epoch),
                                  batch_size)
                losses.append(loss)
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, [p.detach().cpu() for p in m.parameters()])
        out[graph] = (losses, to_host(state.state_dict()), ranks,
                      getattr(run, "step_loop_reason", None))
    return out


def dp_step_sites(model, batch, step_seeds, K=2):
    """On every rank: the draw sites of one step of the data-parallel
    graph's stages, recorded at one step seed and recomputed for each of
    ``step_seeds`` with ``SeedTape.values``, against the (kind, seed) sites
    of ``ddp_train_step``'s step at that seed. Returns, per rank, per step
    seed: (the recomputed sites, the eager sites, the tape's paths, the
    eager sites' paths)."""
    import torch.distributed as dist

    from vaesne_tpu_torch.utils import rng

    mesh = current_mesh()
    loss_fn = tobj.as_loss(tobj.m_iwae, K=K)
    opt = ttr.adamw(1e-3)
    m = copy.deepcopy(model)
    state = ttr.TrainState.create(m, opt, device="cpu")
    run = ttr.make_scan_epoch(m, opt, loss_fn, device="cpu", mesh=mesh)
    with rng.recording(rng.SeedTape()) as tape:
        run(state, batch, torch.Generator().manual_seed(3), batch[0][0].shape[0])
    paths = [path for _, path, _ in tape.sites]
    out = []
    for step_seed in step_seeds:
        generators, words = tape.values(step_seed)
        by_path = dict(zip(tape.paths("word"), words))
        gens = iter(generators)
        replayed = [(kind, next(gens) if kind == "generator" else by_path[path])
                    for kind, path, _ in tape.sites]
        real = ttr.draw_seed
        ttr.draw_seed = lambda g: step_seed  # noqa: B023
        try:
            m = copy.deepcopy(model)
            state = ttr.TrainState.create(m, opt, device="cpu")
            step = ddp_train_step(m, opt, loss_fn, device="cpu", mesh=mesh)
            with rng.recording(rng.SeedTape()) as eager:
                step(state, batch)
        finally:
            ttr.draw_seed = real
        out.append((replayed, [(kind, v) for kind, _, v in eager.sites], paths,
                    [path for _, path, _ in eager.sites]))
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, out)
    return ranks


def dp_graph_checks(cases, shared_case, site_case):
    """``scan_epochs`` for each of ``cases`` and for ``shared_case``, then
    ``dp_step_sites`` for ``site_case``, in one launch."""
    return [scan_epochs(*c) for c in cases], scan_epochs(*shared_case), dp_step_sites(*site_case)


def contrastive_scan_epochs(cases):
    """``scan_epochs`` of InfoNCE (``objectives.as_loss(neg_info_nce)``,
    a batch mean) for each of ``cases``, (model, data, epochs, batch_size,
    accum_steps, skew), in one launch."""
    loss_fn = tobj.as_loss(tobj.neg_info_nce, temperature=0.1)
    return [scan_epochs(model, data, epochs, batch_size, None, "mean", accum_steps, False,
                        device="cpu", skew=skew, loss_fn=loss_fn)
            for model, data, epochs, batch_size, accum_steps, skew in cases]


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
