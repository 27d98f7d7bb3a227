"""The port's contrastive two-tower network against the benchmark's plain
reference (``benchmark/reference/contrastive_model.py``) on the CPU at a
small size, and the ``ctx attn`` counter of ``TransformerBlock``'s context
self-attention.

Six events of 48 spectral bins and 12 light-curve points (the benchmark's
synthetic Goldstein-like data), latent 4×4, model_dim 8, 2 heads, 2 layers,
projections of 8, InfoNCE at τ 0.1; one case at 256 bins puts the spectra
context's 257×257 self-attention on the kernels' route, whose dropout is
the counter hash. At dropout 0.1 the step's seed reaches every dropout site
on both sides.

At the port's initialisation the towers are nearly collapsed: the learned
bottleneck tokens, the same for every event, outweigh what the
cross-attention brings from the data, so the normalised projections of
different events differ by 0.2–2%. InfoNCE's gradient with respect to a
projection is a sum over the batch of the other projections, weighted by
terms that sum to zero, so it scales with that spread, and where the spread
is small it is a difference of near-equal terms. The test's weights are
therefore moved off the initialisation so that the projections spread: the
linear layers' biases are 0 and the cross-attentions' value and output
projections are scaled by 4, which spreads them by 10–30%
(``test_the_projections_are_spread``).

Tolerances, fp32 on both sides: the projections within 1e-5 of their
largest magnitude, the objective within 1e-6 relative, and each
parameter's gradient within 1e-4 of the largest gradient norm of the
model, in norm (a parameter whose gradient vanishes, as a key projection's
bias does under the softmax, carries the round-off of the large ones).
"""

import pytest
import torch

from benchmark import datagen
from benchmark.reference.contrastive_model import ContrastiveNet, info_nce, parameter_shapes
from vaesne_tpu_torch import TrainState, adamw, init_params, objectives
from vaesne_tpu_torch.data import multimodal_tuple
from vaesne_tpu_torch.experiments import common, train_contrastive
from vaesne_tpu_torch.nn import TransformerStack
from vaesne_tpu_torch.nn.layers import TransformerBlock
from vaesne_tpu_torch.ops import counters
from vaesne_tpu_torch.training import make_scan_epoch
from vaesne_tpu_torch.utils.config import ContrastiveConfig, parse_overrides

SMALL = ["model.model_dim=8", "model.ff_dim=8", "model.num_layers=2", "model.num_heads=2"]
TEMPERATURE = 0.1
Z_TOL = 1e-5
OBJECTIVE_RTOL = 1e-6
GRAD_TOL = 1e-4
SEED = 2 ** 31 - 11


def reference_config(cfg):
    """The reference's view of a ``ContrastiveConfig``."""
    m = cfg.model
    return {"model": {"latent_len": m.latent_len, "latent_dim": m.latent_dim,
                      "model_dim": m.model_dim, "num_heads": m.num_heads, "ff_dim": m.ff_dim,
                      "num_layers": m.num_layers, "dropout": m.dropout, "selfattn": m.selfattn},
            "num_bands": cfg.num_bands, "proj_dim": cfg.proj_dim}


def _model(cfg, seed=8):
    """The port's initialisation, with the linear layers' biases at 0 and
    the cross-attentions' value and output projections scaled by 4."""
    model = init_params(train_contrastive.build_model(cfg), torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") and "layernorm" not in name:
                p.zero_()
            elif "cross_attn.v_proj.weight" in name or "cross_attn.out_proj.weight" in name:
                p.mul_(4.0)
    return model.train()


def _batch(bins, events=6):
    raw = datagen.make_goldstein_like(n=16, seed=3, spectrum_bins=bins, photometry_length=12)
    train, _ = common.split_tuples(raw, multimodal_tuple, "cpu")
    return tuple(tuple(a[:events] for a in m) for m in train)


def _spread(z):
    """The mean distance of the normalised projections from their mean."""
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    return torch.linalg.vector_norm(z - z.mean(0), dim=-1).mean().item()


CASES = [(True, 0.0, 48), (True, 0.1, 48), (False, 0.0, 48), (False, 0.1, 48), (True, 0.1, 256)]


@pytest.mark.parametrize("selfattn, dropout, bins", CASES,
                         ids=["selfattn", "selfattn-dropout", "plain", "plain-dropout",
                              "selfattn-dropout-kernel-route"])
def test_projections_infonce_and_every_gradient_match_the_reference(selfattn, dropout, bins):
    cfg = parse_overrides(ContrastiveConfig(), [*SMALL, f"model.selfattn={selfattn}",
                                                f"model.dropout={dropout}"])
    model = _model(cfg)
    config = reference_config(cfg)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == parameter_shapes(config)
    batch = _batch(bins)

    z_mine = model(batch, seed=SEED)
    mine = objectives.neg_info_nce(model, batch, temperature=TEMPERATURE, seed=SEED)
    (-mine).backward()
    params = {k: v.detach().clone().requires_grad_() for k, v in model.named_parameters()}
    net = ContrastiveNet(params, config, training=True)
    z_theirs = net.projections(batch, SEED)
    theirs = info_nce(net, *z_theirs, TEMPERATURE)
    (-theirs).backward()

    for a, b in zip(z_mine, z_theirs):
        assert (a - b).abs().max().item() <= Z_TOL * b.abs().max().item()
    assert abs(mine.item() - theirs.item()) <= OBJECTIVE_RTOL * abs(theirs.item())
    grads = {k: p.grad for k, p in model.named_parameters()}
    scale = max(torch.linalg.vector_norm(p.grad).item() for p in params.values())
    worst = max(grads, key=lambda k: torch.linalg.vector_norm(grads[k] - params[k].grad).item())
    gap = torch.linalg.vector_norm(grads[worst] - params[worst].grad).item()
    assert gap <= GRAD_TOL * scale, (worst, gap, scale)


def test_the_projections_are_spread():
    """The test's weights spread the projections (so the gradients above
    are not round-off); the port's initialisation leaves them nearly
    collapsed, and the reference sees the dropout: another seed moves its
    objective."""
    cfg = parse_overrides(ContrastiveConfig(), [*SMALL, "model.selfattn=true"])
    batch = _batch(48)
    with torch.no_grad():
        spread = [_spread(z) for z in _model(cfg).eval()(batch)]
        at_init = init_params(train_contrastive.build_model(cfg),
                              torch.Generator().manual_seed(8)).eval()
        collapsed = [_spread(z) for z in at_init(batch)]
    assert min(spread) >= 0.1 and max(collapsed) <= 0.02, (spread, collapsed)
    params = {k: v.detach() for k, v in _model(cfg).named_parameters()}
    config = reference_config(cfg)
    values = []
    for train, seed in ((True, 1), (True, 2), (False, None)):
        net = ContrastiveNet(params, config, training=train)
        values.append(info_nce(net, *net.projections(batch, seed), TEMPERATURE).item())
    assert len(set(values)) == 3


def _ctx_attn(fn):
    """``fn``'s move of the ``ctx attn`` counter; no LayerNorm took
    ``F.layer_norm`` on the card's route."""
    before = counters.launch_counts()
    fn()
    after = counters.launch_counts()
    assert after["LN plain"] == before["LN plain"]
    return after["ctx attn"] - before["ctx attn"]


def test_each_context_self_attention_adds_one_to_ctx_attn():
    """A block's context self-attention adds one to ``ctx attn`` a run: one
    a forward, two over a remat'd forward and backward (the re-run counts),
    none for a block or a stack without it."""
    x, context = torch.randn(2, 4, 8), torch.randn(2, 10, 8)
    block = TransformerBlock(8, 2, 8, 0.0, context_self_attn=True)
    assert _ctx_attn(lambda: block(x, context)) == 1
    assert _ctx_attn(lambda: TransformerBlock(8, 2, 8, 0.0)(x, context)) == 0
    for selfattn, want in ((True, 2), (False, 0)):
        stack = TransformerStack(8, 2, 8, 1, 0.0, context_self_attn=selfattn, remat=True)
        leaf = x.clone().requires_grad_()
        assert _ctx_attn(lambda: stack(leaf, context).sum().backward()) == want


def test_a_replay_adds_its_captures_ctx_attn():
    """The ``ctx attn`` counter moves with the others: set, and added to as
    a replay adds its capture's launches."""
    counts = counters.launch_counts()
    try:
        counters.set_launch_counts({"ctx attn": 10})
        counters.add_launch_counts({"ctx attn": 16, "K1": 0})
        after = counters.launch_counts()
        assert after["ctx attn"] == counters.ctx_attn_calls == 26
        assert {k: v for k, v in after.items() if k != "ctx attn"} == {
            k: v for k, v in counts.items() if k != "ctx attn"}
    finally:
        counters.set_launch_counts({"ctx attn": counts["ctx attn"]})
    assert counters.launch_counts() == counts


@pytest.mark.parametrize("selfattn", [True, False], ids=["selfattn", "plain"])
def test_every_step_of_a_contrastive_epoch_counts_its_context_attentions(selfattn):
    """Three one-step epochs of ``make_scan_epoch`` over the two towers
    (the capture-ready step, eager on the CPU): each step adds two towers ×
    2 layers × 2 (the forward and remat's re-run) to ``ctx attn`` with the
    context self-attention, none without it."""
    cfg = parse_overrides(ContrastiveConfig(), [*SMALL, f"model.selfattn={selfattn}"])
    model = _model(cfg)
    assert model.spectra_encoder.blocks.remat
    opt = adamw(1e-3)
    state = TrainState.create(model, opt, seed=0, device="cpu")
    epoch = make_scan_epoch(model, opt, objectives.as_loss(objectives.neg_info_nce,
                                                           temperature=TEMPERATURE),
                            device="cpu")
    batch = _batch(48, events=4)
    steps = []
    for i in range(3):
        before = counters.launch_counts()["ctx attn"]
        state, loss = epoch(state, batch, torch.Generator().manual_seed(i), 4)
        steps.append(counters.launch_counts()["ctx attn"] - before)
        assert torch.isfinite(torch.as_tensor(loss))
    assert steps == [2 * 2 * 2 * selfattn] * 3, steps
