"""The contrastive cell's own parts: its faults come out not correct, its
counts match counts made by hand, its weights repeat per seed, the trace
readers read its launch plan, and a port without the ``ctx attn`` counter
is refused at once.

The faults run the cell on the CPU at the benchmark tests' tiny size
(``conftest.TINY``: 256 spectral bins, so the spectra context's 257×257
self-attention stays on the kernels' route and its hash dropout; batch 4);
``test_bench_correct.py`` runs the sound cell and its control."""

from __future__ import annotations

import pytest
import torch

from benchmark import core, counts, trace
from benchmark.counts import contrastive
from benchmark.reference.contrastive_model import parameter_shapes

WORKLOAD = "contrastive-selfattn-b32"
CONFIG = core.load_json(core.BENCH / "configs" / "goldstein-contrastive-selfattn.json")
SHAPE = contrastive.shape_of(CONFIG)
DRIVER = core.load_module(core.BENCH / "drivers" / "contrastive_train_loop.py")
BIG = 2 ** 31 + 977


def _unchanged(monkeypatch):
    from vaesne_tpu_torch import training

    monkeypatch.setattr(training, "_clip_and_update", lambda state, optimizer, shard: None)


def _half_batch(monkeypatch):
    """InfoNCE over the first half of each batch alone."""
    from vaesne_tpu_torch import objectives

    head = objectives._info_nce_head

    def half(z1, z2, temperature=0.07):
        n = z1.shape[0] // 2
        return head(z1[:n], z2[:n], temperature)

    monkeypatch.setattr(objectives, "_info_nce_head", half)


def _context_gradient_doubled(monkeypatch):
    """The context self-attention's output gradient doubled, its forward
    unchanged: a fault confined to the context branch's leaves, which the
    median leaf's gradient gap does not see and the worst leaf's does."""
    from vaesne_tpu_torch.nn import layers

    init = layers.TransformerBlock.__init__

    def doubled(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if self.context_self_attn is not None:
            self.context_self_attn.register_forward_hook(lambda m, i, o: 2 * o - o.detach())

    monkeypatch.setattr(layers.TransformerBlock, "__init__", doubled)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _context_gradient_doubled],
                         ids=["unchanged", "half_batch", "context_gradient_doubled"])
def test_the_contrastive_cells_faults_are_not_correct(tiny_cell, monkeypatch, fault):
    from benchmark import run

    fault(monkeypatch)
    cell = tiny_cell(WORKLOAD)
    out = DRIVER.run(cell)
    result = run.assemble(core.spec(), WORKLOAD, dict(out, profile=None), core, trace)
    assert not result["correct"], out["checks"]
    if fault is _context_gradient_doubled:
        gap = {k: c["value"] > c["limit"] for k, c in out["checks"].items()}
        assert gap["grad_gap"] and not gap["grad_median_gap"] and not gap["first_loss_gap"]
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_the_controls_read_over_the_sound_run(tiny_cell):
    """At this size the TF32 control's first loss gap stands far over the
    sound run's, its worst leaf's gradient gap over the limit that the sound
    run's stays under, the half batch's loss gap over the limit, and the
    unchanged state's change gap reads 1."""
    cell = tiny_cell(WORKLOAD)
    sound = DRIVER.run(cell)["readings"]
    c = DRIVER.controls(cell)
    assert c["control"]["first_loss_gap"] >= 10 * max(sound["first_loss_gap"], 1e-9)
    assert sound["grad_gap"] < cell.limits["grad_gap"] < c["control"]["grad_gap"]
    assert c["half_batch"]["loss_gap"] > cell.limits["loss_gap"]
    assert c["unchanged"]["change_gap"] == 1.0


def test_a_program_that_decides_an_undetermined_relu_input_the_other_way_is_sound(
        tiny_cell, monkeypatch):
    """ReLU's derivative steps at zero, so a sound program whose event ReLU
    input lies within round-off of zero may take the other side from the
    reference, and its gradient then moves by that input's whole share. The
    reference follows both sides of each undetermined input: a trajectory
    flipped at one (here the reference's own, standing in for the program)
    reads as the reference against the nearest of them, and not against the
    unflipped one. The band is widened here so that the tiny cell has such
    inputs."""
    from benchmark import program
    from benchmark.reference import contrastive_train as reference

    monkeypatch.setattr(reference, "UNDETERMINED", 5e-3)
    monkeypatch.setattr(reference, "BRANCHES", 3)
    cell = tiny_cell(WORKLOAD)
    raw = program.data(cell.config, cell.seed)
    params = DRIVER.weights(cell.config, cell.seed, torch.device("cpu"))
    train_seed = core.derive(cell.seed, 1)
    refs = reference.record_branches(params, raw, cell.config, train_seed)
    first = [u for u in refs[0]["undetermined"] if u[0] == 1][0]
    assert refs[1]["flips"] == (refs[0]["undetermined"][0],)
    flipped = reference.record(params, raw, cell.config, train_seed, flips=(first,))
    assert flipped["loss"][0] == refs[0]["loss"][0]
    against_one = DRIVER.compare(flipped, refs[0])
    assert against_one["grad_gap"] > cell.limits["grad_gap"]
    readings = DRIVER.nearest(flipped, refs, cell.limits)
    assert all(readings[k] == 0.0 for k in cell.limits), readings


def test_a_port_without_the_ctx_attn_counter_is_refused(tiny_cell, monkeypatch):
    from vaesne_tpu_torch.ops import counters

    monkeypatch.setattr(counters, "COUNTERS",
                        {k: v for k, v in counters.COUNTERS.items() if k != "ctx attn"})
    with pytest.raises(RuntimeError, match="ctx attn"):
        DRIVER.run(tiny_cell(WORKLOAD))


def test_a_block_with_context_self_attention_by_hand():
    E, F, L = 32, 32, 4
    n = 983  # the spectrum's 982 bins and the phase token
    bottleneck = (4 * 2 * E * E * L + 4 * L * L * E          # self-attention of the L tokens
                  + 2 * 2 * E * E * L + 2 * 2 * E * E * n + 4 * L * n * E  # cross to the context
                  + 2 * 2 * E * F * L)                        # the feed-forward
    context = 4 * 2 * E * E * n + 4 * n * n * E               # q, k, v, out; QKᵀ and PV
    assert contrastive.block_flops(SHAPE, n) == bottleneck + context == 136_334_976
    plain = SHAPE._replace(selfattn=False)
    assert contrastive.block_flops(plain, n) == bottleneck


def test_infonce_head_and_step_flops_by_hand():
    E, F, L, D, n = 32, 32, 4, 4, 60
    embed = 2 * E * n + n * (2 * 2 * E * E + 2 * E * E) + 2 * 3 * E * E * n + 2 * E * E * n
    block = (4 * 2 * E * E * L + 4 * L * L * E + 2 * 2 * E * E * L + 2 * 2 * E * E * n
             + 4 * L * n * E + 2 * 2 * E * F * L + 4 * 2 * E * E * n + 4 * n * n * E)
    head = 2 * E * E * L + 2 * E * D * L + 2 * 16 * 16 + 2 * 16 * 8  # bottleneckfc, projection
    photo = embed + 4 * block + head
    assert contrastive.tower_flops(SHAPE, "photo") == photo
    assert contrastive.info_nce_flops(SHAPE, 32) == 2 * 32 * 32 * 8
    towers = photo + contrastive.tower_flops(SHAPE, "spec")
    assert contrastive.train_step_flops(SHAPE, 32) == 3 * (32 * towers + 2 * 32 * 32 * 8)


def test_only_the_spectra_context_goes_to_the_kernels():
    grids = contrastive.kernel_grids(SHAPE, "photo", 32) + contrastive.kernel_grids(SHAPE,
                                                                                    "spec", 32)
    assert [(g.rows, g.lq, g.lk, g.masked) for g in grids] == [(32, 983, 983, True)] * 4
    assert len(contrastive.context_attentions(SHAPE, 32)) == 8
    assert contrastive.context_attentions(SHAPE._replace(selfattn=False), 32) == []


def test_weights_repeat_per_seed_and_are_the_ports_parameters():
    from vaesne_tpu_torch.experiments import train_contrastive
    from vaesne_tpu_torch.utils.config import ContrastiveConfig, parse_overrides

    cfg = parse_overrides(ContrastiveConfig(), ["model.selfattn=true"])
    model = train_contrastive.build_model(cfg)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == parameter_shapes(CONFIG)
    assert sum(v.numel() for v in model.parameters()) == 137_656
    w1, w2 = (DRIVER.weights(CONFIG, BIG, torch.device("cpu")) for _ in range(2))
    assert w1.keys() == parameter_shapes(CONFIG).keys()
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert w1["spectra_encoder.blocks.block_2.layernorm_context.weight"].eq(1).all()
    assert w1["photo_proj.fc1.weight"].abs().max() <= 1.0 / 4.0  # U(±1/√16)
    w3 = DRIVER.weights(CONFIG, BIG + 1, torch.device("cpu"))
    assert not torch.equal(w1["spectra_encoder.initbottleneck"],
                           w3["spectra_encoder.initbottleneck"])


class _Prof:
    """A traced sub-window as the readers see it."""

    def __init__(self, kernels, busy_s=1.0):
        self.kernels, self.busy_s, self.config = kernels, busy_s, CONFIG
        grid = contrastive.kernel_grids(SHAPE, "spec", 32)[0]
        self.work = {"dtype": "fp32",
                     "launches": {"K1": [(grid, True, 8)], "K2": [(grid, None, 4)]}}

    def kernel_seconds(self, *names):
        return trace.Profile.kernel_seconds(self, *names)


KERNELS = {"attention_fwd_kernel_pipelined<float, 8, 1>": (0.002, 8),
           "attention_bwd_kernel_pipelined<float, 8, 1>": (0.003, 4),
           "vaesne_layer_norm_fwd_kernel<32>": (0.5, 12)}


def _reader(name):
    return core.load_module(core.BENCH / "metrics" / f"{name}.py").read


def test_the_attention_kernels_share_is_k1_and_k2_over_the_busy_time():
    # one step's 8 K1 and 4 K2 launches of the spectra context's 983x983 grid
    assert _reader("attn_kernels_pct.contrast")(_Prof(KERNELS)) == pytest.approx(0.5)
    assert _reader("attn_kernels_pct.contrast")(_Prof(KERNELS, busy_s=0.0)) is None


def test_attention_rooflines_read_the_contrastive_plan():
    """The training cells' K1 and K2 roofline readers size the contrastive
    plan's grids from its configuration's widths and heads."""
    prof = _Prof(KERNELS)
    flops, nbytes = counts.attention_fwd(32, 983, 983, 32, 4, True, True)
    assert _reader("k1_roofline_pct.train")(prof) == \
        pytest.approx(100.0 * 8 * counts.bound_s(nbytes, flops) / 0.002)
    flops, nbytes = counts.attention_bwd(32, 983, 983, 32, 4)
    assert _reader("k2_roofline_pct.train")(prof) == \
        pytest.approx(100.0 * 4 * counts.bound_s(nbytes, flops) / 0.003)
    grid = prof.work["launches"]["K1"][0][0]
    prof.work["launches"]["K1"] = [(grid, True, 7)]
    assert _reader("k1_roofline_pct.train")(prof) is None
