"""The port's contrastive and regression drivers on the CPU: ``train_loop``
with a frozen parameter subset (``opt_mask``) against the JAX package's
``optax.masked`` loop, the frozen subset kept out of AdamW,
``train_contrastive``, ``train_regression`` for every modality and backbone,
``eval_regression`` with its normalizing JSON, and the bridged shipped
regression head against the JAX package's evaluation of it."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.data as jdata
import vaesne_tpu.models as jmodels
import vaesne_tpu_torch.experiments.common as common
from vaesne_tpu import objectives as jobj
from vaesne_tpu import training as jtr
from vaesne_tpu.experiments import common as jcommon
from vaesne_tpu.experiments import train_regression as jreg
from vaesne_tpu.utils import config as jcfg
from vaesne_tpu_torch import InferenceServer, PhotometricVAE, TrainState, adamw, init_params
from vaesne_tpu_torch import objectives as tobj
from vaesne_tpu_torch.data import make_goldstein_like, photometry_tuple
from vaesne_tpu_torch.experiments import eval_regression, train_contrastive, train_regression
from vaesne_tpu_torch.models import VAERegressionHead
from vaesne_tpu_torch.training import make_train_step
from vaesne_tpu_torch.utils import fold_in, load_jax_params, to_jax_params
from vaesne_tpu_torch.utils import config as tcfg

from torch_parity import (  # noqa: F401
    ABSDIFF_FILE,
    NORMALIZING_FILE,
    export_port_checkpoint,
    rank_deadlines,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "artifacts")
ORBAX = os.path.join(ARTIFACTS, "ckpt", "goldstein_photometry2param_mmvae")
BRIDGED_ROOT = os.path.join(ARTIFACTS, "ckpt_torch")
BRIDGED = os.path.join(BRIDGED_ROOT, "goldstein_photometry2param_mmvae")
BACKBONE_CKPTS = {
    "mmvae": os.path.join(BRIDGED_ROOT, "goldstein_photospec_4-4_K2_beta1.0"),
    "contrast": os.path.join(BRIDGED_ROOT, "goldstein_contrastive_4-4_proj8"),
    "end2end": None,
}
# the shipped TPU evaluation of the head: a loose check only (TPU matmul precision)
SHIPPED_TPU = os.path.join(ARTIFACTS, "eval", "avg_absdiff_photometry2goldstein_param_mmvae.npz")
SMALL = dict(latent_len=2, latent_dim=2, model_dim=16, ff_dim=16, num_layers=2, num_heads=2)
TINY = ["model.latent_len=2", "model.latent_dim=2", "model.model_dim=16", "model.ff_dim=16",
        "model.num_layers=1", "model.num_heads=2", "proj_dim=3"]


def _npz(tmp_path, n=24):
    path = tmp_path / "goldstein.npz"
    if not path.exists():
        tmp_path.mkdir(parents=True, exist_ok=True)
        np.savez(path, **make_goldstein_like(n=n, seed=0, spectrum_bins=48,
                                              photometry_length=16))
    return str(path)


def _argv(tmp_path, *extra):
    return [f"data={_npz(tmp_path)}", "train.batch_size=8", "train.save_every=1",
            f"train.ckpt_dir={tmp_path / 'ck'}", f"train.log_dir={tmp_path / 'logs'}", *extra]


def _mse(m, batch, seed):
    x, y = batch
    return tobj.mse(m, x, y, seed=seed)


def test_two_masked_train_loop_steps_track_jax(tmp_path, monkeypatch):
    """A VAE head over a frozen photometric VAE, two AdamW steps (lr 1e-3,
    weight decay 1e-2, clip 10) from the same weights on the same batches
    (the shuffle pinned to the identity in both packages), dropout 0:
    the per-step losses within rtol 1e-5, the head's parameters within
    1e-5 of their largest entry, and the frozen backbone bitwise unchanged
    in both packages."""
    monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.arange(n))
    monkeypatch.setattr(torch, "randperm", lambda n, generator=None: torch.arange(n))
    data = make_goldstein_like(n=20, seed=2, spectrum_bins=48, photometry_length=16)
    idx = data["training_idx"][:16]
    y = np.random.default_rng(3).normal(size=(16, 4)).astype(np.float32)
    argv = ["train.batch_size=8", "train.epochs=1", "train.lr=1e-3", "train.mesh=none",
            f"train.ckpt_dir={tmp_path}", f"train.log_dir={tmp_path}"]
    jc = jcfg.parse_overrides(jcfg.RegressionConfig(mlp_hidden=(8, 8)), argv)
    tc = tcfg.parse_overrides(tcfg.RegressionConfig(mlp_hidden=(8, 8)), argv)

    vae = init_params(PhotometricVAE(num_bands=6, dropout=0.0, **SMALL),
                      torch.Generator().manual_seed(0))
    backbone = to_jax_params(vae)["params"]
    jhead = jmodels.VAERegressionHead(
        vae=jmodels.PhotometricVAE(num_bands=6, dropout=0.0, **SMALL), outdim=4,
        mlp_hidden=(8, 8))
    jx = jdata.photometry_tuple(data, idx=idx)
    k_init, _ = jax.random.split(jax.random.PRNGKey(jc.train.seed))
    start = {**jtr.init_model(jhead, jax.tree_util.tree_map(lambda a: a[:2], jx), k_init,
                              K=jc.train.K, has_sample_rng=False), "vae": backbone}
    jlosses = []

    def jloss(m, variables, batch, key):
        obj = jobj.mse(m, variables, batch[0], batch[1], key=key)
        jax.debug.callback(lambda v: jlosses.append(float(v)), obj, ordered=True)
        return obj

    frozen_j = {"vae": backbone}
    jstate, _ = jcommon.train_loop(
        jhead, (jx, jnp.asarray(y)), jloss, jc.train, has_sample_rng=False, init_data=jx,
        install_params=frozen_j, opt_mask=lambda p: jreg.frozen_param_mask(p, frozen_j),
        ckpt_name="jax", log=False)
    jax.effects_barrier()

    thead = VAERegressionHead(vae, 4, mlp_hidden=(8, 8))
    load_jax_params(thead, {"params": jax.tree_util.tree_map(np.asarray, start)})
    install = {k: v.clone() for k, v in thead.state_dict().items()}
    frozen_t = {k: v for k, v in install.items() if k.startswith("vae.")}
    tlosses = []

    def tloss(m, batch, seed):
        obj = _mse(m, batch, seed)
        tlosses.append(obj.item())
        return obj

    tstate, _ = common.train_loop(
        thead, (photometry_tuple(data, idx=idx, device="cpu"), torch.from_numpy(y)), tloss,
        tc.train, install_params=install,
        opt_mask=lambda m: train_regression.frozen_param_mask(m, frozen_t), ckpt_name="port",
        log=False, device="cpu")
    assert tstate.step == int(jstate.step) == 2 and len(tlosses) == len(jlosses) == 2
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    got = to_jax_params(thead)["params"]
    for path, want in jax.tree_util.tree_flatten_with_path(jstate.params["outfc"])[0]:
        g = got["outfc"]
        for k in path:
            g = g[k.key]
        want = np.asarray(want)
        start_leaf = np.asarray(start["outfc"][path[0].key][path[1].key])
        assert not np.array_equal(want, start_leaf)  # the head moved
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-5 * np.abs(want).max())
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params["vae"]),
                    jax.tree_util.tree_leaves(backbone)):
        np.testing.assert_array_equal(np.asarray(a), b)
    for name, value in frozen_t.items():
        assert torch.equal(thead.state_dict()[name], value), name


def _masked_state(weight_decay=0.5):
    head = init_params(VAERegressionHead(PhotometricVAE(num_bands=6, **SMALL), 4,
                                         mlp_hidden=(8,)), torch.Generator().manual_seed(0))
    frozen = {k: v.clone() for k, v in head.state_dict().items() if k.startswith("vae.")}
    mask = train_regression.frozen_param_mask(head, frozen)
    return head, frozen, TrainState.create(head, adamw(0.1, weight_decay=weight_decay),
                                           device="cpu", trainable=mask)


def test_a_frozen_parameter_is_never_handed_to_adamw():
    """The masked state's AdamW holds the head's parameters alone: a frozen
    parameter handed to it would be moved by the weight decay (here 0.5 at
    lr 0.1) even with a zero gradient. After two steps every frozen
    parameter is bitwise unchanged, has no gradient and no moments, and
    the checkpointed optimizer state holds moments for the head alone."""
    head, frozen, state = _masked_state()
    head_params = [p for n, p in head.named_parameters() if n.startswith("outfc.")]
    assert [id(p) for p in state.trainable_parameters()] == [id(p) for p in head_params]
    step = make_train_step(head, adamw(0.1, weight_decay=0.5), _mse, device="cpu")
    x = photometry_tuple(make_goldstein_like(n=8, seed=1, photometry_length=16),
                         device="cpu")
    for _ in range(2):
        state, _ = step(state, (x, torch.ones(8, 4)))
    for name, p in head.named_parameters():
        if name in frozen:
            assert torch.equal(p, frozen[name]) and p.grad is None and not p.requires_grad
            assert p not in state.optimizer.state
        else:
            assert len(state.optimizer.state[p]) == 3  # step, exp_avg, exp_avg_sq
    saved = state.state_dict()
    assert len(saved["optimizer"]["state"]) == len(head_params)
    assert saved["model"].keys() == head.state_dict().keys()


def test_the_trainable_mask_is_checked():
    """A mask that misses a parameter, names a stranger, or freezes all
    raises; no mask trains every parameter."""
    head, frozen, _ = _masked_state()
    mask = train_regression.frozen_param_mask(head, frozen)
    with pytest.raises(KeyError, match="every parameter"):
        TrainState.create(head, adamw(0.1), device="cpu",
                          trainable={k: v for k, v in mask.items() if k != "outfc.out.bias"})
    with pytest.raises(KeyError, match="every parameter"):
        TrainState.create(head, adamw(0.1), device="cpu", trainable={**mask, "nope": True})
    with pytest.raises(ValueError, match="every parameter"):
        TrainState.create(head, adamw(0.1), device="cpu", trainable=dict.fromkeys(mask, False))
    state = TrainState.create(head, adamw(0.1), device="cpu")
    assert len(state.trainable_parameters()) == len(mask)
    assert all(p.requires_grad for p in head.parameters())


def test_train_contrastive_resumes_bitwise_and_warns_on_accumulation(tmp_path):
    """train_contrastive at tiny widths, dropout 0.1 and the augmentation
    on: 2 epochs in one run equal 1 epoch and a resumed run to 2, bitwise;
    the checkpoint is tagged ContrastiveConfig under its JAX name; with
    accum_steps > 1 the driver warns that InfoNCE does not decompose."""
    whole, losses = train_contrastive.main(_argv(tmp_path / "a", *TINY, "train.epochs=2"),
                                           device="cpu")
    train_contrastive.main(_argv(tmp_path / "b", *TINY, "train.epochs=1"), device="cpu")
    resumed, resumed_losses = train_contrastive.main(
        _argv(tmp_path / "b", *TINY, "train.epochs=2", "train.resume=true"), device="cpu")
    assert resumed.step == whole.step == 4 and resumed_losses == losses
    assert all(np.isfinite(losses))
    for a, b in zip(whole.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    ckpt = tmp_path / "b" / "ck" / "goldstein_contrastive_2-2_proj3"
    assert json.loads((ckpt / "config.json").read_text())["_config_class"] == "ContrastiveConfig"
    with pytest.warns(UserWarning, match="not microbatch-decomposable"):
        train_contrastive.main(_argv(tmp_path / "c", *TINY, "train.epochs=1",
                                     "train.accum_steps=2"), device="cpu")


@pytest.mark.parametrize("backbone", ["mmvae", "contrast", "end2end"])
@pytest.mark.parametrize("modality", ["photometry", "spec"])
def test_train_regression_trains_the_head_and_freezes_the_backbone(tmp_path, modality,
                                                                    backbone):
    """train_regression for one epoch at the shipped widths (the backbone
    is rebuilt from its driver's default config, as in JAX) on a small
    npz: the frozen backbone equals its checkpoint bitwise and has no
    optimizer state, every head parameter moved, the normalizing JSON holds
    the JAX driver's standardisation, and the checkpoint sits under the
    JAX name, tagged RegressionConfig."""
    ckpt = BACKBONE_CKPTS[backbone]
    state, losses = train_regression.main(
        [f"modality={modality}", f"backbone={backbone}", *([f"backbone_ckpt={ckpt}"] if ckpt else []), *_argv(tmp_path, "train.epochs=1")],
        device="cpu")
    assert state.step == 2 and np.isfinite(losses).all()
    head, frozen = train_regression.build_head(modality, backbone, ckpt, 0)
    init_params(head, torch.Generator().manual_seed(fold_in(0, 0)))
    trainable = {id(p) for p in state.trainable_parameters()}
    moved = 0
    for name, p in state.model.named_parameters():
        if frozen and name in frozen:
            assert torch.equal(p, frozen[name]) and id(p) not in trainable, name
            assert p not in state.optimizer.state
        else:
            assert id(p) in trainable and not torch.equal(p, head.state_dict()[name]), name
            moved += 1
    assert moved == len(trainable)
    if frozen:
        assert {n.split(".", 1)[0] for n in frozen} == {"vae" if backbone == "mmvae"
                                                        else "contrastnet"}
    data = dict(np.load(_npz(tmp_path)))
    labels = jdata.goldstein_labels(data, np.asarray(data["training_idx"]))
    with open(tmp_path / "ck" / NORMALIZING_FILE) as f:
        norm = json.load(f)
    np.testing.assert_array_equal(norm["mean"], labels.mean(0).tolist())
    np.testing.assert_array_equal(norm["std"], (labels.std(0) + 1e-8).tolist())
    out = tmp_path / "ck" / f"goldstein_{modality}2param_{backbone}"
    assert json.loads((out / "config.json").read_text())["_config_class"] == "RegressionConfig"


def test_train_regression_resumes_bitwise(tmp_path):
    """A frozen-backbone run of 2 epochs equals 1 epoch and a resumed run
    to 2, bitwise: the checkpoint holds the whole head with moments for the
    trainable part alone, and the resume restores it."""
    args = ["modality=photometry", "backbone=mmvae",
            f"backbone_ckpt={BACKBONE_CKPTS['mmvae']}"]
    whole, losses = train_regression.main([*args, *_argv(tmp_path / "a", "train.epochs=2")],
                                           device="cpu")
    train_regression.main([*args, *_argv(tmp_path / "b", "train.epochs=1")], device="cpu")
    resumed, resumed_losses = train_regression.main(
        [*args, *_argv(tmp_path / "b", "train.epochs=2", "train.resume=true")], device="cpu")
    assert resumed.step == whole.step == 4 and resumed_losses == losses
    for a, b in zip(whole.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    saved = torch.load(tmp_path / "b" / "ck" / "goldstein_photometry2param_mmvae" / "state.pt",
                       weights_only=True)
    assert len(saved["optimizer"]["state"]) == len(whole.trainable_parameters())


def test_eval_regression_reads_the_normalizing_json(tmp_path):
    """eval_regression on a head train_regression wrote: absdiff [N_test, 4]
    in sigma units, saved with its means; the JSON the train driver wrote
    gives the result of the standardisation recomputed from the training
    split, within 1e-6 (float32 rounding); without a checkpoint a fresh head is evaluated."""
    args = ["modality=spec", "backbone=end2end"]
    train_regression.main([*args, *_argv(tmp_path, "train.epochs=1")], device="cpu")
    head = str(tmp_path / "ck" / "goldstein_spec2param_end2end")
    base = [*args, f"head_ckpt={head}", f"data={_npz(tmp_path)}", f"out={tmp_path / 'res'}"]
    absdiff = eval_regression.main([*base, f"train.ckpt_dir={tmp_path / 'ck'}"], device="cpu")
    recomputed = eval_regression.main([*base, f"train.ckpt_dir={tmp_path / 'none'}",
                                       f"out={tmp_path / 'res2'}"], device="cpu")
    n_test = len(np.load(_npz(tmp_path))["testing_idx"])
    assert absdiff.shape == (n_test, 4) and np.isfinite(absdiff).all()
    # the JSON's values standardise in float64, the recomputed ones in float32
    np.testing.assert_allclose(absdiff, recomputed, rtol=0, atol=1e-6)
    saved = np.load(tmp_path / "res" / "avg_absdiff_spec2goldstein_param_end2end.npz")
    np.testing.assert_array_equal(saved["absdiff"], absdiff)
    np.testing.assert_array_equal(saved["mean"], absdiff.mean(0))
    np.testing.assert_array_equal(saved["per_param"], absdiff.mean(0))
    fresh = eval_regression.main(["modality=photometry", "backbone=contrast",
                                  f"data={_npz(tmp_path)}", f"out={tmp_path / 'res'}"],
                                 device="cpu")
    assert fresh.shape == (n_test, 4) and np.isfinite(fresh).all()


@pytest.mark.parametrize("spec", ["4", "2x2"])
def test_eval_regression_refuses_a_multi_device_mesh(tmp_path, spec):
    """The single-device specs run in one process; a multi-rank mesh (its
    data axis divides the 256-event chunk) runs on gloo ranks and gives
    the one process's |error|, and rank 0 writes the file; a data axis
    that does not divide the chunk raises the JAX package's error."""
    one = [eval_regression.main(["backbone=end2end", f"mesh={ok}", f"data={_npz(tmp_path)}",
                                 f"out={tmp_path / 'res'}"], device="cpu")
           for ok in ("auto", "none", "1")][-1]
    got = eval_regression.main(["backbone=end2end", f"mesh={spec}", f"data={_npz(tmp_path)}",
                                f"out={tmp_path / spec}"], device="cpu")
    np.testing.assert_allclose(got, one, rtol=0, atol=1e-5)
    saved = np.load(tmp_path / spec / "avg_absdiff_photometry2goldstein_param_end2end.npz")
    np.testing.assert_array_equal(saved["absdiff"], got)
    with pytest.raises(ValueError, match="not divisible by data axis 3"):
        eval_regression.main(["backbone=end2end", "mesh=3", f"data={_npz(tmp_path)}"],
                             device="cpu")


def test_the_new_drivers_need_a_card_unless_the_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: train_contrastive.main(_argv(tmp_path, *TINY, "train.epochs=1")),
                lambda: train_regression.main(["backbone=end2end",
                                               *_argv(tmp_path, "train.epochs=1")]),
                lambda: eval_regression.main(["backbone=end2end", f"data={_npz(tmp_path)}"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_the_committed_bridge_is_the_orbax_checkpoint(tmp_path):
    """artifacts/ckpt_torch/goldstein_photometry2param_mmvae is
    export_port_checkpoint of the shipped Orbax head: the same config, the
    parameters bitwise (the whole MMVAE photometric VAE, decoder included,
    and the head), the normalizing JSON copied byte for byte, and the JAX
    eval_regression's absdiff within 1e-5 of its largest value (the JAX
    package itself moves it by 1.2e-5 between its default and 'highest'
    CPU matmul precision)."""
    export_port_checkpoint(ORBAX, str(tmp_path / "head"), "RegressionConfig")
    assert sorted(os.listdir(tmp_path / "head")) == sorted(os.listdir(BRIDGED))
    with open(tmp_path / "head" / "config.json") as f, open(
            os.path.join(BRIDGED, "config.json")) as g:
        assert f.read() == g.read()
    fresh = torch.load(tmp_path / "head" / "state.pt", weights_only=True)["model"]
    committed = torch.load(os.path.join(BRIDGED, "state.pt"), weights_only=True)["model"]
    assert fresh.keys() == committed.keys()
    assert any(k.startswith("vae.dec.") for k in committed)
    for k in fresh:
        assert torch.equal(fresh[k], committed[k]), k
    with open(tmp_path / NORMALIZING_FILE, "rb") as f, open(
            os.path.join(BRIDGED_ROOT, NORMALIZING_FILE), "rb") as g:
        assert f.read() == g.read()
    ref = np.load(os.path.join(BRIDGED, ABSDIFF_FILE))
    np.testing.assert_allclose(np.load(tmp_path / "head" / ABSDIFF_FILE), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_eval_regression_on_the_bridged_head_matches_jax(tmp_path):
    """The port's eval_regression on the bridged head, at the shipped
    widths on the CPU, with the copied normalizing JSON: absdiff within
    1e-5 of the largest value of the JAX package's (jax_absdiff.npy;
    measured 1.3e-5 absolute of 3.0, the MLP amplifying a 7e-7 relative
    difference in the VAE's posterior mean). The shipped TPU result, at the
    TPU's matmul precision, is only a loose check: per-parameter means
    within 0.02."""
    absdiff = eval_regression.main(
        ["modality=photometry", "backbone=mmvae", f"head_ckpt={BRIDGED}",
         f"train.ckpt_dir={BRIDGED_ROOT}", f"out={tmp_path}"], device="cpu")
    ref = np.load(os.path.join(BRIDGED, ABSDIFF_FILE))
    assert absdiff.shape == ref.shape == (103, 4)
    np.testing.assert_allclose(absdiff, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(absdiff.mean(0), np.load(SHIPPED_TPU)["mean"], rtol=0, atol=0.02)


def test_from_checkpoint_refuses_the_regression_head():
    with pytest.raises(ValueError, match="trained as RegressionConfig.*no serving"):
        InferenceServer.from_checkpoint(BRIDGED, device="cpu")
