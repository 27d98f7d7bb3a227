"""The port's training drivers on the CPU: one epoch of ``train_loop``
against the JAX package's, kill-and-resume through ``main``, the resume
geometry checks, ``InferenceServer.from_checkpoint`` for every servable
config, and what the drivers refuse."""

import copy
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.data as jdata
import vaesne_tpu_torch.experiments.common as common
from vaesne_tpu import objectives as jobj
from vaesne_tpu import training as jtr
from vaesne_tpu.experiments import common as jcommon
from vaesne_tpu.experiments import train_photospectra as jdriver
from vaesne_tpu.utils import config as jcfg
from vaesne_tpu_torch import InferenceServer, TrainState, init_params, make_train_step
from vaesne_tpu_torch import objectives as tobj
from vaesne_tpu_torch.data import make_goldstein_like, make_ztf_like, multimodal_tuple
from vaesne_tpu_torch.experiments import (
    train_photometry,
    train_photospectra,
    train_spectra,
    train_ztf_photospect,
    train_ztf_spectra,
)
from vaesne_tpu_torch.training import make_scan_epoch, train_epoch
from vaesne_tpu_torch.utils import load_jax_params, to_jax_params
from vaesne_tpu_torch.utils import config as tcfg

from torch_parity import fixed_noise, rank_deadlines  # noqa: F401

TINY = ["model.latent_len=2", "model.latent_dim=2", "model.model_dim=16", "model.ff_dim=16",
        "model.num_layers=1", "model.num_heads=2"]


def _npz(tmp_path, kind="goldstein", n=24):
    maker = make_goldstein_like if kind == "goldstein" else make_ztf_like
    path = tmp_path / f"{kind}.npz"
    if not path.exists():
        tmp_path.mkdir(parents=True, exist_ok=True)
        np.savez(path, **maker(n=n, seed=0, spectrum_bins=48, photometry_length=16))
    return str(path)


def _argv(tmp_path, *extra, kind="goldstein"):
    return [f"data={_npz(tmp_path, kind)}", *TINY, "train.batch_size=8", "train.save_every=1",
            f"train.ckpt_dir={tmp_path / 'ck'}", f"train.log_dir={tmp_path / 'logs'}", *extra]


def test_one_epoch_tracks_the_jax_train_loop(tmp_path, monkeypatch, fixed_noise):
    """The same data and initial weights (the JAX initialisation bridged
    into install_params), dropout 0, no augmentation, the shuffle pinned to
    the identity in both packages and the posterior noise pinned: the
    per-step objectives agree within rtol 1e-5, the parameters within 2%
    of the distance they travelled (as test_three_adamw_steps_track_jax)."""
    argv = TINY + ["model.dropout=0", "train.batch_size=4", "train.epochs=1", "train.lr=1e-3",
                   "train.mesh=none", f"train.ckpt_dir={tmp_path}", f"train.log_dir={tmp_path}"]
    data = make_goldstein_like(n=20, seed=2, spectrum_bins=48, photometry_length=16)
    idx = data["training_idx"]
    K = 2
    monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.arange(n))
    monkeypatch.setattr(torch, "randperm", lambda n, generator=None: torch.arange(n))

    jc = jcfg.parse_overrides(jcfg.PhotoSpectraMMVAEConfig(), argv)
    jm = jdriver.build_model(jc)
    jtrain = jdata.multimodal_tuple(data, idx=idx)
    example = jax.tree_util.tree_map(lambda a: a[:2], jtrain)
    k_init, _ = jax.random.split(jax.random.PRNGKey(jc.train.seed))
    start = jtr.init_model(jm, example, k_init, K=K)
    jlosses = []

    def jloss(m, variables, batch, key):
        obj = jobj.m_iwae(m, variables, batch, K=K, key=key, deterministic=False)
        jax.debug.callback(lambda v: jlosses.append(float(v)), obj, ordered=True)
        return obj

    jstate, jepochs = jcommon.train_loop(jm, jtrain, jloss, jc.train, ckpt_name="jax",
                                         log=False)
    jax.effects_barrier()

    tc = tcfg.parse_overrides(tcfg.PhotoSpectraMMVAEConfig(), argv)
    tm = train_photospectra.build_model(tc)
    load_jax_params(tm, {"params": jax.tree_util.tree_map(np.asarray, start)})
    install = {k: v.clone() for k, v in tm.state_dict().items()}
    tlosses = []

    def tloss(m, batch, seed):
        obj = tobj.m_iwae(m, batch, K, seed=seed)
        tlosses.append(obj.item())
        return obj

    tstate, tepochs = common.train_loop(
        tm, multimodal_tuple(data, idx=idx, device="cpu"), tloss, tc.train, ckpt_name="port",
        install_params=install, log=False, device="cpu")
    assert len(tlosses) == len(jlosses) == 4 and tstate.step == int(jstate.step) == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(tepochs, jepochs, rtol=1e-5)
    got = dict(jax.tree_util.tree_flatten_with_path(to_jax_params(tm)["params"])[0])
    want = dict(jax.tree_util.tree_flatten_with_path(jstate.params)[0])
    first = dict(jax.tree_util.tree_flatten_with_path(start)[0])
    assert got.keys() == want.keys()
    err = sum(float(((got[p] - np.asarray(want[p])) ** 2).sum()) for p in want)
    travelled = sum(float(((np.asarray(first[p]) - np.asarray(want[p])) ** 2).sum())
                    for p in want)
    assert err ** 0.5 <= 2e-2 * travelled ** 0.5, (err, travelled)


def _params(state):
    return [p.detach().clone() for p in state.model.parameters()]


def test_kill_and_resume_equals_an_uninterrupted_run(tmp_path):
    """Through main, dropout 0.1 and augmentation on: 3 epochs in one run,
    and 2 epochs then a resumed run to 3, are bitwise the same run."""
    whole, losses = train_photospectra.main(
        _argv(tmp_path / "a", "train.epochs=3"), device="cpu")
    train_photospectra.main(_argv(tmp_path / "b", "train.epochs=2"), device="cpu")
    resumed, resumed_losses = train_photospectra.main(
        _argv(tmp_path / "b", "train.epochs=3", "train.resume=true"), device="cpu")
    assert resumed.step == whole.step == 6  # 19 training events, batch 8
    assert resumed_losses == losses and len(losses) == 3
    for a, b in zip(_params(whole), _params(resumed)):
        assert torch.equal(a, b)
    ckpt = tmp_path / "b" / "ck" / "goldstein_photospec_2-2_K2_beta1.0"
    assert sorted(os.listdir(ckpt)) == ["config.json", "losses.npy", "progress.json", "state.pt"]
    assert json.loads((ckpt / "progress.json").read_text()) == {"epochs_done": 3}
    assert list(np.load(ckpt / "losses.npy")) == losses
    assert json.loads((ckpt / "config.json").read_text())["_config_class"] == \
        "PhotoSpectraMMVAEConfig"


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_scan_epoch_and_the_step_loop_are_one_run(accum_steps):
    """make_scan_epoch's capture-ready epoch (static batch buffers, the
    step body a CUDA graph captures on the card, run eagerly here) and
    train_epoch over make_train_step: from the same weights, data and
    seeds both give bitwise the same epoch (dropout on): parameters, AdamW
    moments and loss, with and without gradient accumulation."""
    cfg = tcfg.parse_overrides(tcfg.PhotoSpectraMMVAEConfig(), TINY)
    data = multimodal_tuple(make_goldstein_like(n=24, seed=0, spectrum_bins=48,
                                                photometry_length=16), device="cpu")
    model = train_photospectra.build_model(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    opt = common.optimizer_from_config(cfg.train)

    def loss_fn(m, batch, seed):
        return tobj.m_iwae(m, batch, 2, seed=seed)

    runs = []
    for scan in (True, False):
        m = copy.deepcopy(model)
        state = TrainState.create(m, opt, seed=1, device="cpu")
        if scan:
            epoch = make_scan_epoch(m, opt, loss_fn, accum_steps, device="cpu")
            runs.append(epoch(state, data, torch.Generator().manual_seed(2), 8))
        else:
            step = make_train_step(m, opt, loss_fn, accum_steps, device="cpu")
            runs.append(train_epoch(state, step, data, 8, torch.Generator().manual_seed(2)))
    (scan_state, scan_loss), (loop_state, loop_loss) = runs
    assert scan_state.step == loop_state.step == 3 and scan_loss == loop_loss
    for a, b in zip(_params(scan_state), _params(loop_state)):
        assert torch.equal(a, b)
    moments = [(x, y) for sa, sb in zip(scan_state.optimizer.state.values(),
                                        loop_state.optimizer.state.values())
               for x, y in zip(sa.values(), sb.values())]
    assert moments and all(torch.equal(x, y) for x, y in moments)


def test_resume_geometry_checks(tmp_path):
    """A progress record that lags the state, or is corrupt, resumes from
    the state's step; one ahead of it, or another batch size, raises."""
    argv = _argv(tmp_path, "train.epochs=2")
    train_photospectra.main(argv, device="cpu")
    ckpt = tmp_path / "ck" / "goldstein_photospec_2-2_K2_beta1.0"
    (ckpt / "progress.json").write_text(json.dumps({"epochs_done": 1}))
    state, losses = train_photospectra.main(argv[:-1] + ["train.epochs=3", "train.resume=true"],
                                            device="cpu")
    assert state.step == 6 and len(losses) == 3
    (ckpt / "progress.json").write_text('{"epochs_do')
    state, _ = train_photospectra.main(argv[:-1] + ["train.epochs=4", "train.resume=true"],
                                       device="cpu")
    assert state.step == 8
    (ckpt / "progress.json").write_text(json.dumps({"epochs_done": 9}))
    with pytest.raises(ValueError, match="geometry mismatch"):
        train_photospectra.main(argv[:-1] + ["train.epochs=5", "train.resume=true"],
                                device="cpu")
    with pytest.raises(ValueError, match="batch_size=8"):
        train_photospectra.main(argv[:-1] + ["train.epochs=5", "train.resume=true",
                                             "train.batch_size=4"], device="cpu")


SERVABLE = [
    ("PhotoSpectraMMVAEConfig", train_photospectra, "goldstein", (), 0),
    ("PhotoSpectraMMVAEConfig", train_photospectra, "goldstein", ("model.bright=true",), 1),
    ("ZTFMMVAEConfig", train_ztf_photospect, "ztf", ("repeat_factor=1", "train.K=2"), 0),
    ("SpectraVAEConfig", train_spectra, "goldstein", (), None),
    ("ZTFSpectraConfig", train_ztf_spectra, "ztf", ("repeat_factor=1",), None),
    ("PhotometryVAEConfig", train_photometry, "goldstein", (), None),
]


@pytest.mark.parametrize("name,driver,kind,extra,modality", SERVABLE,
                         ids=[f"{s[0]}{'-bright' if s[3][:1] == ('model.bright=true',) else ''}"
                              for s in SERVABLE])
def test_from_checkpoint_serves_the_trained_model(tmp_path, name, driver, kind, extra, modality):
    """Each driver trains one epoch; the server rebuilt from its checkpoint
    directory embeds as a server over the in-memory model does."""
    state, _ = driver.main(_argv(tmp_path, "train.epochs=1", *extra, kind=kind), device="cpu")
    (ckpt,) = [d for d in (tmp_path / "ck").iterdir()]
    assert json.loads((ckpt / "config.json").read_text())["_config_class"] == name
    served = InferenceServer.from_checkpoint(str(ckpt), buckets=(4,), device="cpu")
    direct = InferenceServer(state.model, buckets=(4,), device="cpu")
    assert type(served._model) is type(state.model)
    data = np.load(_npz(tmp_path, kind))
    photo, spec = (tuple(t.numpy() for t in m)
                   for m in multimodal_tuple(data, idx=np.arange(3), device="cpu"))
    if modality is None:  # unimodal: the driver's own modality
        x = photo if driver is train_photometry else spec
        assert torch.equal(served.embed(x), direct.embed(x))
        with pytest.raises(ValueError, match="multimodal"):
            served.crossmodal(x, x)
    else:
        x = (photo, spec)[modality]
        assert torch.equal(served.embed(x, modality=modality),
                           direct.embed(x, modality=modality))
        g = [torch.Generator().manual_seed(1) for _ in range(2)]
        assert torch.equal(served.crossmodal(photo, spec, K=2, generator=g[0]),
                           direct.crossmodal(photo, spec, K=2, generator=g[1]))


def test_from_checkpoint_refuses_an_unservable_config(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"_config_class": "ContrastiveConfig"}))
    with pytest.raises(ValueError, match="no serving dispatch entry"):
        InferenceServer.from_checkpoint(str(tmp_path), device="cpu")


def _loop(tmp_path, **kw):
    cfg = tcfg.parse_overrides(tcfg.PhotoSpectraMMVAEConfig(), TINY + [
        "train.batch_size=4", "train.epochs=1", f"train.ckpt_dir={tmp_path}",
        f"train.log_dir={tmp_path}"] + kw.pop("argv", []))
    data = make_goldstein_like(n=10, seed=0, spectrum_bins=24, photometry_length=8)
    return common.train_loop(
        train_photospectra.build_model(cfg), multimodal_tuple(data, device="cpu"),
        tobj.as_loss(tobj.m_iwae, K=2), cfg.train, log=False,
        device=kw.pop("device", "cpu"), **kw)


@pytest.mark.parametrize("spec", ["4", "2x2", "8x1"])
def test_a_multi_device_mesh_raises(tmp_path, spec):
    """A mesh whose data axis divides the batch (4 events) trains on gloo
    ranks, data-parallel ("4") or with Megatron tensor parallelism
    ("2x2"), and follows the one-process run; one that does not ("8x1")
    raises the JAX package's error before any rank starts."""
    if spec == "8x1":
        with pytest.raises(ValueError, match="not divisible by the mesh data axis"):
            _loop(tmp_path, argv=[f"train.mesh={spec}"])
        return
    state, losses = _loop(tmp_path / spec, argv=[f"train.mesh={spec}"])
    one, one_losses = _loop(tmp_path / "none", argv=["train.mesh=none"])
    assert state.step == one.step == 2
    np.testing.assert_allclose(losses, one_losses, rtol=2e-4)
    saved = torch.load(tmp_path / spec / "model" / "state.pt", weights_only=True)["model"]
    for name, p in state.model.state_dict().items():
        assert torch.equal(saved[name], p), name  # whole parameters, from rank 0
        assert p.shape == one.model.state_dict()[name].shape


def test_single_device_meshes_train_and_opt_mask_raises(tmp_path):
    """Every single-device mesh spec trains. opt_mask trains the parameters
    it marks and leaves the rest bitwise as they were; a mask that freezes
    every parameter, or misses one, raises."""
    for spec in ("auto", "none", "1"):
        state, losses = _loop(tmp_path / spec, argv=[f"train.mesh={spec}"])
        assert state.step == 2 and np.isfinite(losses).all()
    before = {}

    def photometry_only(model):
        before.update({n: p.detach().clone() for n, p in model.named_parameters()})
        return {n: n.startswith("vaes.0.") for n, _ in model.named_parameters()}

    state, _ = _loop(tmp_path / "masked", opt_mask=photometry_only)
    for n, p in state.model.named_parameters():
        assert torch.equal(p, before[n]) != n.startswith("vaes.0."), n
    with pytest.raises(ValueError, match="freezes every parameter"):
        _loop(tmp_path, opt_mask=lambda m: {n: False for n, _ in m.named_parameters()})
    with pytest.raises(KeyError, match="every parameter"):
        _loop(tmp_path, opt_mask=lambda m: {"vaes.0.nope": True})


def test_install_params_must_name_parameters(tmp_path):
    with pytest.raises(KeyError, match="no parameter"):
        _loop(tmp_path, install_params={"vaes.0.nope": torch.zeros(1)})


def test_parity_draws_the_augmentation_once(tmp_path):
    calls = []

    def augment(generator, data):
        calls.append(generator.device.type)
        return data

    _loop(tmp_path / "fresh", argv=["train.epochs=3"], augment_fn=augment)
    assert len(calls) == 3  # one fresh draw per epoch
    calls.clear()
    _loop(tmp_path / "parity", argv=["train.epochs=3", "train.parity=true"], augment_fn=augment)
    assert calls == ["cpu"]


def test_no_matplotlib_means_no_png_and_one_line(tmp_path, monkeypatch, capsys):
    def no_matplotlib(*a, **k):
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(common, "plot_loss_curve", no_matplotlib)
    _loop(tmp_path, argv=["train.epochs=2", "train.save_every=1"], ckpt_name="run")
    out = capsys.readouterr().out
    assert out.count("matplotlib is not installed") == 1
    assert len(np.load(tmp_path / "run" / "losses.npy")) == 2
    assert not list(tmp_path.glob("*.png"))


def test_a_jax_checkpoint_directory_stops_training_before_it_starts(tmp_path):
    shipped = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "ckpt", "goldstein_photospec_4-4_K2_beta1.0")
    shutil.copytree(shipped, tmp_path / "jax")
    before = sorted(p.name for p in (tmp_path / "jax").iterdir())
    with pytest.raises(ValueError, match="JAX \\(Orbax\\) checkpoint"):
        _loop(tmp_path, ckpt_name="jax")
    assert sorted(p.name for p in (tmp_path / "jax").iterdir()) == before


def test_resolve_dataset_validates_and_matches_jax(tmp_path, monkeypatch):
    got, want = common.resolve_dataset(None, "ztf", seed=4), jcommon.resolve_dataset(
        None, "ztf", seed=4)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    bad = dict(make_goldstein_like(n=8, seed=0, spectrum_bins=16, photometry_length=8))
    del bad["photomask"]
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="npz contract"):
        common.resolve_dataset(str(tmp_path / "bad.npz"))
    monkeypatch.setenv("VAESNE_SKIP_VALIDATE", "1")
    assert "photomask" not in common.resolve_dataset(str(tmp_path / "bad.npz"))


def test_drivers_need_a_card_unless_the_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for driver, kind in ((train_photospectra, "goldstein"), (train_spectra, "goldstein"),
                         (train_photometry, "goldstein"), (train_ztf_photospect, "ztf"),
                         (train_ztf_spectra, "ztf")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            driver.main(_argv(tmp_path, "train.epochs=1", kind=kind))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _loop(tmp_path, device=None)
