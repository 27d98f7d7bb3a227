"""Checkpoints of the port: a bitwise round trip of the whole train state,
the errors that name what differs, the refusal to read or overwrite the JAX
package's Orbax checkpoints."""

import os
import shutil

import pytest
import torch

import vaesne_tpu.utils.checkpoint as jck
import vaesne_tpu_torch.utils.checkpoint as tck
from vaesne_tpu_torch import PhotometricVAE, PhotoSpecMMVAE, SpectraVAE
from vaesne_tpu_torch import objectives as tobj
from vaesne_tpu_torch import training as ttr
from vaesne_tpu_torch.utils import init_params

from torch_parity import SMALL, make_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "ckpt", "goldstein_photospec_4-4_K2_beta1.0")


def _trained_state(seed=0, **overrides):
    """A small MMVAE and its AdamW state after two steps."""
    kw = dict(SMALL, **overrides)
    model = init_params(PhotoSpecMMVAE([PhotometricVAE(num_bands=6, **kw), SpectraVAE(**kw)]),
                        torch.Generator().manual_seed(seed))
    opt = ttr.adamw(1e-3)
    state = ttr.TrainState.create(model, opt, seed=seed, device="cpu")
    step = ttr.make_train_step(model, opt, lambda m, b, s: tobj.m_iwae(m, b, 2, seed=s),
                               device="cpu")
    for i in range(2):
        state, _ = step(state, make_batch(B=3, seed=i))
    return state, opt


def _snapshot(state):
    return {"params": [p.detach().clone() for p in state.model.parameters()],
            "moments": [{k: v.clone() for k, v in s.items()}
                        for s in state.optimizer.state.values()],
            "step": state.step, "generator": state.generator.get_state().clone()}


def test_round_trip_is_bitwise(tmp_path):
    state, opt = _trained_state()
    want = _snapshot(state)
    tck.save_checkpoint(str(tmp_path / "ck"), state, {"a": 1})
    assert sorted(os.listdir(tmp_path / "ck")) == ["config.json", "state.pt"]
    fresh, _ = _trained_state(seed=5)
    fresh.optimizer.param_groups[0]["lr"] = 0.5  # the new run's hyperparameters stay
    got = _snapshot(tck.restore_checkpoint(str(tmp_path / "ck"), fresh))
    assert got["step"] == want["step"] == 2
    assert torch.equal(got["generator"], want["generator"])
    for a, b in zip(got["params"], want["params"]):
        assert torch.equal(a, b)
    assert len(got["moments"]) == len(want["moments"]) > 0
    for a, b in zip(got["moments"], want["moments"]):
        assert a.keys() == b.keys() == {"step", "exp_avg", "exp_avg_sq"}
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert fresh.optimizer.param_groups[0]["lr"] == 0.5
    # the next per-step seed continues the saved chain
    assert torch.randint(1 << 31, (1,), generator=fresh.generator) == torch.randint(
        1 << 31, (1,), generator=state.generator)


def test_architecture_and_optimizer_mismatch_name_what_differs(tmp_path):
    state, _ = _trained_state()
    path = str(tmp_path / "ck")
    tck.save_checkpoint(path, state)
    other, _ = _trained_state(model_dim=8, ff_dim=8)
    with pytest.raises(ValueError, match="another model architecture.*shapes that differ"):
        tck.restore_checkpoint(path, other)
    same_model, _ = _trained_state()
    frozen = torch.optim.AdamW(list(same_model.model.parameters())[:3])
    with pytest.raises(ValueError, match="not the optimizer"):
        tck.restore_checkpoint(path, ttr.TrainState(same_model.model, frozen, 0,
                                                    torch.Generator()))


def test_a_jax_checkpoint_is_neither_read_nor_overwritten(tmp_path):
    """A directory holding an Orbax state/ (the JAX package's format, as
    the shipped checkpoint does) raises an error naming the format, on
    restore and on save, and is left as it was."""
    state, _ = _trained_state()
    with pytest.raises(ValueError, match="JAX \\(Orbax\\) checkpoint"):
        tck.restore_checkpoint(SHIPPED, state)
    fake = tmp_path / "jax_ck"
    shutil.copytree(SHIPPED, fake)
    before = sorted(os.listdir(fake))
    with pytest.raises(ValueError, match="JAX \\(Orbax\\) checkpoint"):
        tck.save_checkpoint(str(fake), state, {"a": 1})
    with pytest.raises(ValueError, match="JAX \\(Orbax\\) checkpoint"):
        tck.restore_params(str(fake), state.model)
    assert sorted(os.listdir(fake)) == before
    with pytest.raises(FileNotFoundError, match="state.pt"):
        tck.restore_checkpoint(str(tmp_path), state)


def test_checkpoint_name_matches_jax():
    args = ("goldstein", "photospec", 4, 4, 1e-4, 200)
    kw = dict(K=2, beta=1.0, model_dim=32, tag="x")
    assert tck.checkpoint_name(*args, **kw) == jck.checkpoint_name(*args, **kw)
