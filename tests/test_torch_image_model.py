"""The port's HostImgVAE against the JAX package's on the CPU: the ELBO and
its gradients on pinned posterior noise, the batch contract's event_loc
rule, and the shipped synthetic_image_4-4_patch2 checkpoint bridged into
``artifacts/ckpt_torch/``, against the JAX package's reconstruction stored
beside it."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaesne_tpu import models as jmodels
from vaesne_tpu import objectives as jobj
from vaesne_tpu_torch import HostImgVAE, objectives as tobj
from vaesne_tpu_torch.data import image_tuple, make_images
from vaesne_tpu_torch.experiments import train_image
from vaesne_tpu_torch.experiments.eval_goldstein import _config_for, _restore
from vaesne_tpu_torch.utils import init_params, to_jax_params
from vaesne_tpu_torch.utils.config import ImageVAEConfig

from torch_parity import (  # noqa: F401
    REFERENCE_FILE,
    REFERENCE_IMAGES,
    export_port_checkpoint,
    fixed_noise,
    jax_params_from,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = os.path.join(REPO, "artifacts", "ckpt", "synthetic_image_4-4_patch2")
BRIDGED = os.path.join(REPO, "artifacts", "ckpt_torch", "synthetic_image_4-4_patch2")
SMALL = dict(img_size=12, latent_len=2, latent_dim=2, model_dim=8, num_heads=2, ff_dim=8,
             num_layers=2)
K = 2


def _pair(**kw):
    """(JAX HostImgVAE, its params, the port's twin in eval mode) with the
    same weights, from a seeded port initialisation."""
    tm = init_params(HostImgVAE(**SMALL, **kw), torch.Generator().manual_seed(0))
    jm = jmodels.HostImgVAE(**SMALL, **kw)
    example = (jnp.zeros((2, kw.get("in_channels", 3), 12, 12)), jnp.zeros((2, 2)))
    return jm, jax_params_from(tm, jm, example), tm.eval()


def _batch(focal_loc, channels=3, B=3, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (B, channels, 12, 12)).astype(np.float32)
    loc = rng.normal(size=(B, 2 if focal_loc else 0)).astype(np.float32)
    return img, loc


CASES = [dict(hybrid=True, patch_size=2), dict(hybrid=True, patch_size=3, focal_loc=True),
         dict(hybrid=False, patch_size=4, in_channels=1)]


@pytest.mark.parametrize("kw", CASES, ids=["hybrid-p2", "hybrid-p3-focal", "pixel-p4-1ch"])
def test_elbo_and_its_gradients_match_jax(kw, fixed_noise):
    """The ELBO at K = 2 within rtol 1e-5, and the gradients of −ELBO (what
    the train step minimises) within 1e-4 of the largest gradient, every
    parameter, dropout off."""
    jm, variables, tm = _pair(**kw)
    img, loc = _batch(kw.get("focal_loc", False), kw.get("in_channels", 3))
    jx, tx = (jnp.asarray(img), jnp.asarray(loc)), (torch.from_numpy(img), torch.from_numpy(loc))
    key = jax.random.PRNGKey(1)
    want, grads_j = jax.jit(jax.value_and_grad(lambda p: jobj.elbo(
        jm, {"params": p}, jx, K, key=key, deterministic=True)))(variables["params"])
    tm.zero_grad(set_to_none=True)
    got = tobj.elbo(tm, tx, K, seed=1)
    got.backward()
    assert got.dim() == 0 and torch.isfinite(got)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    grads_t = to_jax_params(tm, {n: p.grad for n, p in tm.named_parameters()})["params"]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(grads_j)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(grads_t)[0])
    assert flat_j.keys() == flat_t.keys()
    scale = max(float(np.abs(g).max()) for g in flat_j.values())
    for path, g in flat_j.items():
        np.testing.assert_allclose(flat_t[path], np.asarray(g), rtol=0, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_reconstruct_and_generate_shapes():
    tm = init_params(HostImgVAE(**SMALL, patch_size=3), torch.Generator().manual_seed(0))
    img, loc = _batch(False)
    x = (torch.from_numpy(img), torch.from_numpy(loc))
    g = torch.Generator().manual_seed(0)
    assert tm.reconstruct(x, 4, generator=g).shape == (4, 3, 3, 12, 12)
    assert tm.generate(5, x, generator=g).shape == (5, 3, 3, 12, 12)
    assert tm.encode(x).shape == (3, 2, 2)


def test_malformed_event_loc_raises_and_empty_means_none():
    """Under focal_loc a non-empty event_loc that is not [B, 2] raises, as
    in the JAX package; the empty placeholder means no conditioning, which
    is the zero location."""
    tm = init_params(HostImgVAE(**SMALL, patch_size=3, focal_loc=True),
                     torch.Generator().manual_seed(0)).eval()
    img = torch.from_numpy(_batch(True)[0])
    with pytest.raises(ValueError, match="event_loc"):
        tm.encode((img, torch.zeros(3, 3)))
    with pytest.raises(ValueError, match="event_loc"):
        tm.encode((img, torch.zeros(3, 2, 1)))
    torch.testing.assert_close(tm.encode((img, torch.zeros(3, 0))),
                               tm.encode((img, torch.zeros(3, 2))), rtol=0, atol=0)
    # without focal_loc the second element is never read
    plain = init_params(HostImgVAE(**SMALL, patch_size=3), torch.Generator().manual_seed(0))
    assert plain.encode((img, torch.zeros(3, 5))).shape == (3, 2, 2)


def test_train_mode_needs_a_seed_and_draws_dropout_from_it():
    tm = init_params(HostImgVAE(**SMALL, patch_size=3), torch.Generator().manual_seed(0))
    x = image_tuple(_batch(False)[0], "cpu")
    with pytest.raises(ValueError, match="seed"):
        tm.train()(x, 1)
    a, b = (tobj.elbo(tm, x, 1, seed=3) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, tobj.elbo(tm, x, 1, seed=4))


def test_bridged_checkpoint_reproduces_the_jax_reconstruction():
    """The committed port checkpoint, rebuilt from its config.json on the
    CPU: decode(encode(x)).loc of the reference images within 1e-5 of the
    largest value of the JAX package's (stored beside it)."""
    cfg = _config_for(BRIDGED, ImageVAEConfig)
    assert (cfg.img_size, cfg.patch_size, cfg.hybrid) == (60, 2, True)
    model = _restore(BRIDGED, train_image.build_model(cfg)).eval()
    images = make_images(img_size=cfg.img_size, channels=cfg.in_channels, **REFERENCE_IMAGES)
    x = image_tuple(images, "cpu")
    with torch.no_grad():
        loc = model.decode(model.encode(x)[None], x).loc[0].numpy()
    want = np.load(os.path.join(BRIDGED, REFERENCE_FILE))
    assert want.shape == loc.shape == (8, 3, 60, 60)
    np.testing.assert_allclose(loc, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_the_committed_bridge_is_the_orbax_checkpoint(tmp_path):
    """artifacts/ckpt_torch/synthetic_image_4-4_patch2 is
    export_port_checkpoint of the shipped Orbax checkpoint: the same
    config, the parameters bitwise, the reference reconstruction within
    1e-6 of its largest value (XLA on another CPU may sum in another
    order)."""
    export_port_checkpoint(ORBAX, str(tmp_path), "ImageVAEConfig")
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(BRIDGED))
    with open(tmp_path / "config.json") as f, open(os.path.join(BRIDGED, "config.json")) as g:
        assert f.read() == g.read()
    fresh = torch.load(tmp_path / "state.pt", weights_only=True)["model"]
    committed = torch.load(os.path.join(BRIDGED, "state.pt"), weights_only=True)["model"]
    assert fresh.keys() == committed.keys()
    for k in fresh:
        assert torch.equal(fresh[k], committed[k]), k
    committed_ref = np.load(os.path.join(BRIDGED, REFERENCE_FILE))
    np.testing.assert_allclose(np.load(tmp_path / REFERENCE_FILE), committed_ref, rtol=0,
                               atol=1e-6 * np.abs(committed_ref).max())
