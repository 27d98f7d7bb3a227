"""Shared helpers of the PyTorch port's parity tests: a flax parameter tree
filled with the torch model's weights, the numpy batches both packages
take, pinned posterior noise, and the bridge of a JAX (Orbax) checkpoint
into a port checkpoint.

The two frameworks draw different random numbers, so sampling is pinned:
``fixed_noise`` replaces the Laplace sampler of both packages with one that
adds the same numpy noise (a function of the draw's shape) to loc."""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.distributions as jdist
import vaesne_tpu.models as jmodels
import vaesne_tpu_torch.distributions as tdist
import vaesne_tpu_torch.models as tmodels
from vaesne_tpu_torch.utils import init_params, load_jax_params
from vaesne_tpu_torch.utils.weights import torch_key

SMALL = dict(latent_len=2, latent_dim=2, model_dim=16, ff_dim=16, num_layers=1, num_heads=2)
FLAGSHIP = dict(latent_len=4, latent_dim=4, model_dim=32, ff_dim=32, num_layers=4, num_heads=4)


def jax_params_from(tm, jm, example):
    """The flax parameter tree of ``jm`` (structure from an abstract init,
    no compile) filled with the torch model's weights."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda x: jm.init({"params": key, "sample": key}, x, 1),
                            example)
    state = tm.state_dict()

    def leaf(path, _):
        names = tuple(p.key for p in path)
        value = state[torch_key(names[1:])].numpy()
        return jnp.asarray(value.T if names[-1] == "kernel" else value)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def make_batch(B=3, lp=12, ns=40, seed=0):
    rng = np.random.default_rng(seed)
    photo = (rng.normal(size=(B, lp)).astype(np.float32),
             np.sort(rng.uniform(-1, 1, (B, lp)), axis=1).astype(np.float32),
             rng.integers(0, 6, (B, lp)).astype(np.int32),
             rng.uniform(size=(B, lp)) < 0.2)
    spec = (rng.normal(size=(B, ns)).astype(np.float32),
            np.linspace(-1, 1, ns, dtype=np.float32)[None].repeat(B, 0),
            rng.normal(size=(B,)).astype(np.float32),
            rng.uniform(size=(B, ns)) < 0.2)
    return photo, spec


def jx(batch):
    return tuple(tuple(jnp.asarray(a) for a in m) for m in batch)


def tx(batch):
    return tuple(tuple(torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
                       for a in m) for m in batch)


def make_pair(kw, batch, bright=False):
    """(JAX PhotoSpecMMVAE, its flax params, the port's twin in eval mode)
    with the same weights, from a seeded port initialisation; ``bright``
    takes the Bright* sub-VAEs."""
    prefix = "Bright" if bright else ""
    jm = jmodels.PhotoSpecMMVAE(
        vaes=[getattr(jmodels, prefix + "PhotometricVAE")(num_bands=6, **kw),
              getattr(jmodels, prefix + "SpectraVAE")(**kw)], beta=1.0)
    tm = tmodels.PhotoSpecMMVAE([getattr(tmodels, prefix + "PhotometricVAE")(num_bands=6, **kw),
                                 getattr(tmodels, prefix + "SpectraVAE")(**kw)], beta=1.0)
    init_params(tm, torch.Generator().manual_seed(0))
    return jm, jax_params_from(tm, jm, jx(batch)), tm.eval()


def noise(shape):
    return np.random.default_rng(list(shape) or [0]).laplace(size=shape).astype(np.float32)


@pytest.fixture
def fixed_noise(monkeypatch):
    """Both packages' Laplace draws become loc + scale·(numpy noise)."""

    def jax_sample(self, key, sample_shape=()):
        shape = jdist._as_shape(sample_shape) + tuple(self.batch_shape)
        return self.loc + self.scale * jnp.asarray(noise(shape))

    def torch_sample(self, generator=None, sample_shape=()):
        shape = tdist._as_shape(sample_shape) + tuple(self.batch_shape)
        return self.loc + self.scale * torch.from_numpy(noise(shape))

    monkeypatch.setattr(jdist.Laplace, "sample", jax_sample)
    monkeypatch.setattr(tdist.Laplace, "sample", torch_sample)


# a checkpoint's config class → (the driver module that builds its model in
# either package, its data kind, its tuple builder)
_EXPORTABLE = {
    "PhotoSpectraMMVAEConfig": ("train_photospectra", "goldstein", "multimodal_tuple"),
    "ZTFMMVAEConfig": ("train_ztf_photospect", "ztf", "multimodal_tuple"),
    "SpectraVAEConfig": ("train_spectra", "goldstein", "spectra_tuple"),
    "ZTFSpectraConfig": ("train_ztf_spectra", "ztf", "spectra_tuple"),
    "PhotometryVAEConfig": ("train_photometry", "goldstein", "photometry_tuple"),
}


def export_port_checkpoint(jax_dir, out_dir, config_class="PhotoSpectraMMVAEConfig"):
    """Bridge the JAX package's checkpoint at ``jax_dir`` (its Orbax
    ``state/`` and ``config.json``) into a port checkpoint at ``out_dir``:
    ``config.json`` tagged with its config class and a ``state.pt`` of the
    parameters alone (``save_params``), which ``restore_params`` and
    ``InferenceServer.from_checkpoint`` read and ``restore_checkpoint``
    refuses (the AdamW moments are not bridged). The config class is the
    checkpoint's ``_config_class`` tag, else ``config_class``. The JAX
    state is restored into an abstract template, so nothing is compiled."""
    import vaesne_tpu.data as jdata
    import vaesne_tpu.utils.checkpoint as jck
    import vaesne_tpu.utils.config as jcfg
    from vaesne_tpu import training as jtr
    from vaesne_tpu.experiments.common import optimizer_from_config
    from vaesne_tpu_torch.utils import checkpoint as tck
    from vaesne_tpu_torch.utils import config as tcfg

    name = (jck.load_config(jax_dir) or {}).get("_config_class", config_class)
    driver, kind, builder = _EXPORTABLE[name]
    jc = jck.restore_config(jax_dir, jcfg.CONFIG_CLASSES[name])
    jmodel = importlib.import_module(f"vaesne_tpu.experiments.{driver}").build_model(jc)
    maker = jdata.make_goldstein_like if kind == "goldstein" else jdata.make_ztf_like
    example = getattr(jdata, builder)(maker(n=8, seed=0), idx=np.arange(2))
    key = jax.random.PRNGKey(0)
    one_device = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    template = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=one_device),
        jax.eval_shape(lambda: jtr.TrainState.create(
            jtr.init_model(jmodel, example, key, K=1), optimizer_from_config(jc.train), key)))
    params = jck.restore_checkpoint(jax_dir, template).params

    tc = tck.restore_config(jax_dir, tcfg.CONFIG_CLASSES[name])
    model = importlib.import_module(f"vaesne_tpu_torch.experiments.{driver}").build_model(tc)
    load_jax_params(model, {"params": jax.tree_util.tree_map(np.asarray, params)})
    config = tcfg.asdict(tc)
    config["_config_class"] = name
    tck.save_params(out_dir, model, config)
    return model


if __name__ == "__main__":
    # PYTHONPATH=. python tests/torch_parity.py <JAX checkpoint> <port checkpoint> [class]
    export_port_checkpoint(*sys.argv[1:])
    print(f"wrote {os.path.join(sys.argv[2], 'state.pt')}")
