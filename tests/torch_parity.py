"""Shared helpers of the PyTorch port's parity tests: a flax parameter tree
filled with the torch model's weights, the numpy batches both packages
take, and pinned posterior noise.

The two frameworks draw different random numbers, so sampling is pinned:
``fixed_noise`` replaces the Laplace sampler of both packages with one that
adds the same numpy noise (a function of the draw's shape) to loc."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.distributions as jdist
import vaesne_tpu.models as jmodels
import vaesne_tpu_torch.distributions as tdist
import vaesne_tpu_torch.models as tmodels
from vaesne_tpu_torch.utils import init_params
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


def make_pair(kw, batch):
    """(JAX PhotoSpecMMVAE, its flax params, the port's twin in eval mode)
    with the same weights, from a seeded port initialisation."""
    jm = jmodels.PhotoSpecMMVAE(vaes=[jmodels.PhotometricVAE(num_bands=6, **kw),
                                      jmodels.SpectraVAE(**kw)], beta=1.0)
    tm = tmodels.PhotoSpecMMVAE([tmodels.PhotometricVAE(num_bands=6, **kw),
                                 tmodels.SpectraVAE(**kw)], beta=1.0)
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
