"""The shipped JAX checkpoint of the flagship, restored by the JAX package
and served by the port through the weight bridge, on the CPU."""

import os

import jax
import numpy as np

import vaesne_tpu.utils.checkpoint as jck
import vaesne_tpu_torch.utils.checkpoint as tck
from vaesne_tpu import training as jtr
from vaesne_tpu.experiments import train_photospectra as jdriver
from vaesne_tpu.serving import InferenceServer as JInferenceServer
from vaesne_tpu.utils.config import PhotoSpectraMMVAEConfig as JConfig
from vaesne_tpu_torch import InferenceServer
from vaesne_tpu_torch.data import make_goldstein_like, multimodal_tuple
from vaesne_tpu_torch.experiments import train_photospectra as tdriver
from vaesne_tpu_torch.utils import load_jax_params
from vaesne_tpu_torch.utils.config import PhotoSpectraMMVAEConfig

from torch_parity import fixed_noise  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "ckpt", "goldstein_photospec_4-4_K2_beta1.0")


def _event_batch(n=4):
    data = make_goldstein_like(n=n, seed=1)
    return tuple(tuple(t.numpy() for t in m) for m in multimodal_tuple(data, device="cpu"))


def test_shipped_checkpoint_serves_alike_in_both_packages(fixed_noise):
    """The shipped flagship checkpoint restored by the JAX package (its
    config.json rebuilds the architecture) and bridged into the port's
    model rebuilt from the same file: embed and crossmodal agree to rtol
    1e-4 on pinned posterior draws."""
    jcfg = jck.restore_config(SHIPPED, JConfig)
    jmodel = jdriver.build_model(jcfg)
    photo, spec = _event_batch()
    key = jax.random.PRNGKey(0)
    example = tuple(tuple(a[:2] for a in m) for m in (photo, spec))
    params = jtr.init_model(jmodel, example, key, K=1)
    template = jtr.TrainState.create(params, jtr.adamw(jcfg.train.lr), key)
    params = jck.restore_checkpoint(SHIPPED, template).params
    jserver = JInferenceServer(jmodel, {"params": params}, buckets=(4,))

    model = tdriver.build_model(tck.restore_config(SHIPPED, PhotoSpectraMMVAEConfig))
    load_jax_params(model, {"params": jax.tree_util.tree_map(np.asarray, params)})
    server = InferenceServer(model, buckets=(4,), device="cpu")
    for m, x in enumerate((photo, spec)):
        np.testing.assert_allclose(server.embed(x, modality=m).numpy(),
                                   np.asarray(jserver.embed(x, modality=m)),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(server.crossmodal(photo, spec, K=2).numpy(),
                               np.asarray(jserver.crossmodal(photo, spec, K=2, key=key)),
                               rtol=1e-4, atol=1e-5)
