"""One epoch of the flagship driver's train loop under ``VAESNE_BF16=1``
in the port and in the JAX package, on the CPU. Under it the JAX package
keeps its Dense, Embed and LayerNorm outputs in bf16, while torch's
autocast runs matmuls in bf16 and keeps LayerNorm, softmax and the
reductions in fp32, so the two round at different places: the objectives
are held to each other at 3e-2 relative, against 1e-5 in fp32
(``test_torch_drivers.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import vaesne_tpu.data as jdata
import vaesne_tpu_torch.experiments.common as common
from vaesne_tpu import objectives as jobj
from vaesne_tpu import training as jtr
from vaesne_tpu.experiments import common as jcommon
from vaesne_tpu.experiments import train_photospectra as jdriver
from vaesne_tpu.utils import config as jcfg
from vaesne_tpu_torch import objectives as tobj
from vaesne_tpu_torch.data import make_goldstein_like, multimodal_tuple
from vaesne_tpu_torch.experiments import train_photospectra
from vaesne_tpu_torch.utils import load_jax_params
from vaesne_tpu_torch.utils import config as tcfg

from torch_parity import fixed_noise  # noqa: F401

BF16_RTOL = 3e-2
TINY = ["model.latent_len=2", "model.latent_dim=2", "model.model_dim=16", "model.ff_dim=16",
        "model.num_layers=1", "model.num_heads=2"]


def test_bf16_driver_epoch_tracks_jax(tmp_path, monkeypatch, fixed_noise):
    """One epoch of the flagship driver's train_loop in both packages under
    VAESNE_BF16=1, from the same weights, at dropout 0 on pinned noise with
    the shuffle pinned: the per-step objectives within BF16_RTOL of JAX's,
    while they differ from the port's own fp32 run (bf16 reached the step);
    the parameters and AdamW's moments stay fp32."""
    monkeypatch.setenv("VAESNE_BF16", "1")
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

    jcommon.train_loop(jm, jtrain, jloss, jc.train, ckpt_name="jax", log=False)
    jax.effects_barrier()

    tc = tcfg.parse_overrides(tcfg.PhotoSpectraMMVAEConfig(), argv)
    runs = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("VAESNE_BF16", flag)
        tm = train_photospectra.build_model(tc)
        load_jax_params(tm, {"params": jax.tree_util.tree_map(np.asarray, start)})
        install = {k: v.clone() for k, v in tm.state_dict().items()}
        losses = []

        def tloss(m, batch, seed, losses=losses):
            obj = tobj.m_iwae(m, batch, K, seed=seed)
            losses.append(obj.item())
            return obj

        state, _ = common.train_loop(
            tm, multimodal_tuple(data, idx=idx, device="cpu"), tloss, tc.train,
            ckpt_name=f"port{flag}", install_params=install, log=False, device="cpu")
        runs[flag] = (state, losses)
    state, tlosses = runs["1"]
    assert len(tlosses) == len(jlosses) == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=BF16_RTOL)
    assert not np.allclose(tlosses, runs["0"][1], rtol=1e-6, atol=0)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    moments = [t for s in state.optimizer.state.values() for t in s.values()
               if torch.is_tensor(t) and t.dim() > 0]
    assert moments and all(t.dtype == torch.float32 for t in moments)
