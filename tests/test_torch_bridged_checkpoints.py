"""Four shipped JAX checkpoints bridged into ``artifacts/ckpt_torch/``
beside the flagship, image, contrastive and regression ones: the unimodal
Goldstein VAEs and the ZTF MMVAE and spectra VAE. Each committed
``state.pt`` is a fresh export of its Orbax checkpoint, bitwise, and the
port serves it on the CPU within 1e-4 of the JAX package's outputs
committed beside it (``jax_reference.npz``: the embeddings and the
posterior-mean decodes of four synthetic events)."""

import json
import os

import numpy as np
import pytest
import torch

from vaesne_tpu_torch import InferenceServer

from torch_parity import _EXPORTABLE, VAE_REFERENCE_FILE, export_port_checkpoint, reference_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BRIDGED = {"goldstein_photometry_4-4": "PhotometryVAEConfig",
           "goldstein_spectra_4-4": "SpectraVAEConfig",
           "ztf_photospec_4-4_K8_beta0.5": "ZTFMMVAEConfig",
           "ztf_spectra_4-4": "ZTFSpectraConfig"}


@pytest.mark.parametrize("name", list(BRIDGED))
def test_committed_bridge_is_the_orbax_checkpoint(tmp_path, name):
    export_port_checkpoint(os.path.join(REPO, "artifacts", "ckpt", name), str(tmp_path),
                           BRIDGED[name])
    committed_dir = os.path.join(REPO, "artifacts", "ckpt_torch", name)
    fresh = torch.load(tmp_path / "state.pt", weights_only=True)
    committed = torch.load(os.path.join(committed_dir, "state.pt"), weights_only=True)
    assert set(fresh) == set(committed) == {"model"}
    assert fresh["model"].keys() == committed["model"].keys()
    for k, v in fresh["model"].items():
        assert torch.equal(v, committed["model"][k]), k
    with open(os.path.join(committed_dir, "config.json")) as f:
        assert json.load(f) == json.loads((tmp_path / "config.json").read_text())


@pytest.mark.parametrize("name", list(BRIDGED))
def test_bridged_checkpoint_serves_as_jax(name):
    """from_checkpoint rebuilds the architecture from config.json; embed
    and the posterior-mean decode of every modality within 1e-4 of max
    |JAX output|."""
    path = os.path.join(REPO, "artifacts", "ckpt_torch", name)
    reference = np.load(os.path.join(path, VAE_REFERENCE_FILE))
    _, kind, builder = _EXPORTABLE[BRIDGED[name]]
    x = reference_events(kind, builder, lib="torch")
    server = InferenceServer.from_checkpoint(path, buckets=(4,), device="cpu")
    multimodal = builder == "multimodal_tuple"
    assert sorted(reference.files) == sorted(
        f"{k}_{m}" for k in ("embed", "decode") for m in range(2 if multimodal else 1))
    for m, xm in enumerate(x if multimodal else (x,)):
        z = server.embed(xm, modality=m)
        vae = server.model.vaes[m] if multimodal else server.model
        with torch.inference_mode():
            loc = vae.decode(z[None], xm).loc[0]
        for key, got in ((f"embed_{m}", z), (f"decode_{m}", loc)):
            want = reference[key]
            assert got.shape == want.shape, key
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(), err_msg=key)
