"""The port's qualitative-evaluation driver ``try_models`` on the CPU
(matplotlib's Agg backend): every figure of every model kind, on the
shipped JAX checkpoints bridged into port checkpoints, and what it refuses."""

import json
import os
import shutil

import numpy as np
import pytest

from vaesne_tpu_torch.data import make_goldstein_like, make_ztf_like
from vaesne_tpu_torch.experiments import try_models

from torch_parity import export_port_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "artifacts", "ckpt")
FLAGSHIP = os.path.join(REPO, "artifacts", "ckpt_torch", "goldstein_photospec_4-4_K2_beta1.0")


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """The shipped ZTF and unimodal Goldstein checkpoints as port
    checkpoints, and tiny synthetic Goldstein and ZTF npz files."""
    pytest.importorskip("matplotlib")
    root = tmp_path_factory.mktemp("try")
    ckpts = {}
    for name, cls in (("ztf_spectra_4-4", "ZTFSpectraConfig"),
                      ("ztf_photospec_4-4_K8_beta0.5", "ZTFMMVAEConfig"),
                      ("goldstein_photometry_4-4", "PhotometryVAEConfig"),
                      ("goldstein_spectra_4-4", "SpectraVAEConfig")):
        ckpts[name] = str(root / name)
        export_port_checkpoint(os.path.join(SHIPPED, name), ckpts[name], cls)
    data = {}
    for kind, maker in (("goldstein", make_goldstein_like), ("ztf", make_ztf_like)):
        data[kind] = str(root / f"{kind}.npz")
        np.savez(data[kind], **maker(n=16, seed=0, spectrum_bins=48, photometry_length=12))
    return root, ckpts, data


CASES = [
    ("mmvae", "goldstein", ("mm_ckpt", None), ("cross_reconstructions.png", "generations.png")),
    ("photometry", "goldstein", ("mm_ckpt", "goldstein_photometry_4-4"),
     ("photometry_reconstructions.png",)),
    ("spectra", "goldstein", ("mm_ckpt", "goldstein_spectra_4-4"),
     ("spectra_reconstructions.png",)),
    ("ztf_spectra", "ztf", ("mm_ckpt", "ztf_spectra_4-4"),
     ("ztf_spectra_reconstruction.png", "ztf_spectra_priorsamples.png")),
    ("ztf_mmvae", "ztf", ("mm_ckpt", "ztf_photospec_4-4_K8_beta0.5"),
     ("ztf_lc_reconstruction.png", "ztf_spectra_reconstruction.png",
      "ztf_spectra_priorsamples.png")),
    ("latent_swap", "goldstein", None, ("latent_swap.png",)),
]


@pytest.mark.parametrize("which,kind,ckpt,pngs", CASES, ids=[c[0] for c in CASES])
def test_each_model_kind_writes_its_figures(bridged, which, kind, ckpt, pngs):
    root, ckpts, data = bridged
    out = root / f"out_{which}"
    argv = [f"model={which}", f"data={data[kind]}", "K=3", "n=2", f"out={out}"]
    if ckpt is not None:
        argv.append(f"{ckpt[0]}={FLAGSHIP if ckpt[1] is None else ckpts[ckpt[1]]}")
    else:
        argv += [f"photo_ckpt={ckpts['goldstein_photometry_4-4']}",
                 f"spec_ckpt={ckpts['goldstein_spectra_4-4']}"]
    try_models.main(argv, device="cpu")
    assert sorted(os.listdir(out)) == sorted(pngs)
    for png in pngs:
        assert os.path.getsize(out / png) > 0


def test_latent_swap_refuses_missing_or_mismatched_checkpoints(bridged):
    root, ckpts, data = bridged
    argv = ["model=latent_swap", f"data={data['goldstein']}", "K=2", "n=1",
            f"out={root / 'refused'}"]
    with pytest.raises(ValueError, match="needs trained unimodal checkpoints"):
        try_models.main(argv + [f"spec_ckpt={ckpts['goldstein_spectra_4-4']}"], device="cpu")
    narrow = root / "photometry_4-2"
    shutil.copytree(ckpts["goldstein_photometry_4-4"], narrow)
    cfg = json.loads((narrow / "config.json").read_text())
    cfg["model"]["latent_dim"] = 2
    (narrow / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match="matching latent shapes"):
        try_models.main(argv + [f"photo_ckpt={narrow}",
                                f"spec_ckpt={ckpts['goldstein_spectra_4-4']}"], device="cpu")
    assert not (root / "refused").exists()


def test_the_image_model_waits_for_its_slice(bridged):
    root, _, _ = bridged
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        try_models.main(["model=image", f"out={root / 'image'}"], device="cpu")
