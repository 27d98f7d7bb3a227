"""The port's reference-weight import (``vaesne_tpu_torch/utils/torch_port.py``)
on the CPU. The oracle is the JAX package: its converter (reference → flax)
followed by the port's bridge (``load_jax_params``, flax → port) must give
the direct converter's state dict key for key and bit for bit, for every
model family, on state dicts under the reference's names with random
values. No reference checkout is needed: the reference-named dicts come
from ``to_reference_state_dict``, whose names the JAX converter checks (it
reads each one), and a stand-in ``VAESNe`` package in a temporary directory
carries the whole-module pickle."""

import sys
import textwrap

import pytest
import torch

import vaesne_tpu.utils.torch_port as jport
import vaesne_tpu_torch.utils.torch_port as tport
from vaesne_tpu_torch.models import (
    BrightPhotometricVAE,
    BrightSpectraVAE,
    ContraPhotSpec,
    HostImgVAE,
    PhotometricVAE,
    PhotoSpecMMVAE,
    SpectraVAE,
)
from vaesne_tpu_torch.nn import HostImgTransformerDecoder, HostImgTransformerEncoder
from vaesne_tpu_torch.utils import init_params, load_jax_params

KW = dict(latent_len=2, latent_dim=2, model_dim=16, ff_dim=16, num_layers=2, num_heads=2)
IMG = dict(img_size=8, patch_size=2, in_channels=3, **KW)


def _pixel_decoder_variants():
    """The per-pixel Linear decoder and the learned position table with
    the event-location embedding, which no HostImgVAE option builds."""
    m = HostImgVAE(hybrid=False, focal_loc=True, **IMG)
    m.enc = HostImgTransformerEncoder(8, 4, 2, patch_size=2, model_dim=16, num_heads=2,
                                      ff_dim=16, num_layers=2, focal_loc=True, sincosin=False)
    m.dec = HostImgTransformerDecoder(8, 2, model_dim=16, num_heads=2, ff_dim=16,
                                      num_layers=2, mlpdecoder=False)
    return m


CASES = {
    # case: (converter, a function that makes the model)
    "photometric": ("convert_photometric_vae", lambda: PhotometricVAE(num_bands=6, **KW)),
    "photometric_sum_selfattn": ("convert_photometric_vae", lambda: PhotometricVAE(
        num_bands=6, concat=False, selfattn=True, **KW)),
    "bright_photometric": ("convert_photometric_vae",
                           lambda: BrightPhotometricVAE(num_bands=6, **KW)),
    "spectra": ("convert_spectra_vae", lambda: SpectraVAE(**KW)),
    "spectra_mlp_selfattn": ("convert_spectra_vae",
                             lambda: SpectraVAE(concat=False, selfattn=True, **KW)),
    "bright_spectra": ("convert_spectra_vae", lambda: BrightSpectraVAE(**KW)),
    "mmvae": ("convert_photospec_mmvae", lambda: PhotoSpecMMVAE(
        [PhotometricVAE(num_bands=6, **KW), SpectraVAE(**KW)])),
    "hostimg_hybrid": ("convert_hostimg_vae", lambda: HostImgVAE(**IMG)),
    "hostimg_pixel_mlp": ("convert_hostimg_vae", lambda: HostImgVAE(hybrid=False, **IMG)),
    "hostimg_pixel_linear_learned_pos": ("convert_hostimg_vae", _pixel_decoder_variants),
    "contrastive": ("convert_contrastive", lambda: ContraPhotSpec(
        latent_len=2, latent_dim=2, proj_dim=3, photo_model_dim=16, photo_num_heads=2,
        photo_ff_dim=16, photo_num_layers=2, spec_model_dim=16, spec_num_heads=2,
        spec_ff_dim=16, spec_num_layers=2, selfattn=True)),
}


def _reference_state(case, seed=0):
    """(the port model, its state dict, that state under the reference's
    names) from a seeded initialisation."""
    model = init_params(CASES[case][1](), torch.Generator().manual_seed(seed))
    state = model.state_dict()
    return model, state, tport.to_reference_state_dict(state)


@pytest.mark.parametrize("case", sorted(CASES))
def test_direct_converter_equals_jax_converter_and_bridge(case):
    """Key for key and bitwise: the JAX converter's flax tree bridged into
    the port, the direct converter's state dict, and the state the
    reference-named dict was made from; the direct result loads strictly."""
    name, build = CASES[case]
    model, state, ref = _reference_state(case)
    assert not any(s in k for k in ref for s in ("q_proj", "block_", "hidden_", "ffn_"))
    assert any(k.endswith("in_proj_weight") for k in ref)
    mlp = [k for k in ref if ".mlp." in k or k.startswith("mlp.")]
    assert mlp and all(int(k.split("mlp.")[1].split(".")[0]) % 2 == 0 for k in mlp)

    bridged = build()
    load_jax_params(bridged, {"params": getattr(jport, name)(jport.numpy_state_dict(ref))})
    want = bridged.state_dict()
    got = getattr(tport, name)(ref)
    assert list(sorted(got)) == list(sorted(want)) == list(sorted(state))
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        assert torch.equal(got[key], value), key
        assert torch.equal(got[key], state[key]), key
    fresh = build()
    fresh.load_state_dict(got, strict=True)
    # numpy input converts alike
    got_np = getattr(tport, name)(tport.numpy_state_dict(ref))
    assert all(torch.equal(got_np[k], got[k]) for k in got)


def test_encoder_and_decoder_converters_take_a_prefix():
    """The tower converters work on their own module under any prefix, as
    the contrastive towers use them."""
    _, state, ref = _reference_state("photometric")
    enc = tport.convert_photometric_encoder(ref)
    assert set(enc) == {k[4:] for k in state if k.startswith("enc.")}
    moved = {f"tower.{k[len('enc.inference_transformer.'):]}": v for k, v in ref.items()
             if k.startswith("enc.inference_transformer.")}
    again = tport.convert_photometric_encoder(moved, "tower")
    assert all(torch.equal(again[k], enc[k]) for k in enc)
    dec = tport.convert_spectra_decoder(_reference_state("spectra")[2])
    assert "get_flux.fc2.weight" in dec and "get_photo.fc2.weight" not in dec


def _state_pickle(tmp_path):
    model, state, ref = _reference_state("photometric", seed=1)
    path = tmp_path / "state_dict.pth"
    torch.save(ref, path)
    return model, state, str(path)


def test_state_dict_pickle_needs_class_name(tmp_path):
    """A bare state_dict pickle imports too, with ``class_name=`` (the
    class is not recoverable from tensors alone), as in the JAX package."""
    model, state, path = _state_pickle(tmp_path)
    with pytest.raises(ValueError, match="bare state_dict; pass class_name="):
        tport.import_reference_pickle(path, device="cpu")
    with pytest.raises(ValueError, match="bare state_dict; pass class_name="):
        jport.import_reference_pickle(path)
    got = tport.import_reference_pickle(path, class_name="PhotometricVAE", device="cpu")
    assert all(torch.equal(got[k], state[k]) for k in state) and set(got) == set(state)


def test_unknown_class_raises(tmp_path):
    _, _, path = _state_pickle(tmp_path)
    with pytest.raises(ValueError, match="no converter for reference class 'TransformerVAE'"):
        tport.import_reference_pickle(path, class_name="TransformerVAE", device="cpu")
    with pytest.raises(TypeError, match="expected an nn.Module"):
        torch.save([1, 2], tmp_path / "list.pth")
        tport.load_reference_pickle(str(tmp_path / "list.pth"))


def test_import_defaults_to_the_card(tmp_path, monkeypatch):
    """``device=None`` resolves to CUDA, which raises on a host without a
    card rather than fall back to the CPU."""
    _, _, path = _state_pickle(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tport.import_reference_pickle(path, class_name="PhotometricVAE")


STAND_IN = textwrap.dedent('''
    """A stand-in for the reference package: a module whose state_dict()
    holds reference names."""
    import torch


    class {cls}(torch.nn.Module):
        def __init__(self, tensors):
            super().__init__()
            self.tensors = dict(tensors)

        def state_dict(self, *args, **kwargs):
            return dict(self.tensors)
''')


@pytest.mark.parametrize("case,cls", [("photometric", "PhotometricVAE"),
                                      ("mmvae", "photospecMMVAE")])
def test_whole_module_pickle_round_trip(tmp_path, case, cls):
    """A whole-module pickle of a stand-in ``VAESNe`` class imports through
    ``package_path`` (the package is not importable otherwise), dispatches
    on its class name and loads strictly into the port model, bitwise the
    state it was made from; the JAX package imports the same file."""
    model, state, ref = _reference_state(case, seed=2)
    pkg = tmp_path / "package"
    (pkg / "VAESNe").mkdir(parents=True)
    (pkg / "VAESNe" / "__init__.py").write_text("")
    (pkg / "VAESNe" / "models.py").write_text(STAND_IN.format(cls=cls))
    sys.path.insert(0, str(pkg))
    try:
        from VAESNe import models as stand_in

        torch.save(getattr(stand_in, cls)(ref), tmp_path / "whole.pth")
    finally:
        sys.path.remove(str(pkg))
        for name in [m for m in sys.modules if m == "VAESNe" or m.startswith("VAESNe.")]:
            del sys.modules[name]
    path = str(tmp_path / "whole.pth")

    sd, name = tport.load_reference_pickle(path, package_path=str(pkg))
    assert name == cls and set(sd) == set(ref) and str(pkg) not in sys.path
    got = tport.import_reference_pickle(path, package_path=str(pkg), device="cpu")
    fresh = CASES[case][1]()
    fresh.load_state_dict(got, strict=True)
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, state[key]), key
    tree = jport.import_reference_pickle(path, package_path=str(pkg))
    bridged = CASES[case][1]()
    load_jax_params(bridged, {"params": tree})
    assert all(torch.equal(v, state[k]) for k, v in bridged.state_dict().items())
    for name in [m for m in sys.modules if m == "VAESNe" or m.startswith("VAESNe.")]:
        del sys.modules[name]


def test_pickle_dispatch_table_matches_jax():
    assert tport._PICKLE_CONVERTERS == jport._PICKLE_CONVERTERS
    for conv, _ in tport._PICKLE_CONVERTERS.values():
        assert callable(getattr(tport, conv))
    assert all(hasattr(tport, n) for n in dir(jport) if not n.startswith("_"))
