"""The port's data layer against the JAX package on the CPU: the synthetic
generators, the tuple builders, the npz validator and the augmentation."""

import numpy as np
import pytest
import torch

import vaesne_tpu.data as jdata
import vaesne_tpu_torch.data as tdata
from vaesne_tpu.data.validate import validate_npz as jvalidate
from vaesne_tpu_torch.data.validate import main as validate_main
from vaesne_tpu_torch.data.validate import validate_npz as tvalidate


def _small(maker, seed):
    return maker(n=20, seed=seed, spectrum_bins=48, photometry_length=16)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", ["goldstein", "ztf"])
def test_synthetic_data_is_bitwise_the_jax_packages(kind, seed):
    name = "make_goldstein_like" if kind == "goldstein" else "make_ztf_like"
    want = _small(getattr(jdata, name), seed)
    got = _small(getattr(tdata, name), seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def gold():
    return _small(tdata.make_goldstein_like, 3)


@pytest.mark.parametrize("builder", ["spectra_tuple", "photometry_tuple", "multimodal_tuple"])
def test_tuples_equal_the_jax_packages(gold, builder):
    idx = gold["training_idx"]
    got = getattr(tdata, builder)(gold, idx=idx, device="cpu")
    want = getattr(jdata, builder)(gold, idx=idx)
    flat_got = [t for m in got for t in m] if builder == "multimodal_tuple" else list(got)
    flat_want = [a for m in want for a in m] if builder == "multimodal_tuple" else list(want)
    assert len(flat_got) == len(flat_want)
    for t, a in zip(flat_got, flat_want):
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    # floats fp32, band indices int64 (the embedding's index type), masks
    # True == missing
    dtypes = [t.dtype for t in flat_got]
    assert torch.int64 in dtypes or builder == "spectra_tuple"
    assert all(d in (torch.float32, torch.int64, torch.bool) for d in dtypes)


def test_tuple_builders_need_a_card_unless_the_cpu_is_asked(gold, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.spectra_tuple(gold)


def test_labels_split_and_denormalize_match(gold):
    idx = gold["testing_idx"]
    np.testing.assert_array_equal(tdata.goldstein_labels(gold, idx),
                                  jdata.goldstein_labels(gold, idx))
    for a, b in zip(tdata.train_test_split(gold), jdata.train_test_split(gold)):
        np.testing.assert_array_equal(a, b)
    name = str(gold["identity"][0])
    np.testing.assert_array_equal(tdata.get_goldstein_params(name),
                                  jdata.get_goldstein_params(name))
    assert tdata.denormalize(2.0, 1.0, 3.0) == jdata.denormalize(2.0, 1.0, 3.0) == 7.0


def _set(d, key, fn):
    d = dict(d)
    d[key] = fn(np.array(d[key]))
    return d


def _drop(d, key):
    d = dict(d)
    del d[key]
    return d


def _nan_at(d, mask_value):
    flux = np.array(d["flux"])
    flux[tuple(np.argwhere(d["mask"] == mask_value)[0])] = np.nan
    return dict(d, flux=flux)


def _poke(a, at, value):
    a[at] = value
    return a


# the corruptions of tests/test_data_validate.py, each a function of the
# valid Goldstein dict
CORRUPTIONS = {
    "valid": lambda d: d,
    "missing_key": lambda d: _drop(d, "photomask"),
    "bad_mask_values": lambda d: _set(d, "mask", lambda a: _poke(a, (0, 0), 7)),
    "nan_under_observed_mask": lambda d: _nan_at(d, 1),
    "nan_under_missing_mask": lambda d: _nan_at(d, 0),
    "shape_mismatch": lambda d: _set(d, "wavelength", lambda a: a[:, :-1]),
    "misaligned_modalities": lambda d: _set(d, "photoflux", lambda a: a[:-1]),
    "index_out_of_range": lambda d: _set(d, "training_idx",
                                         lambda a: _poke(a, 0, d["flux"].shape[0] + 5)),
    "overlap": lambda d: dict(d, testing_idx=d["training_idx"][:4]),
    "fractional_band": lambda d: _set(d, "photowavelength",
                                      lambda a: a.astype(np.float32) + 0.5),
    "nonpositive_std": lambda d: dict(d, flux_std=np.float32(0.0)),
    "missing_norm_key": lambda d: _drop(d, "phase_mean"),
}


@pytest.mark.parametrize("kind", ["goldstein", "ztf"])
@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_validate_gives_the_jax_problem_lists(gold, case, kind):
    data = CORRUPTIONS[case](gold)
    want = jvalidate(data, kind=kind)
    assert tvalidate(data, kind=kind) == want
    assert (want == []) == (case in ("valid", "nan_under_missing_mask") and kind == "goldstein")


def test_validate_cli(tmp_path, gold, capsys):
    path = tmp_path / "gold.npz"
    np.savez(path, **gold)
    assert validate_main([str(path)]) == 0
    assert "OK" in capsys.readouterr().out
    np.savez(tmp_path / "bad.npz", **_drop(gold, "phase_mean"))
    assert validate_main([str(tmp_path / "bad.npz")]) == 1
    assert "INVALID" in capsys.readouterr().out
    loaded = tdata.load_npz(str(path))
    assert loaded.keys() == gold.keys()
    for k in gold:
        np.testing.assert_array_equal(loaded[k], gold[k])


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_augmentation_at_zero_rates_is_the_input(gold):
    import jax

    photo, spec = tdata.multimodal_tuple(gold, device="cpu")
    jphoto, jspec = jdata.multimodal_tuple(gold)
    zero = dict(flux_noise=0.0, extra_mask_prob=0.0)
    got = (tdata.augment_spectra(_gen(), spec, **zero),
           tdata.augment_photometry(_gen(), photo, time_shift=0.0, **zero))
    want = (jdata.augment_spectra(jax.random.PRNGKey(0), jspec, **zero),
            jdata.augment_photometry(jax.random.PRNGKey(0), jphoto, time_shift=0.0, **zero))
    for out, inp, jout in zip(got, (spec, photo), want):
        for t, x, j in zip(out, inp, jout):
            np.testing.assert_array_equal(t.numpy(), x.numpy())
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the multimodal form passes its rates to both modalities (time_shift
    # only applies to photometry, so it keeps its default here, as in JAX)
    both = tdata.augment_multimodal(_gen(), (photo, spec), **zero)
    for i, (t, x) in enumerate(zip(both[0] + both[1], photo + spec)):
        if i != 1:
            np.testing.assert_array_equal(t.numpy(), x.numpy())


def _check_noise_and_mask(flux_out, mask_out, n):
    std = flux_out.double().std().item()
    assert abs(std - tdata.augment.FLUX_NOISE) <= 0.02 * tdata.augment.FLUX_NOISE, std
    p = tdata.augment.EXTRA_MASK_PROB
    rate = mask_out.double().mean().item()
    assert abs(rate - p) <= 4 * (p * (1 - p) / n) ** 0.5, rate


def test_augmentation_statistics_at_the_default_rates():
    """Over 1.2·10⁶ draws: flux noise std within 2% of 0.02, the extra mask
    rate 0.05 within 4σ, and one time shift per curve, its std over 20,000
    curves within 3% of 0.1."""
    rows, length = 20000, 60
    zeros = torch.zeros(rows, length)
    none = torch.zeros(rows, length, dtype=torch.bool)
    band = torch.zeros(rows, length, dtype=torch.int64)
    flux, time, band_out, mask = tdata.augment_photometry(_gen(1), (zeros, zeros, band, none))
    _check_noise_and_mask(flux, mask, rows * length)
    assert torch.equal(band_out, band)
    shift = time[:, 0]
    assert torch.equal(time, shift[:, None].expand(rows, length))  # one draw per curve
    assert abs(shift.double().std().item() - 0.1) <= 0.03 * 0.1
    flux, wl, phase, mask = tdata.augment_spectra(
        _gen(2), (zeros, zeros, torch.zeros(rows), none))
    _check_noise_and_mask(flux, mask, rows * length)
    assert torch.equal(wl, zeros) and torch.equal(phase, torch.zeros(rows))
    # extra masking only adds: a missing point stays missing
    full = torch.ones(rows, length, dtype=torch.bool)
    assert tdata.augment_spectra(_gen(3), (zeros, zeros, torch.zeros(rows), full))[3].all()


def test_augmentation_is_a_function_of_its_generator(gold):
    spec = tdata.spectra_tuple(gold, device="cpu")
    a, b, c = (tdata.augment_spectra(_gen(s), spec) for s in (5, 5, 6))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_repeat_dataset_matches_jax(gold):
    photo, spec = tdata.multimodal_tuple(gold, device="cpu")
    got = tdata.repeat_dataset((photo, spec), 3)
    want = jdata.repeat_dataset(jdata.multimodal_tuple(gold), 3)
    for m in range(2):
        for t, a in zip(got[m], want[m]):
            assert t.shape[0] == 3 * photo[0].shape[0]
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
