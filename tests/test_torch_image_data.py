"""The port's image data against the JAX package's on the CPU: the
synthetic images, the image-file loader, and the affine augmentation. The
warp is held to the JAX function on fixed parameters (max-abs within 1e-5:
one bilinear sum of four fp32 terms, with cos and sin from two libraries);
the random draws come from a torch generator (different numbers than
JAX's, the same distributions), so they are checked for what they must
be: reproducible, in range, flips at rate one half, translations whole
pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaesne_tpu.data as jdata
import vaesne_tpu_torch.data.augment as taug
from vaesne_tpu_torch.data import (
    ImagePathDataset,
    affine_warp,
    augment_images,
    image_tuple,
    make_images,
    random_affine,
)

ATOL = 1e-5


def _warp_both(imgs, theta, scale, tx, ty, fill=-1.0):
    n = imgs.shape[0]
    args = [np.full(n, v, np.float32) if np.isscalar(v) else np.asarray(v, np.float32)
            for v in (theta, scale, tx, ty)]
    got = affine_warp(torch.from_numpy(imgs), *(torch.from_numpy(a) for a in args), fill)
    want = jdata.affine_warp(jnp.asarray(imgs), *(jnp.asarray(a) for a in args), fill)
    assert got.shape == imgs.shape and got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n,size,channels,seed", [(4, 16, 3, 0), (3, 60, 1, 5)])
def test_make_images_is_the_jax_generator_bitwise(n, size, channels, seed):
    got = make_images(n=n, img_size=size, channels=channels, seed=seed)
    np.testing.assert_array_equal(got, jdata.make_images(n=n, img_size=size,
                                                         channels=channels, seed=seed))
    assert got.dtype == np.float32 and got.min() >= -1.0 and got.max() <= 1.0


def test_affine_warp_identity():
    imgs = make_images(n=2, img_size=9)
    got, want = _warp_both(imgs, 0.0, 1.0, 0.0, 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, imgs, rtol=0, atol=ATOL)


def test_affine_warp_whole_pixel_translation():
    """t = (2, 1) px: out(p) = in(p − t) where p − t stays in the frame, the
    fill on the vacated border."""
    imgs = make_images(n=2, img_size=9)
    got, want = _warp_both(imgs, 0.0, 1.0, 2.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[:, :, 1:, 2:], imgs[:, :, :-1, :-2], rtol=0, atol=ATOL)
    assert (got[:, :, :1] == -1.0).all() and (got[:, :, :, :2] == -1.0).all()


def test_affine_warp_rot90_on_an_odd_size():
    """θ = 90° maps the integer grid of an odd-sized square onto itself:
    out = rot90(in, k=−1)."""
    imgs = make_images(n=2, img_size=7)
    got, want = _warp_both(imgs, np.pi / 2, 1.0, 0.0, 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, np.rot90(imgs, k=-1, axes=(-2, -1)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("scale", [0.8, 1.2])
def test_affine_warp_scale_mixes_the_fill_at_the_border(scale):
    """Scale about the centre (3, 3) of a 7×7 image, fill −1. At 0.8 the
    top-centre pixel samples row 3 − 3/0.8 = −0.75: the fill at weight 0.75
    and row 0 at 0.25, as map_coordinates' cval gives it. At 1.2 every
    sample lies inside."""
    imgs = np.random.default_rng(3).normal(size=(2, 3, 7, 7)).astype(np.float32)
    got, want = _warp_both(imgs, 0.0, scale, 0.0, 0.0, fill=-1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if scale < 1:
        np.testing.assert_allclose(got[:, :, 0, 3], 0.75 * -1.0 + 0.25 * imgs[:, :, 0, 3],
                                   rtol=0, atol=ATOL)


def test_affine_warp_general_case_against_jax():
    """Per-image rotation, scale and translation together on a non-square
    batch, fills 0 and 0.5."""
    imgs = np.random.default_rng(0).normal(size=(3, 2, 11, 17)).astype(np.float32)
    for fill in (0.0, 0.5):
        got, want = _warp_both(imgs, [0.2, -0.7, 2.9], [1.1, 0.75, 1.25], [2.0, -1.0, 0.0],
                               [-1.0, 3.0, 0.5], fill=fill)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_augment_images_is_reproducible_and_in_range():
    imgs = torch.from_numpy(make_images(n=16, img_size=20))
    a = augment_images(torch.Generator().manual_seed(3), imgs)
    b = augment_images(torch.Generator().manual_seed(3), imgs)
    c = augment_images(torch.Generator().manual_seed(4), imgs)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == imgs.shape and a.dtype == imgs.dtype
    assert a.min().item() >= -1.0 - 1e-5 and a.max().item() <= imgs.max().item() + 1e-5
    # every image moved (continuous angle and scale draws)
    assert bool(((a - imgs).abs().amax(dim=(1, 2, 3)) > 1e-3).all())


def test_augment_images_flips_each_axis_half_the_time(monkeypatch):
    """With the affine step off, each image is itself, its left-right
    mirror, its up-down mirror or both; over 4,000 images each flip comes
    up at rate 0.5 within 4σ (σ = 0.0079)."""
    monkeypatch.setattr(taug, "random_affine", lambda generator, x: x)
    n = 4000
    base = torch.arange(12.0).reshape(1, 1, 3, 4).expand(n, 1, 3, 4)
    out = augment_images(torch.Generator().manual_seed(0), base)
    h = v = 0
    for img in out:
        for flip_h in (False, True):
            for flip_v in (False, True):
                want = base[0]
                want = want.flip(-1) if flip_h else want
                want = want.flip(-2) if flip_v else want
                if torch.equal(img, want):
                    h, v = h + flip_h, v + flip_v
    sigma = (0.25 / n) ** 0.5
    assert abs(h / n - 0.5) <= 4 * sigma and abs(v / n - 0.5) <= 4 * sigma, (h, v)


def _whole_pixel_shift(out, ref, reach):
    """The (dx, dy) with |dx|, |dy| ≤ reach of which ``out`` is ``ref``
    shifted, the fill −1 behind, or None."""
    h, w = ref.shape[-2:]
    for dx in range(-reach, reach + 1):
        for dy in range(-reach, reach + 1):
            shifted = np.full_like(ref, -1.0)
            shifted[:, max(0, dy): h - max(0, -dy), max(0, dx): w - max(0, -dx)] = \
                ref[:, max(0, -dy): h - max(0, dy), max(0, -dx): w - max(0, dx)]
            if np.allclose(out, shifted, atol=ATOL):
                return dx, dy
    return None


def test_random_affine_translations_are_whole_pixels():
    """Rotation and scale pinned to the identity: each output is the input
    shifted by whole pixels (|t| ≤ round(0.2·11) = 2), the fill behind."""
    imgs = torch.from_numpy(make_images(n=8, img_size=11))
    out = random_affine(torch.Generator().manual_seed(0), imgs, degrees=0.0, translate=0.2,
                        scale=(1.0, 1.0)).numpy()
    shifts = [_whole_pixel_shift(o, r, 2) for o, r in zip(out, imgs.numpy())]
    assert None not in shifts and len(set(shifts)) > 1, shifts
    ident = random_affine(torch.Generator().manual_seed(0), imgs, degrees=0.0, translate=0.0,
                          scale=(1.0, 1.0))
    np.testing.assert_allclose(ident.numpy(), imgs.numpy(), rtol=0, atol=ATOL)


def _write_pngs(root, sizes):
    from PIL import Image

    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / f"img_{i:02d}.png")
    (root / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("img_size,grayscale", [(None, False), (12, False), (12, True)])
def test_image_path_dataset_matches_the_jax_loader(tmp_path, img_size, grayscale):
    pytest.importorskip("PIL")
    from vaesne_tpu.data.images import ImagePathDataset as JaxDataset

    _write_pngs(tmp_path, [(16, 16)] * 3 if img_size is None else [(16, 16), (9, 20), (30, 7)])
    ds = ImagePathDataset.from_dir(str(tmp_path), img_size=img_size, grayscale=grayscale)
    want = JaxDataset.from_dir(str(tmp_path), img_size=img_size, grayscale=grayscale)
    assert ds.paths == want.paths and len(ds) == 3
    got = ds.load_all()
    np.testing.assert_array_equal(got, want.load_all())
    assert got.shape == (3, 1 if grayscale else 3, img_size or 16, img_size or 16)
    image, loc = ds[1]
    np.testing.assert_array_equal(image, got[1])
    assert loc.shape == (0,)


def test_image_path_dataset_needs_images(tmp_path):
    (tmp_path / "a.txt").write_text("x")
    with pytest.raises(FileNotFoundError, match="no images"):
        ImagePathDataset.from_dir(str(tmp_path))


def test_image_tuple_is_the_model_contract(monkeypatch):
    imgs = make_images(n=3, img_size=8)
    image, loc = image_tuple(imgs, "cpu")
    assert torch.equal(image, torch.from_numpy(imgs)) and loc.shape == (3, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        image_tuple(imgs)
