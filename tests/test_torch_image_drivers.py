"""The port's image training driver ``train_image.main`` on the CPU at a
small size (12×12 images, model_dim 8, batch 8): it trains, checkpoints and
resumes to the uninterrupted run, runs the MNIST smoke config on its
synthetic fallback and a directory of image files, and refuses what the
JAX driver refuses."""

import json
import os

import numpy as np
import pytest
import torch

from vaesne_tpu.experiments import train_image as jdriver
from vaesne_tpu.utils import config as jcfg
from vaesne_tpu_torch.experiments import train_image
from vaesne_tpu_torch.utils import config as tcfg

TINY = ["img_size=12", "model.latent_len=2", "model.latent_dim=2", "model.model_dim=8",
        "model.ff_dim=8", "model.num_layers=2", "model.num_heads=2", "train.batch_size=8"]


def _argv(root, *extra):
    # one copy of each image an epoch: the x5 copies are test_torch_image_reference's
    return [*TINY, "aug_factor=1", "train.save_every=1", f"train.ckpt_dir={root / 'ck'}",
            f"train.log_dir={root / 'logs'}", *extra]


def test_trains_checkpoints_and_resumes_to_the_uninterrupted_run(tmp_path):
    """2 epochs in one run, and 1 epoch then a resumed run to 2, through
    main with dropout 0.1 and the flips and warps on: the same losses and
    parameters within 1e-6 of max |param| (they come out bitwise)."""
    whole, losses = train_image.main(_argv(tmp_path / "a", "train.epochs=2"), device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert whole.step == 2 * (512 // 8)
    train_image.main(_argv(tmp_path / "b", "train.epochs=1"), device="cpu")
    resumed, resumed_losses = train_image.main(
        _argv(tmp_path / "b", "train.epochs=2", "train.resume=true"), device="cpu")
    assert resumed.step == whole.step and resumed_losses == losses
    scale = max(p.abs().max().item() for p in whole.model.parameters())
    diff = max((a - b).abs().max().item()
               for a, b in zip(whole.model.parameters(), resumed.model.parameters()))
    assert diff <= 1e-6 * scale, diff
    ckpt = tmp_path / "b" / "ck" / "synthetic_image_2-2_patch2"
    assert sorted(os.listdir(ckpt)) == ["config.json", "losses.npy", "progress.json", "state.pt"]
    saved = json.loads((ckpt / "config.json").read_text())
    assert saved["_config_class"] == "ImageVAEConfig" and saved["img_size"] == 12


def test_the_config_is_the_jax_drivers(tmp_path):
    """The same command line gives the JAX driver's config, field for
    field (the mnist overrides included, a user's override winning)."""
    for argv in (TINY, ["dataset=mnist", *TINY], ["dataset=mnist", "patch_size=4"]):
        dataset, _, cfg = train_image.parse_image_cli(argv)
        rest = [a for a in argv if not a.startswith("dataset=")]
        want = jcfg.ImageVAEConfig()
        if dataset == "mnist":
            want = jcfg.parse_overrides(want, list(train_image.MNIST_OVERRIDES))
        assert tcfg.asdict(cfg) == jcfg.asdict(jcfg.parse_overrides(want, rest))
    assert train_image.parse_image_cli(["dataset=mnist"])[2].patch_size == 3


def test_mnist_runs_its_synthetic_fallback(tmp_path):
    """No local MNIST copy (nor torchvision here): the synthetic rings,
    [N, 1, H, W] in [−1, 1], the JAX driver's arrays bitwise; one epoch of
    the MNIST config (1 channel, patch 3) trains on them."""
    imgs = train_image.load_mnist_like(n=4, img_size=12, root=str(tmp_path / "none"))
    np.testing.assert_array_equal(
        imgs, jdriver.load_mnist_like(n=4, img_size=12, root=str(tmp_path / "none")))
    assert imgs.shape == (4, 1, 12, 12) and imgs.min() >= -1.0 and imgs.max() <= 1.0
    state, losses = train_image.main(["dataset=mnist", *_argv(tmp_path, "train.epochs=1")],
                                     device="cpu")
    assert np.isfinite(losses).all() and state.model.enc.patch_embed.proj.in_channels == 1
    assert (tmp_path / "ck" / "mnist_image_2-2_patch3" / "state.pt").exists()


def test_require_real_mnist_raises_without_a_copy(tmp_path, monkeypatch):
    with pytest.raises(Exception):
        train_image.load_mnist_like(n=1, require_real=True, root=str(tmp_path / "none"))
    monkeypatch.setenv("VAESNE_REQUIRE_REAL_MNIST", "1")
    with pytest.raises(Exception):
        train_image.main(["dataset=mnist", *_argv(tmp_path, "train.epochs=1")], device="cpu")
    assert not (tmp_path / "ck").exists()


def test_trains_on_a_directory_of_image_files(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    rng = np.random.default_rng(0)
    (tmp_path / "stamps").mkdir()
    for i in range(16):
        Image.fromarray(rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)).save(
            tmp_path / "stamps" / f"{i:02d}.png")
    state, losses = train_image.main(
        [f"data={tmp_path / 'stamps'}", *_argv(tmp_path, "train.epochs=1")], device="cpu")
    assert state.step == 2 and np.isfinite(losses).all()


def test_needs_a_card_unless_the_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_image.main(_argv(tmp_path, "train.epochs=1"))
