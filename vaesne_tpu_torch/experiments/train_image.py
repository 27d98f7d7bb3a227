"""Train the host-galaxy image VAE (ZTF postage stamps, or the MNIST smoke
config).

The counterpart of ``vaesne_tpu/experiments/train_image.py``:
``ImageVAEConfig`` (60×60×3, patch 2, the hybrid decoder, latent 4×4,
model_dim 32, the ELBO at K = ``train.K``, AdamW lr 1e-3, batch 32), with
fresh flips and affine warps drawn on the device every epoch.

  * ``dataset=synthetic`` (default): 512 images of ``data.make_images``;
  * ``dataset=mnist``: the MNIST smoke config (1 channel, patch 3, beta 0.1,
    lr 1e-3, 50 epochs) on torchvision's MNIST where a local copy exists,
    else on synthetic ring-shaped digits (``load_mnist_like``);
  * ``data=/dir``: the image files of a directory (``ImagePathDataset``).

The checkpoint is ``{dataset}_image_{latent_len}-{latent_dim}_patch{p}``.

Usage:
  python -m vaesne_tpu_torch.experiments.train_image [dataset=mnist] [data=/dir]
      [train.epochs=150] [hybrid=false] ...
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .. import objectives
from ..data import ImagePathDataset, augment_images, image_tuple, make_images
from ..models import HostImgVAE
from ..utils.config import ImageVAEConfig, parse_overrides
from .common import parse_cli, train_loop

# the MNIST smoke config; user overrides still win
MNIST_OVERRIDES = ("in_channels=1", "patch_size=3", "train.beta=0.1", "train.lr=1e-3",
                   "train.epochs=50")


def load_mnist_like(n: int = 512, img_size: int = 60, seed: int = 0,
                    require_real: bool = False, root: str = "./data_mnist"):
    """MNIST [N, 1, img_size, img_size] in [−1, 1] through torchvision where
    a local copy exists (nothing is downloaded), otherwise synthetic
    stroke-like rings of the same shape. ``require_real=True`` (or
    ``VAESNE_REQUIRE_REAL_MNIST=1``) raises instead of falling back."""
    require_real = require_real or os.environ.get("VAESNE_REQUIRE_REAL_MNIST") == "1"
    try:
        from torchvision import datasets, transforms  # noqa: PLC0415

        tfm = transforms.Compose([transforms.Resize((img_size, img_size)),
                                  transforms.ToTensor()])
        ds = datasets.MNIST(root, train=True, download=False, transform=tfm)
        imgs = np.stack([np.asarray(ds[i][0]) for i in range(min(n, len(ds)))])
        return (imgs * 2.0 - 1.0).astype(np.float32)
    except (ImportError, RuntimeError, OSError):  # no torchvision, or no local copy
        if require_real:
            raise
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:img_size, 0:img_size]
        imgs = np.zeros((n, 1, img_size, img_size), np.float32)
        for i in range(n):
            # a rotated elliptical ring per "digit"
            cx, cy = rng.uniform(0.35, 0.65, 2) * img_size
            rx, ry = rng.uniform(8, 20, 2)
            th = rng.uniform(0, np.pi)
            xr = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
            yr = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
            r = np.sqrt((xr / rx) ** 2 + (yr / ry) ** 2)
            imgs[i, 0] = np.exp(-0.5 * ((r - 1.0) / 0.15) ** 2)
        return np.clip(imgs * 2.0 - 1.0, -1.0, 1.0).astype(np.float32)


def build_model(cfg: ImageVAEConfig) -> HostImgVAE:
    m = cfg.model
    return HostImgVAE(img_size=cfg.img_size, patch_size=cfg.patch_size,
                      in_channels=cfg.in_channels, hybrid=cfg.hybrid, focal_loc=cfg.focal_loc,
                      latent_len=m.latent_len, latent_dim=m.latent_dim, model_dim=m.model_dim,
                      num_heads=m.num_heads, ff_dim=m.ff_dim, num_layers=m.num_layers,
                      dropout=m.dropout, selfattn=m.selfattn, beta=cfg.train.beta)


def parse_image_cli(argv):
    """(dataset, data path, config) from the command line."""
    dataset, rest = "synthetic", []
    for a in argv:
        if a.startswith("dataset="):
            dataset = a.split("=", 1)[1]
        else:
            rest.append(a)
    data_path, rest = parse_cli(rest)
    cfg = ImageVAEConfig()
    if dataset == "mnist":
        cfg = parse_overrides(cfg, MNIST_OVERRIDES)
    return dataset, data_path, parse_overrides(cfg, rest)


def main(argv=None, device=None, callback=None):
    """Train on ``device`` (default: the card). Returns (state, losses)."""
    dataset, data_path, cfg = parse_image_cli(list(sys.argv[1:] if argv is None else argv))
    if dataset == "mnist":
        images = load_mnist_like(img_size=cfg.img_size, seed=cfg.train.seed)
    elif data_path:
        images = ImagePathDataset.from_dir(data_path, img_size=cfg.img_size).load_all()
    else:
        images = make_images(n=512, img_size=cfg.img_size, channels=cfg.in_channels,
                             seed=cfg.train.seed)
    train_data = image_tuple(images, device)
    model = build_model(cfg)

    def loss_fn(m, batch, seed):
        return objectives.elbo(m, batch, cfg.train.K, seed=seed)

    def augment(generator, batch):
        # fresh flips and warps every epoch; event_loc stays as it is
        return augment_images(generator, batch[0]), batch[1]

    m = cfg.model
    state, losses = train_loop(
        model, train_data, loss_fn, cfg.train, config=cfg, augment_fn=augment, device=device,
        callback=callback,
        ckpt_name=f"{dataset}_image_{m.latent_len}-{m.latent_dim}_patch{cfg.patch_size}")
    print(f"final loss: {losses[-1]:.6f}")
    return state, losses


if __name__ == "__main__":
    main()
