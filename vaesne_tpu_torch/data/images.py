"""Images from a directory of files, as the model's input tuple.

The port's copy of ``vaesne_tpu/data/images.py``: ``ImagePathDataset``
decodes every file once into one [N, C, H, W] float32 array in [−1, 1]
(``(pixel / 255)·2 − 1``), in sorted file-name order, optionally resized
and in grayscale; ``image_tuple`` makes it the model's input (image, empty
event_loc) on a device, by default the card. Pillow is imported only when a
file is decoded.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..training import resolve_device

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


@dataclass
class ImagePathDataset:
    """Image paths with the (image [C, H, W], empty event_loc) item
    contract."""

    paths: Sequence[str]
    img_size: Optional[int] = None
    grayscale: bool = False

    @classmethod
    def from_dir(cls, root: str, img_size: Optional[int] = None,
                 grayscale: bool = False) -> "ImagePathDataset":
        paths = sorted(os.path.join(root, f) for f in os.listdir(root)
                       if f.lower().endswith(IMG_EXTENSIONS))
        if not paths:
            raise FileNotFoundError(f"no images under {root}")
        return cls(paths, img_size=img_size, grayscale=grayscale)

    def __len__(self) -> int:
        return len(self.paths)

    def _decode(self, path: str) -> np.ndarray:
        from PIL import Image  # noqa: PLC0415

        img = Image.open(path).convert("L" if self.grayscale else "RGB")
        if self.img_size is not None:
            img = img.resize((self.img_size, self.img_size))
        a = np.asarray(img, np.float32) / 255.0
        if a.ndim == 2:
            a = a[..., None]
        return np.transpose(a * 2.0 - 1.0, (2, 0, 1))  # HWC → CHW, [-1, 1]

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._decode(self.paths[i]), np.zeros((0,), np.float32)

    def load_all(self) -> np.ndarray:
        """Decode every image into one [N, C, H, W] float32 array."""
        return np.stack([self._decode(p) for p in self.paths])


def image_tuple(images: np.ndarray, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, C, H, W] float32 → the model input (image, event_loc [N, 0]) on
    ``device``, by default the card (``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    image = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device)
    return image, torch.zeros(images.shape[0], 0, device=device)
