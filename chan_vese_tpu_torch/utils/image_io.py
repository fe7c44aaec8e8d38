"""Image I/O (numpy only).

Loads images as float arrays at the canonical [0, 255] operating point and
writes masks and phase-label maps. ``.npy``/``.npz`` need nothing beyond
numpy; PNG/JPG import Pillow lazily and raise if it is missing.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading or writing PNG/JPG needs Pillow; "
                          "use .npy files without it") from e
    return Image


def load_image(path, color: bool = False, dtype=np.float32) -> np.ndarray:
    """Load an image as float in [0, 255]; (H, W) gray or (H, W, 3)."""
    path = Path(path)
    if path.suffix == ".npy":
        return np.asarray(np.load(path), dtype)
    if path.suffix == ".npz":
        with np.load(path) as z:
            return np.asarray(z[z.files[0]], dtype)
    with _pil().open(path) as img:
        return np.asarray(img.convert("RGB" if color else "L"), dtype)


def save_mask(path, mask) -> None:
    """Write a boolean mask as 8-bit (255 = inside): .npy or an image."""
    path = Path(path)
    arr = np.asarray(mask).astype(np.uint8) * 255
    if path.suffix == ".npy":
        np.save(path, arr)
        return
    _pil().fromarray(arr).save(path)


def save_labels(path, labels) -> None:
    """Write an integer phase-label map spread over [0, 255] as 8-bit:
    .npy or an image."""
    path = Path(path)
    lab = np.asarray(labels)
    k = max(int(lab.max()), 1)
    arr = (lab.astype(np.float32) * (255.0 / k)).astype(np.uint8)
    if path.suffix == ".npy":
        np.save(path, arr)
        return
    _pil().fromarray(arr).save(path)
