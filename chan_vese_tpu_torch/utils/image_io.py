"""Image I/O and visualization (numpy only).

Loads images as float arrays at the canonical [0, 255] operating point and
writes masks, phase-label maps, contour overlays and contour-evolution
GIFs. ``.npy``/``.npz`` need nothing beyond numpy; PNG/JPG import Pillow
lazily and GIFs ``imageio.v3``, each raising ``ImportError`` where the
library is missing (there is no silent substitute). Masks, level sets and
images may be torch tensors on any device: each is copied to the host
once.
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


def _iio():
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError("writing an evolution GIF needs imageio "
                          "(imageio.v3)") from e
    return iio


def host_array(x) -> np.ndarray:
    """``x`` as a numpy array; a torch tensor (on any device) is copied to
    the host in one transfer."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
    _save_u8(path, host_array(mask).astype(np.uint8) * 255)


def save_labels(path, labels) -> None:
    """Write an integer phase-label map spread over [0, 255] as 8-bit:
    .npy or an image."""
    lab = host_array(labels)
    k = max(int(lab.max()), 1)
    _save_u8(path, (lab.astype(np.float32) * (255.0 / k)).astype(np.uint8))


def contour_overlay(image, mask, color=(255, 0, 0)) -> np.ndarray:
    """Burn the mask boundary into an RGB copy of ``image``."""
    img = np.asarray(host_array(image), np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = np.clip(img, 0, 255).astype(np.uint8).copy()
    m = np.asarray(host_array(mask), bool)
    inner = m.copy()
    inner[1:, :] &= m[:-1, :]
    inner[:-1, :] &= m[1:, :]
    inner[:, 1:] &= m[:, :-1]
    inner[:, :-1] &= m[:, 1:]
    boundary = m & ~inner
    img[boundary] = color
    return img


def save_overlay(path, image, mask, color=(255, 0, 0)) -> None:
    _save_u8(path, contour_overlay(image, mask, color))


def save_evolution_gif(path, image, phi_frames, every: int = 1,
                       duration_ms: float = 80.0) -> None:
    """Animated contour evolution: one overlay of phi >= 0 a frame.

    duration_ms: per-frame display time; imageio v3's GIF plugin takes
    milliseconds (the v2 API took seconds).
    """
    iio = _iio()
    frames = [contour_overlay(image, host_array(phi) >= 0)
              for phi in phi_frames[::every]]
    iio.imwrite(Path(path), frames, duration=duration_ms, loop=0)


def _save_u8(path, arr: np.ndarray) -> None:
    path = Path(path)
    if path.suffix == ".npy":
        np.save(path, arr)
        return
    _pil().fromarray(arr).save(path)
