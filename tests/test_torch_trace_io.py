"""The port's energy traces (utils/trace.py) and its overlays and
evolution GIFs (utils/image_io.py) against the JAX package's.

- ``write_energy_csv``: the same arrays (f32 and f64, scalar and
  per-channel means, with and without delta) give byte-identical CSVs,
  whether the port gets numpy arrays or torch tensors.
- ``read_energy_csv`` and ``trace_parity`` agree on those files, and
  ``trace_parity`` keeps the length check.
- ``contour_overlay`` is bitwise the reference's (gray and RGB images,
  the default and another colour); ``save_overlay``'s PNG and ``.npy``
  decode to the same arrays.
- ``save_evolution_gif``: the decoded frames are equal (every frame and
  every other one).
- A missing Pillow or imageio raises ImportError naming the library.
"""

import sys

import numpy as np
import pytest
import torch

from chan_vese_tpu.utils import image_io as jio
from chan_vese_tpu.utils import trace as jtrace
from chan_vese_tpu_torch.utils import image_io as tio
from chan_vese_tpu_torch.utils import trace as ttrace
from fixtures import colored_squares, two_disks
from torch_port_helpers import to_torch


def trace_arrays(dtype, channels, n=12, seed=0):
    rng = np.random.default_rng(seed)
    energy = (1e6 * rng.random(n)).astype(dtype)
    delta = rng.random(n).astype(dtype) * 1e-3
    shape = (n, channels) if channels else (n,)
    c1 = (255 * rng.random(shape)).astype(dtype)
    c2 = (255 * rng.random(shape)).astype(dtype)
    return energy, delta, c1, c2


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("with_delta", [True, False])
@pytest.mark.parametrize("as_tensor", [True, False])
def test_csv_byte_identical(tmp_path, dtype, channels, with_delta,
                            as_tensor):
    energy, delta, c1, c2 = trace_arrays(dtype, channels)
    if not with_delta:
        delta = None
    jtrace.write_energy_csv(tmp_path / "j.csv", energy, delta, c1, c2)
    conv = (lambda a: None if a is None else torch.from_numpy(a)) \
        if as_tensor else (lambda a: a)
    ttrace.write_energy_csv(tmp_path / "t.csv", conv(energy), conv(delta),
                            conv(c1), conv(c2))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path /
                                                 "j.csv").read_bytes()


def test_csv_energy_only_byte_identical(tmp_path):
    energy = trace_arrays(np.float64, 0)[0]
    jtrace.write_energy_csv(tmp_path / "j.csv", energy)
    ttrace.write_energy_csv(tmp_path / "t.csv", torch.from_numpy(energy))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path /
                                                 "j.csv").read_bytes()


def test_read_and_parity_agree(tmp_path):
    a = trace_arrays(np.float64, 3, seed=1)
    b = trace_arrays(np.float64, 3, seed=2)
    jtrace.write_energy_csv(tmp_path / "a.csv", *a)
    jtrace.write_energy_csv(tmp_path / "b.csv", *b)
    got, want = (ttrace.read_energy_csv(tmp_path / "a.csv"),
                 jtrace.read_energy_csv(tmp_path / "a.csv"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for col in ("energy", "delta", "c1_2"):
        assert ttrace.trace_parity(tmp_path / "a.csv", tmp_path / "b.csv",
                                   col) == jtrace.trace_parity(
            tmp_path / "a.csv", tmp_path / "b.csv", col)


def test_parity_length_check(tmp_path):
    e = trace_arrays(np.float64, 0)[0]
    ttrace.write_energy_csv(tmp_path / "a.csv", e)
    ttrace.write_energy_csv(tmp_path / "b.csv", e[:7])
    with pytest.raises(ValueError, match="trace lengths differ"):
        ttrace.trace_parity(tmp_path / "a.csv", tmp_path / "b.csv")
    assert ttrace.trace_parity(tmp_path / "a.csv", tmp_path / "b.csv",
                               allow_prefix=True) == 0.0


def overlay_inputs(kind):
    if kind == "gray":
        img, gt = two_disks(32, 64, noise=20.0)
    else:
        img, gt = colored_squares(32, 64, noise=20.0)
        gt = gt.any(-1) if gt.ndim == 3 else gt
    return img, gt


@pytest.mark.parametrize("kind", ["gray", "rgb"])
@pytest.mark.parametrize("color", [(255, 0, 0), (0, 200, 40)])
def test_contour_overlay_bitwise(kind, color):
    img, mask = overlay_inputs(kind)
    want = jio.contour_overlay(img, mask, color)
    got = tio.contour_overlay(to_torch(img), torch.from_numpy(mask), color)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tio.contour_overlay(img, mask, color),
                                  want)


@pytest.mark.parametrize("suffix", [".png", ".npy"])
def test_save_overlay_same_file_content(tmp_path, suffix):
    img, mask = overlay_inputs("gray")
    jio.save_overlay(tmp_path / f"j{suffix}", img, mask)
    tio.save_overlay(tmp_path / f"t{suffix}", img, torch.from_numpy(mask))
    if suffix == ".npy":
        got, want = (np.load(tmp_path / f"{n}.npy") for n in "tj")
    else:
        got, want = (tio.load_image(tmp_path / f"{n}.png", color=True)
                     for n in "tj")
    np.testing.assert_array_equal(got, want)


def phi_frames(n=5):
    img, _ = two_disks(32, 64, noise=8.0)
    i, j = np.mgrid[0:32, 0:64]
    return img, [8.0 + 2 * k - np.hypot(i - 16, j - 32) for k in range(n)]


@pytest.mark.parametrize("every", [1, 2])
def test_evolution_gif_frames_equal(tmp_path, every):
    iio = pytest.importorskip("imageio.v3")
    img, frames = phi_frames()
    jio.save_evolution_gif(tmp_path / "j.gif", img, frames, every=every)
    tio.save_evolution_gif(tmp_path / "t.gif", to_torch(img),
                           [torch.from_numpy(f) for f in frames],
                           every=every)
    got, want = (iio.imread(tmp_path / f"{n}.gif", index=None)
                 for n in "tj")
    assert got.shape == want.shape and len(got) == len(frames[::every])
    np.testing.assert_array_equal(got, want)


def test_missing_imageio_raises(tmp_path, monkeypatch):
    img, frames = phi_frames(2)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    with pytest.raises(ImportError, match="imageio"):
        tio.save_evolution_gif(tmp_path / "t.gif", img, frames)


def test_missing_pillow_raises_for_images_only(tmp_path, monkeypatch):
    img, mask = overlay_inputs("gray")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        tio.save_overlay(tmp_path / "t.png", img, mask)
    tio.save_overlay(tmp_path / "t.npy", img, mask)
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"),
                                  jio.contour_overlay(img, mask))
