"""K3 and K6 on the band body (``csrc/band.cuh`` with PACKED), checked on
the CPU.

On the card K3 (whole image and shard canvas) and K6 run K2's and K5's
band body on parity planes: only the passes over device memory change,
each element (i, j) read and written at the packed address
(``_cuda.plane_offset``, the kernel's ``gaddr<true>``), and the launch
takes the flat launch's geometry (``_cuda.band_plan``). Here:

- the packed address indexes ``pack_planes_reference`` of an arange back
  to (i, j), at every cell of ragged even shapes;
- ``test_torch_band_tiling.py``'s plain windowed twin, fed windows gathered
  from the planes through that address and pasting its tiles back through
  it, is bitwise the flat twin's result (f32 and f64, gray and C = 3,
  k = 1, 2, 8, the whole image and every shard canvas of a 2x2 grid);
- a packed launch's geometry, block count and symbol are the flat one's
  at the main path's and ragged shapes;
- every ``extern "C"`` launcher in ``csrc/packed*.cu`` has a
  ``_build.SIGNATURES`` entry with its parameter count.

The cuda-marked tests that hold the kernels bitwise against their first
bodies and against K2/K5 on the unpacked image sit in
``test_torch_kernels.py``, ``test_torch_kernels_mc.py`` and
``test_torch_kernels_shard.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chan_vese_tpu_torch import _build
from chan_vese_tpu_torch.ops import _cuda
from chan_vese_tpu_torch.ops.packed_kernel import (pack_planes_reference,
                                                   unpack_planes_reference)
from test_torch_band_tiling import _canvases, _field, sweep_window, twin

DTYPES = {"f32": np.float32, "f64": np.float64}


@pytest.mark.parametrize("shape", [(2, 2), (6, 10), (58, 90), (16, 8),
                                   (130, 34), (1000, 1502)])
def test_plane_offset_indexes_the_pack(shape):
    h, w = shape
    x = torch.arange(h * w, dtype=torch.int64).reshape(h, w)
    planes = pack_planes_reference(x).reshape(-1)
    i, j = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    assert torch.equal(planes[_cuda.plane_offset(i, j, h, w)], x)
    assert _cuda.plane_offset(h - 1, w - 1, h, w) == h * w - 1


def packed_twin(phi_planes, f_planes, p, k, tile, shard=None):
    """The twin on parity planes: each tile's window (``_cuda.band_window``)
    gathered from the planes through ``_cuda.plane_offset``, swept with the
    plain sweep, its tile pasted back through the same address."""
    h, w = 2 * phi_planes.shape[-2], 2 * phi_planes.shape[-1]
    if shard is None:
        parity, crop, edges = 0, (0, h, 0, w), None
    else:
        parity, *crop = shard[:5]
        edges = shard[5:]
    r0, r1, c0, c1 = crop
    th, tw = tile
    src, fsrc = phi_planes.reshape(-1), f_planes.reshape(-1)
    out = src.clone()
    for tr0 in range(r0, r1, th):
        for tc0 in range(c0, c1, tw):
            tr1, tc1 = min(tr0 + th, r1), min(tc0 + tw, c1)
            win = _cuda.band_window(tr0, tr1, tc0, tc1, h, w, k)
            wr0, wr1, wc0, wc1 = win
            i, j = torch.meshgrid(torch.arange(wr0, wr1),
                                  torch.arange(wc0, wc1), indexing="ij")
            off = _cuda.plane_offset(i, j, h, w)
            cur = sweep_window(src[off], fsrc[off], p, k, parity, win, crop,
                               edges)
            own = np.s_[tr0 - wr0:tr1 - wr0, tc0 - wc0:tc1 - wc0]
            out[off[own]] = cur[own]
    return out.reshape(phi_planes.shape)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_packed_twin_is_bitwise_the_flat_twin(k, channels, dtype):
    # 58 x 90 under 8 x 16 tiles: the last tile row and column are partial
    phi, f, p = _field((58, 90), 50 + k, DTYPES[dtype], channels)
    want = twin(phi, f, p, k, (8, 16))
    got = packed_twin(pack_planes_reference(phi), pack_planes_reference(f),
                      p, k, (8, 16))
    assert torch.equal(unpack_planes_reference(got), want)


# 68 x 92 on 2x2: 34 x 46 shards, so every canvas starts on an even global
# cell (the packed shard mode's lattice parity 0) and has every edge flag
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_packed_twin_is_bitwise_the_flat_twin_on_shard_canvases(k, channels,
                                                                dtype):
    phi, f, p = _field((68, 92), 60 + k, DTYPES[dtype], channels)
    for x, fx, shard in _canvases(phi, f, 2, 2, 4 * k):
        assert shard[0] == 0
        want = twin(x, fx, p, k, (8, 16), shard)
        got = packed_twin(pack_planes_reference(x),
                          pack_planes_reference(fx), p, k, (8, 16), shard)
        assert torch.equal(unpack_planes_reference(got), want), shard


# (h, w, crop, k) of the main path's launches (4K; the 1x1 canvas and a
# 2x2 grid's canvas at comm_k = 8) and ragged ones
GEOMETRY = [(2160, 3840, None, 8), (2224, 3904, (32, 2192, 32, 3872), 8),
            (1144, 1984, (32, 1112, 32, 1952), 8), (1000, 1500, None, 8),
            (1000, 1500, None, 1), (2160, 3840, None, 21), (200, 300, None, 3),
            (90, 140, (10, 80, 10, 130), 2)]


@pytest.mark.parametrize("h,w,crop,k", GEOMETRY)
@pytest.mark.parametrize("c", [0, 3])
def test_packed_launch_takes_the_flat_geometry(h, w, crop, k, c):
    if c and crop is not None:
        with pytest.raises(ValueError, match="no shard-canvas mode"):
            _cuda.band_plan(torch.empty((2, 2, h // 2, w // 2),
                                        device="meta"),
                            torch.empty((c, 2, 2, h // 2, w // 2),
                                        device="meta"),
                            k, (0, *crop, 0, 0, 0, 0), c)
        return
    shard = None if crop is None else (0, *crop, 1, 0, 1, 0)
    lead = (c,) if c else ()
    flat = _cuda.band_plan(torch.empty((h, w), device="meta"),
                           torch.empty((*lead, h, w), device="meta"), k,
                           shard, c)
    packed = _cuda.band_plan(
        torch.empty((2, 2, h // 2, w // 2), device="meta"),
        torch.empty((*lead, 2, 2, h // 2, w // 2), device="meta"), k, shard,
        c)
    assert packed[1:] == flat[1:]
    assert packed[3] == _cuda.band_geometry(
        h, w, k, crop, c + 4 if c else 5, 4 * c if c else 2)
    assert packed[0] == flat[0].replace("cv_", "cv_packed_")


def test_band_plan_refuses_bad_planes():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="planes"):
        _cuda.band_plan(torch.empty((2, 3, 4, 4), **meta),
                        torch.empty((2, 3, 4, 4), **meta), 1)
    with pytest.raises(ValueError, match="u0"):
        _cuda.band_plan(torch.empty((2, 2, 4, 4), **meta),
                        torch.empty((2, 2, 4, 6), **meta), 1)
    with pytest.raises(ValueError, match="k must be"):
        _cuda.band_plan(torch.empty((2, 2, 4, 4), **meta),
                        torch.empty((2, 2, 4, 4), **meta), 0)


_LAUNCHER = re.compile(r'extern "C" cudaError_t (\w+)\(([^)]*)\)', re.S)


def test_every_packed_launcher_has_a_signature():
    found = {}
    for src in sorted((Path(_build.__file__).parent / "csrc").glob(
            "packed*.cu")):
        for name, args in _LAUNCHER.findall(src.read_text()):
            found[name] = args
    assert {"cv_packed_banded_chunk", "cv_packed_banded_chunk_shard",
            "cv_packed_banded_chunk_mc", "cv_packed_band_occupancy",
            "cv_packed_band_occupancy_mc", "cv_packed_banded_chunk_v1",
            "cv_packed_banded_chunk_shard_v1",
            "cv_packed_banded_chunk_mc_v1"} <= set(found)
    for name, args in found.items():
        assert name in _build.SIGNATURES, name
        if not re.fullmatch(r"\s*[A-Z0-9_]+\s*", args):  # not an args macro
            assert len(args.split(",")) == len(_build.SIGNATURES[name]), name
