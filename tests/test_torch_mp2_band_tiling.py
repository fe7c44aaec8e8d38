"""The tiling of K9's band body (``csrc/mp2_band.cu``'s mp2_coupled_kernel,
the banded 4-phase iteration on the card) checked on the CPU through a
plain windowed twin.

The kernel cuts the image, or the whole of a shard canvas cut at its crop,
into tiles (``_cuda.mp2_axis_tiles``: counted back from the crop's first
row/column and forward from it and from its end, the thin outer tiles
folded into their inner neighbour with ``fold``), and runs one coupled
iteration on each tile's window: the tile plus 2 cells each way cut at the
image, one cell more into the crop where the tile ends at the crop's start
or starts at its end, the columns widened to an even start and width. The
twin does the same with the plain PyTorch iteration (``coupled_iteration``:
the lattice parity shifted by the window's origin; on a shard canvas the
depth-2 rim refreshed after each of the four half-sweeps wherever the
window holds a replica and its source, as the kernel does) and pastes the
tile's cells. Its result is held bitwise equal to the plain iteration on
the whole image (``mp2_iteration_reference``) and on every shard canvas of
2x2 and 3x3 grids (``mp2_iteration_sharded_reference``), also over k
launches chained on an 8k-deep canvas, in f32 and f64: the halo of 2 is
exact. Twins with a halo of 1, or without the extra cell into the crop,
are shown to differ, so both are needed. test_torch_kernels_mp2.py and
test_torch_kernels_shard_mp2_morph.py hold the twin against the JAX
package's kernels in interpret mode, beside the tests whose compiled
kernels they reuse.

The remaining cases check ``_cuda.mp2_geometry``: at the main path's
launches (4K; the 2x2 canvas at D = 4, 32, 64; the 3x3 canvas) two or
more blocks fit an SM, every window of the tiling fits the block it
names, and the tiles cover every canvas cell exactly once without
straddling the crop's bounds.
"""

import numpy as np
import pytest
import torch

from chan_vese_tpu_torch.ops import _cuda
from chan_vese_tpu_torch.ops import multiphase_kernel as mk
from chan_vese_tpu_torch.ops.reductions import phase_means
from fixtures import four_regions
from test_torch_band_tiling import _rim
from torch_port_helpers import params, to_torch

DTYPES = {"f32": np.float32, "f64": np.float64}
MU = 0.003 * 255.0 ** 2  # the JAX package's multiphase mu


def _window(t0, t1, n, lo, hi, halo, even=False, into_crop=1):
    """The band body's window along an axis: ``halo`` cells each way, cut
    at the axis, ``into_crop`` more where the tile ends at the crop's start
    or starts at its end; ``even`` widens it to an even start and width."""
    w0 = max(t0 - halo - (into_crop if t0 == hi else 0), 0)
    w1 = min(t1 + halo + (into_crop if t1 == lo else 0), n)
    if even:
        w0 -= w0 % 2
        w1 += (w1 - w0) % 2
    return w0, w1


def twin(phis, u, cs, p, tile, shard=None, halo=_cuda.MP2_HALO,
         into_crop=1):
    """The band body's level sets computed tile by tile with the plain
    coupled iteration: ``tile`` = (TH, TW, fold); ``shard`` =
    ``_cuda.shard_args``' nine ints (None: the whole image)."""
    _, h, w = phis.shape
    th, tw, fold = tile
    if shard is None:
        parity, crop, edges = 0, (0, h, 0, w), None
    else:
        parity, *crop = shard[:5]
        edges = shard[5:]
    r0, r1, c0, c1 = crop
    out = phis.clone()
    for tr0, tr1 in _cuda.mp2_axis_tiles(h, r0, r1, th, fold):
        wr0, wr1 = _window(tr0, tr1, h, r0, r1, halo, into_crop=into_crop)
        for tc0, tc1 in _cuda.mp2_axis_tiles(w, c0, c1, tw, fold):
            wc0, wc1 = _window(tc0, tc1, w, c0, c1, halo, even=True,
                               into_crop=into_crop)
            win = (wr0, wr1, wc0, wc1)
            resync = None if edges is None else (
                lambda x, win=win: _rim(x, win, crop, edges))
            new = mk.coupled_iteration(
                phis[0, wr0:wr1, wc0:wc1], phis[1, wr0:wr1, wc0:wc1],
                u[wr0:wr1, wc0:wc1], cs, p, (parity + wr0 + wc0) % 2, resync)
            for m in range(2):
                out[m, tr0:tr1, tc0:tc1] = new[m][tr0 - wr0:tr1 - wr0,
                                                  tc0 - wc0:tc1 - wc0]
    return out


def _inputs(shape, seed, dtype):
    """Two level sets with structure at every scale (numpy, seeded), the
    noisy four-regions image and the means of their phases."""
    rng = np.random.default_rng(seed)
    h, w = shape
    i, j = np.mgrid[0:h, 0:w]
    phis = np.stack([8.0 * np.sin(i / 5.0) * np.cos(j / 7.0),
                     6.0 * np.cos(i / 4.0 + j / 9.0)])
    phis = phis + rng.standard_normal(phis.shape)
    img = four_regions(h, w, noise=6.0, seed=seed)[0]
    phis_t, u = to_torch(phis, dtype), to_torch(img, dtype)
    cs = torch.stack(phase_means(u, (phis_t[0], phis_t[1]), 1.0))
    return phis_t, u, cs, params(mu=MU)[1]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tile", [(8, 16, 0), (16, 32, 0), (10, 12, 0)])
def test_twin_is_bitwise_the_whole_image_iteration(tile, dtype):
    # 58 x 90: the last tile row and column are partial
    phis, u, cs, p = _inputs((58, 90), 1, DTYPES[dtype])
    want, _ = mk.mp2_iteration_reference(phis, u, cs, p)
    assert torch.equal(twin(phis, u, cs, p, tile), want)


def _canvases(phis, u, nx, ny, D):
    """Every shard's (level-set canvas (2, hc, wc), image canvas, shard
    ints) of an nx x ny grid: the shard's block with D cells of its
    neighbours around it, edge replicas at the global edges (what the halo
    exchange builds), an edge row/column appended where the canvas would be
    odd (the kernels take even canvases)."""
    _, H, W = phis.shape
    h, w = H // nx, W // ny
    pad = torch.nn.functional.pad
    pp = pad(phis[None], (D, D, D, D), mode="replicate")[0]
    up = pad(u[None, None], (D, D, D, D), mode="replicate")[0, 0]
    out = []
    for ix in range(nx):
        for iy in range(ny):
            rows = slice(ix * h, ix * h + h + 2 * D)
            cols = slice(iy * w, iy * w + w + 2 * D)
            x, uc = pp[:, rows, cols], up[rows, cols]
            if x.shape[1] % 2:
                x = torch.cat([x, x[:, -1:]], dim=1)
                uc = torch.cat([uc, uc[-1:]])
            if x.shape[2] % 2:
                x = torch.cat([x, x[:, :, -1:]], dim=2)
                uc = torch.cat([uc, uc[:, -1:]], dim=1)
            edges = (ix == 0, ix == nx - 1, iy == 0, iy == ny - 1)
            shard = _cuda.shard_args(*uc.shape, 1, (ix * h + iy * w) % 2,
                                     (D, D + h, D, D + w), edges)
            out.append((x.contiguous(), uc.contiguous(), shard))
    return out


def _plain_shard(x, uc, cs, p, shard):
    par, r0, r1, c0, c1, *edges = shard
    return mk.mp2_iteration_sharded_reference(x, uc, cs, p, par, edges,
                                              (r0, r1, c0, c1))[0]


# 66 x 90 on 2x2 (33 x 45 shards) and 63 x 75 on 3x3 (21 x 25): odd
# shards, so both lattice parities, every edge flag and a centre shard;
# k launches chained on an 8k-deep canvas (k = 1: the D = 4 canvas)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fold", [0, 1])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("grid,shape", [((2, 2), (66, 90)),
                                        ((3, 3), (63, 75))])
def test_twin_is_bitwise_the_shard_canvas_iteration(grid, shape, k, fold,
                                                    dtype):
    phis, u, cs, p = _inputs(shape, 2 + k, DTYPES[dtype])
    parities = set()
    for x, uc, shard in _canvases(phis, u, *grid, 4 if k == 1 else 8 * k):
        want = got = x
        for _ in range(k):
            want = _plain_shard(want, uc, cs, p, shard)
            got = twin(got, uc, cs, p, (8, 16, fold), shard)
        assert torch.equal(got, want), shard
        parities.add(shard[0])
    assert parities == {0, 1}


def test_a_halo_of_1_is_not_enough():
    phis, u, cs, p = _inputs((58, 90), 5, np.float64)
    want, _ = mk.mp2_iteration_reference(phis, u, cs, p)
    assert torch.equal(twin(phis, u, cs, p, (8, 16, 0)), want)
    assert not torch.equal(twin(phis, u, cs, p, (8, 16, 0), halo=1), want)


def test_the_cell_into_the_crop_is_needed():
    """Without folding, the tile above (left of) the crop holds the top
    (left) replicas; with no extra cell their source lies 2 deep in its
    window, where phi0's black half-sweep leaves it wrong, and the refresh
    copies the wrong value into the tile."""
    phis, u, cs, p = _inputs((66, 90), 6, np.float64)
    x, uc, shard = _canvases(phis, u, 2, 2, 16)[0]
    want = _plain_shard(x, uc, cs, p, shard)
    assert torch.equal(twin(x, uc, cs, p, (8, 16, 0), shard), want)
    assert not torch.equal(twin(x, uc, cs, p, (8, 16, 0), shard,
                                into_crop=0), want)


def test_kernel_window_is_the_twins():
    for n, lo, hi in ((58, 0, 58), (2160, 0, 2160), (1088, 4, 1084),
                      (1208, 64, 1144), (90, 10, 80)):
        for t, fold in ((8, 0), (16, 1), (56, 1), (72, 0)):
            for t0, t1 in _cuda.mp2_axis_tiles(n, lo, hi, t, fold):
                for even in (False, True):
                    assert _cuda.mp2_window(t0, t1, n, lo, hi, even) == \
                        _window(t0, t1, n, lo, hi, _cuda.MP2_HALO, even)


@pytest.mark.parametrize("n,lo,hi", [(58, 0, 58), (1088, 4, 1084),
                                     (1208, 64, 1144), (90, 10, 80),
                                     (40, 3, 37)])
@pytest.mark.parametrize("t", [8, 16, 56, 64])
@pytest.mark.parametrize("fold", [0, 1])
def test_axis_tiles_cover_the_axis_cut_at_the_crop(n, lo, hi, t, fold):
    tiles = _cuda.mp2_axis_tiles(n, lo, hi, t, fold)
    assert tiles[0][0] == 0 and tiles[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    assert all(t0 < t1 for t0, t1 in tiles)
    # no tile straddles the crop's bounds, unless it folded in a rim
    # thinner than a tile
    for t0, t1 in tiles:
        if t0 < lo < t1:
            assert fold and lo < t
        if t0 < hi < t1:
            assert fold and n - hi < t
    # folded: no tile outside the crop is thinner than t
    if fold:
        assert all(t1 - t0 >= t for t0, t1 in tiles if t1 <= lo or t0 >= hi)


# the main path's K9 launches: 4K, the 2x2 grid's canvases at comm_k = 1
# (D = 4) and 8 (D = 64), D = 32, and the 3x3 grid's (720 x 1280 shards)
MAIN = [((2160, 3840), None), ((1088, 1928), (4, 1084, 4, 1924)),
        ((1144, 1984), (32, 1112, 32, 1952)),
        ((1208, 2048), (64, 1144, 64, 1984)),
        ((728, 1288), (4, 724, 4, 1284))]


@pytest.mark.parametrize("shape,crop", MAIN)
def test_main_path_geometry_fits_two_blocks_an_sm(shape, crop):
    h, w = shape
    th, tw, fold, px, py, cap = _cuda.mp2_geometry(h, w, crop)
    static = _cuda.mp2_static_bytes()
    assert _cuda.MP2_BAND_CELL_BYTES * cap + static <= _cuda.SMEM_LIMIT + 1024
    assert px * py <= _cuda.BAND_THREADS
    assert _cuda.mp2_blocks_per_sm(px * py, cap) >= 2
    assert cap % 2 == 0
    r0, r1, c0, c1 = crop or (0, h, 0, w)
    rows = _cuda.mp2_axis_tiles(h, r0, r1, th, fold)
    cols = _cuda.mp2_axis_tiles(w, c0, c1, tw, fold)
    cover = torch.zeros((h, w), dtype=torch.int32)
    for tr0, tr1 in rows:
        wr0, wr1 = _cuda.mp2_window(tr0, tr1, h, r0, r1)
        assert wr1 - wr0 <= py * _cuda.MP2_ROWS
        for tc0, tc1 in cols:
            wc0, wc1 = _cuda.mp2_window(tc0, tc1, w, c0, c1, even=True)
            assert wc1 - wc0 <= 2 * px and wc0 % 2 == 0
            assert (wc1 - wc0) % 2 == 0
            assert (wr1 - wr0) * (wc1 - wc0) <= cap
            cover[tr0:tr1, tc0:tc1] += 1
    assert bool((cover == 1).all())
    blocks = _cuda.mp2_plan(h, w, None if crop is None
                            else (0, *crop, 0, 0, 0, 0))[1]
    assert blocks == len(rows) * len(cols)
