"""The tiling of the band body (``csrc/band.cuh``, K2 and K5 on the card)
checked on the CPU through a plain windowed twin.

The kernel cuts the image (or a shard canvas's crop) into tiles and sweeps
each tile's window, the tile plus 2k cells each way cut at the image
(``_cuda.band_window``), with clamped reads at the window's sides. The twin
does the same with the plain PyTorch sweep: for every tile of a tiling it
cuts the window, runs k plain red-black iterations on it (the lattice
parity shifted by the window's origin; on a shard canvas the depth-2 rim
refreshed after each half-sweep wherever the window holds a replica and
its source, as the kernel does) and pastes the tile's cells. Its result is
held bitwise equal to the whole-image plain run (``fused_kernel.iterate``)
and to the shard canvas's plain run (``chunk_shard_reference``), in f32
and f64, gray and C = 3, on ragged tilings: the 2k reach is exact. A twin
with 2k - 1 cells of halo is shown to differ, so the reach is also tight.
One case holds the twin against the JAX package's red-black sweep.

The remaining cases check ``_cuda.band_geometry``: every window of its
tiling fits the block it names, the main path's shapes fit the shared
memory with two blocks an SM, and every k up to 21 that the first
body's geometry (``tile_geometry``) takes is taken.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.ops import sweep as jsweep
from chan_vese_tpu_torch.ops import _cuda
from chan_vese_tpu_torch.ops.fused_kernel import chunk_shard_reference, \
    iterate
from chan_vese_tpu_torch.ops.fused_kernel_mc import data_term_mc
from chan_vese_tpu_torch.ops.reductions import data_term
from chan_vese_tpu_torch.ops.sweep import _update_all, color_masks
from torch_port_helpers import assert_rel, params, to_np, to_torch

DTYPES = {"f32": np.float32, "f64": np.float64}


def _window(tr0, tr1, tc0, tc1, h, w, halo):
    """The band body's window with ``halo`` cells each way (2k in the
    kernel)."""
    wr0, wr1 = max(tr0 - halo, 0), min(tr1 + halo, h)
    wc0, wc1 = max(tc0 - halo, 0) & ~1, min(tc1 + halo, w)
    return wr0, wr1, wc0, wc1 + ((wc1 - wc0) & 1)


def _rim(x, win, crop, edges):
    """The kernel's rim refresh on a window: rows r0-1, r0-2 from r0 (top),
    r1, r1+1 from r1-1 (bottom), then the columns, each where the window
    holds the replica and its source (cf. chunk_shard_reference's whole
    canvas refresh)."""
    wr0, wr1, wc0, wc1 = win
    r0, r1, c0, c1 = crop
    top, bottom, left, right = edges
    x = x.clone()
    for flag, dsts, src in ((top, (r0 - 1, r0 - 2), r0),
                            (bottom, (r1, r1 + 1), r1 - 1)):
        for dst in dsts:
            if flag and wr0 <= dst < wr1 and wr0 <= src < wr1:
                x[dst - wr0] = x[src - wr0]
    for flag, dsts, src in ((left, (c0 - 1, c0 - 2), c0),
                            (right, (c1, c1 + 1), c1 - 1)):
        for dst in dsts:
            if flag and wc0 <= dst < wc1 and wc0 <= src < wc1:
                x[:, dst - wc0] = x[:, src - wc0]
    return x


def sweep_window(cur, fw, p, k, parity, win, crop=None, edges=None):
    """k plain red-black iterations on a window ``win`` = (wr0, wr1, wc0,
    wc1) of phi (``cur``) and its force (``fw``): the lattice parity shifted
    by the window's origin; with ``edges`` the depth-2 rim of ``crop``
    refreshed after each half-sweep, as the kernel does."""
    wr0, _, wc0, _ = win
    red = color_masks(cur.shape, (parity + wr0 + wc0) % 2)
    for _ in range(k):
        cur = torch.where(red, _update_all(cur, fw, p.mu, p.dt, p.eps,
                                           p.eta2), cur)
        if edges is not None:
            cur = _rim(cur, win, crop, edges)
        cur = torch.where(red, cur, _update_all(cur, fw, p.mu, p.dt, p.eps,
                                                p.eta2))
        if edges is not None:
            cur = _rim(cur, win, crop, edges)
    return cur


def twin(phi, f, p, k, tile, shard=None, halo=None):
    """The band body's result computed tile by tile with the plain sweep:
    ``tile`` = (TH, TW); ``shard`` = ``_cuda.shard_args``' nine ints (None:
    the whole image); ``halo`` the window's reach (default 2k)."""
    h, w = phi.shape
    halo = 2 * k if halo is None else halo
    if shard is None:
        parity, crop, edges = 0, (0, h, 0, w), None
    else:
        parity, *crop = shard[:5]
        edges = shard[5:]
    r0, r1, c0, c1 = crop
    th, tw = tile
    out = phi.clone()
    for tr0 in range(r0, r1, th):
        for tc0 in range(c0, c1, tw):
            tr1, tc1 = min(tr0 + th, r1), min(tc0 + tw, c1)
            win = _window(tr0, tr1, tc0, tc1, h, w, halo)
            wr0, wr1, wc0, wc1 = win
            cur = sweep_window(phi[wr0:wr1, wc0:wc1], f[wr0:wr1, wc0:wc1],
                               p, k, parity, win, crop, edges)
            out[tr0:tr1, tc0:tc1] = cur[tr0 - wr0:tr1 - wr0,
                                        tc0 - wc0:tc1 - wc0]
    return out


def _field(shape, seed, dtype, channels):
    """A level set with structure at every scale and its force: phi from
    numpy noise (seeded), f from a noisy two-level image (gray) or three
    channels of it (C = 3, the mc data term)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    i, j = np.mgrid[0:h, 0:w]
    phi = 8.0 * np.sin(i / 5.0) * np.cos(j / 7.0) + rng.standard_normal(shape)
    img = np.where(np.hypot(i - h / 3, j - w / 2) < min(h, w) / 3, 200.0,
                   50.0) + 10.0 * rng.standard_normal((max(channels, 1), h, w))
    _, p = params()
    phi_t = to_torch(phi, dtype)
    if channels:
        u = to_torch(img, dtype)
        c1 = torch.tensor([190.0, 195.0, 205.0], dtype=u.dtype)
        c2 = torch.tensor([45.0, 55.0, 60.0], dtype=u.dtype)
        l1, l2 = p.channel_lambdas(channels, (1.0, 1.2, 0.8),
                                   (0.9, 1.0, 1.1))
        f = data_term_mc(u, c1, c2, p, l1, l2)
    else:
        u = to_torch(img[0], dtype)
        f = data_term(u, 195.0, 52.0, p.nu, p.lambda1, p.lambda2)
    return phi_t, f, p


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_twin_is_bitwise_the_whole_image_run(k, channels, dtype):
    # 58 x 90 under 8 x 16 tiles: the last tile row and column are partial
    phi, f, p = _field((58, 90), 10 + k, DTYPES[dtype], channels)
    want, _ = iterate(phi, f, p, k)
    got = twin(phi, f, p, k, (8, 16))
    assert torch.equal(got, want)


def _canvases(phi, f, nx, ny, D):
    """Every shard's (phi canvas, f canvas, shard ints) of an nx x ny grid:
    the shard's block with D cells of its neighbours around it, edge
    replicas at the global edges (what the halo exchange builds), an edge
    row/column appended where the canvas would be odd (the kernels take
    even canvases)."""
    H, W = phi.shape
    h, w = H // nx, W // ny
    pp = torch.nn.functional.pad(phi[None, None], (D, D, D, D),
                                 mode="replicate")[0, 0]
    fp = torch.nn.functional.pad(f[None, None], (D, D, D, D),
                                 mode="replicate")[0, 0]
    out = []
    for ix in range(nx):
        for iy in range(ny):
            rows = slice(ix * h, ix * h + h + 2 * D)
            cols = slice(iy * w, iy * w + w + 2 * D)
            x, fx = pp[rows, cols], fp[rows, cols]
            if x.shape[0] % 2:
                x, fx = torch.cat([x, x[-1:]]), torch.cat([fx, fx[-1:]])
            if x.shape[1] % 2:
                x = torch.cat([x, x[:, -1:]], dim=1)
                fx = torch.cat([fx, fx[:, -1:]], dim=1)
            edges = (ix == 0, ix == nx - 1, iy == 0, iy == ny - 1)
            shard = _cuda.shard_args(*x.shape, D // 4, (ix * h + iy * w) % 2,
                                     (D, D + h, D, D + w), edges)
            out.append((x, fx, shard))
    return out


# 66 x 90 on 2x2 (33 x 45 shards) and 63 x 75 on 3x3 (21 x 25): odd
# shards, so both lattice parities, every edge flag and a centre shard
@pytest.mark.parametrize("channels,dtype", [(0, "f32"), (3, "f64")])
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("grid,shape", [((2, 2), (66, 90)),
                                        ((3, 3), (63, 75))])
def test_twin_is_bitwise_the_shard_canvas_run(grid, shape, k, channels,
                                              dtype):
    phi, f, p = _field(shape, 20 + k, DTYPES[dtype], channels)
    parities = set()
    for x, fx, shard in _canvases(phi, f, *grid, 4 * k):
        want, _ = chunk_shard_reference(x, fx, (fx,), p, k, shard, 8)
        got = twin(x, fx, p, k, (8, 16), shard)
        assert torch.equal(got, want), shard
        parities.add(shard[0])
    assert parities == {0, 1}


@pytest.mark.parametrize("k", [1, 2, 8])
def test_a_halo_of_2k_minus_1_is_not_enough(k):
    phi, f, p = _field((58, 90), 30 + k, np.float64, 0)
    want, _ = iterate(phi, f, p, k)
    assert not torch.equal(twin(phi, f, p, k, (8, 16), halo=2 * k - 1),
                           want)


def test_twin_matches_the_jax_sweep():
    phi, f, p = _field((58, 90), 40, np.float64, 0)
    pj, _ = params()
    x = jnp.asarray(to_np(phi))
    for _ in range(8):
        x = jsweep.redblack_step(x, jnp.asarray(to_np(f)), pj)
    assert_rel(twin(phi, f, p, 8, (16, 32)), np.asarray(x), 1e-10)


def test_kernel_window_is_the_twins():
    for h, w, k in ((58, 90, 1), (2160, 3840, 8), (1144, 1984, 21)):
        for tr0, tc0 in ((0, 0), (40, 60), (h - 8, w - 16), (17, 33)):
            tile = (tr0, min(tr0 + 8, h), tc0, min(tc0 + 16, w))
            assert _cuda.band_window(*tile, h, w, k) == _window(
                *tile, h, w, 2 * k)


# the main path's launches: 4K gray and RGB, and the 2x2 grid's canvas of
# 1080 x 1920 crops at comm_k = 8 (D = 32), gray and RGB
MAIN = [((2160, 3840), None, 0), ((2160, 3840), None, 3),
        ((1144, 1984), (32, 1112, 32, 1952), 0),
        ((1144, 1984), (32, 1112, 32, 1952), 3)]


def _sums(c):
    return (c + 4, 4 * c) if c else (5, 2)


def _windows(h, w, k, crop, th, tw):
    r0, r1, c0, c1 = crop or (0, h, 0, w)
    for tr0 in range(r0, r1, th):
        for tc0 in range(c0, c1, tw):
            yield _cuda.band_window(tr0, min(tr0 + th, r1), tc0,
                                    min(tc0 + tw, c1), h, w, k)


@pytest.mark.parametrize("shape,crop,c", MAIN)
def test_main_path_geometry_fits_two_blocks_an_sm(shape, crop, c):
    nsums, cc_len = _sums(c)
    th, tw, px, py, cap = _cuda.band_geometry(*shape, 8, crop, nsums, cc_len)
    static = _cuda.band_static_bytes(nsums, cc_len)
    assert 8 * cap + static <= _cuda.SMEM_LIMIT + 1024
    assert px * py <= _cuda.BAND_THREADS
    assert _cuda.band_blocks_per_sm(px * py, cap, static) >= 2
    # the windows are at most 2.25x the tiles (the first body's: 2.41x)
    assert cap <= 2.25 * th * tw


@pytest.mark.parametrize("shape,crop", [((2160, 3840), None),
                                        ((1144, 1984), (32, 1112, 32, 1952)),
                                        ((1000, 1500), None),
                                        ((200, 300), None),
                                        ((16, 8), None),
                                        ((90, 140), (10, 80, 10, 130))])
def test_geometry_takes_every_k_the_first_body_takes(shape, crop):
    """Every k up to 21, the most the first body's tiles take on a large
    image, wherever ``tile_geometry`` takes it."""
    h, w = shape
    for k in range(1, 22):
        try:
            _cuda.tile_geometry(h, w, k, span=None if crop is None
                                else 6 * k + 2)
        except ValueError:
            continue
        for c in (0, 3):
            th, tw, px, py, cap = _cuda.band_geometry(h, w, k, crop,
                                                      *_sums(c))
            assert px * py <= _cuda.BAND_THREADS
            for wr0, wr1, wc0, wc1 in _windows(h, w, k, crop, th, tw):
                assert wr1 - wr0 <= py * _cuda.BAND_ROWS
                assert wc1 - wc0 <= 2 * px
                assert (wr1 - wr0) * (wc1 - wc0) <= cap
                assert wc0 % 2 == 0 and (wc1 - wc0) % 2 == 0
