"""The single-sweep body (``csrc/sweep.cuh``: K1 on a whole image, a stack
of frames, a shard canvas and in its force mode with and without a
lattice parity; K4 with C channels) checked on the CPU through a plain
windowed twin of its tiling, and on the card against its first body.

The kernel cuts the image (or a shard canvas's crop) into the tiles of
``_cuda.sweep_geometry`` and sweeps each tile's window, the tile plus 2
cells each way cut at the image (``_cuda.band_window`` at k = 1), once,
then sums each tile's partials and the tiles in order. The twin does the
same with the plain PyTorch sweep (``test_torch_band_tiling.py``'s window
sweep, the depth-2 rim refreshed on a shard canvas) and is held:

- bitwise equal in phi to the plain whole-image run
  (``fused_iteration_reference``, ``fused_sweep_reference`` with a
  parity, ``fused_iteration_batch_reference`` frame by frame,
  ``chunk_shard_reference`` on every shard canvas of 2x2 and 3x3 grids,
  ``fused_iteration_mc_reference``), in f32 and f64, its partials at the
  sums' rounding;
- within 1e-10 in f64 (masks identical) of the JAX package's
  ``fused_iteration``, ``fused_sweep(parity=...)``,
  ``fused_iteration_batch`` and ``fused_iteration_mc`` in interpret mode,
  as the JAX package's own tests run them on the CPU.

``sweep_geometry`` is checked at the main path's shapes (the blocks an SM
and the waves the design claims, windows that fit) and on ragged ones
(every window inside its block). The ``cuda``-marked tests hold each mode
of the kernel bitwise against its first body (the ``_v1`` launchers),
against its plain version and against a launch on a second stream, and
check that a launch whose block count is not its grid's is refused.
"""

import ctypes
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.ops import pallas_sweep, pallas_sweep_mc
from chan_vese_tpu_torch import _build
from chan_vese_tpu_torch.ops import _cuda, fused_kernel, fused_kernel_mc
from chan_vese_tpu_torch.ops.fused_kernel import chunk_shard_reference
from chan_vese_tpu_torch.ops.fused_kernel_mc import data_term_mc
from chan_vese_tpu_torch.ops.numerics import heaviside
from chan_vese_tpu_torch.ops.reductions import data_term
from test_torch_band_tiling import _canvases, _window, sweep_window
from torch_port_helpers import assert_rel, cuda_device, params, to_np, \
    to_torch

DTYPES = {"f32": np.float32, "f64": np.float64}
LAM = dict(lambda1=(1.0, 1.2, 0.8), lambda2=(0.9, 1.0, 1.1))
# the JAX kernels' Heaviside is a Cephes atan, f32-accurate: their s_uH and
# s_H partials are held at 1e-8 in f64 (test_torch_batched.py)
HEAV_RTOL = 1e-8


def sweep_twin(phi, f, chans, p, tile, shard=None, nout=8):
    """(phi_new, partials) of one sweep computed tile by tile as the
    single-sweep body does: ``tile`` = (TH, TW); ``shard``:
    ``_cuda.shard_args``' nine ints (None: the whole image); ``chans`` the
    planes behind the s_uH partials. Each tile's window (the tile plus 2
    each way, an even column start and width) is swept with the plain
    sweep, the tile pasted; each tile's partials are summed in f64, the
    tiles in order, the canvas outside the crop copied through."""
    h, w = phi.shape
    if shard is None:
        parity, crop, edges = 0, (0, h, 0, w), None
    else:
        parity, *crop = shard[:5]
        crop = tuple(crop)
        edges = shard[5:]
        if not any(edges):  # the force mode's parity: no rim
            edges = None
    r0, r1, c0, c1 = crop
    th, tw = tile
    out = phi.clone()
    acc = torch.zeros(len(chans) + 4, dtype=torch.float64)
    for tr0 in range(r0, r1, th):
        for tc0 in range(c0, c1, tw):
            tr1, tc1 = min(tr0 + th, r1), min(tc0 + tw, c1)
            win = _window(tr0, tr1, tc0, tc1, h, w, 2)
            wr0, wr1, wc0, wc1 = win
            cur = sweep_window(phi[wr0:wr1, wc0:wc1], f[wr0:wr1, wc0:wc1],
                               p, 1, parity, win, crop, edges)
            t = (slice(tr0, tr1), slice(tc0, tc1))
            new = cur[tr0 - wr0:tr1 - wr0, tc0 - wc0:tc1 - wc0]
            old = phi[t]
            out[t] = new
            hv = heaviside(new, p.eps)
            d = new - old
            acc += torch.stack(
                [(u[t] * hv).double().sum() for u in chans]
                + [hv.double().sum(), (d * d).double().sum(),
                   ((new >= 0) != (old >= 0)).double().sum(),
                   d.abs().double().sum()])
    parts = torch.cat([acc, torch.zeros(nout - acc.numel(),
                                        dtype=torch.float64)])
    return out, parts.to(phi.dtype)


def _tiles(h, w, crop=None):
    return _cuda.sweep_geometry(h, w, crop)[:2]


def _gray(shape, seed, dtype):
    """phi (structured plus noise), u0 (a noisy disk), and means."""
    rng = np.random.default_rng(seed)
    h, w = shape
    i, j = np.mgrid[0:h, 0:w]
    phi = 8.0 * np.sin(i / 5.0) * np.cos(j / 7.0) + rng.standard_normal(shape)
    u0 = np.where(np.hypot(i - h / 3, j - w / 2) < min(h, w) / 3, 200.0,
                  50.0) + 10.0 * rng.standard_normal(shape)
    return to_torch(phi, dtype), to_torch(u0, dtype), 195.0, 52.0


def _rgb(shape, seed, dtype):
    phi, _, _, _ = _gray(shape, seed, dtype)
    rng = np.random.default_rng(seed + 1)
    h, w = shape
    u = rng.uniform(0, 255, (3, h, w))
    c1 = to_torch(np.array([190.0, 120.0, 60.0]), dtype)
    c2 = to_torch(np.array([45.0, 130.0, 200.0]), dtype)
    return phi, to_torch(u, dtype), c1, c2


def _partials_close(got, want, dtype):
    """The twin sums in f64 per tile, the plain run in the dtype: the flips
    exactly, the other slots at the sums' rounding."""
    rtol = 1e-12 if dtype == np.float64 else 2e-5
    torch.testing.assert_close(got.double(), want.double(), rtol=rtol,
                               atol=1e-9 if dtype == np.float64 else 1e-3)


# the twin against the plain whole-image runs ------------------------------

# 58 x 90 (ragged under the geometry's tiles and 8 x 16) and 96 x 128
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(58, 90), (96, 128)])
@pytest.mark.parametrize("tiling", ["geometry", "8x16"])
def test_twin_is_bitwise_fused_iteration(tiling, shape, dtype):
    phi, u0, c1, c2 = _gray(shape, 1, DTYPES[dtype])
    _, p = params()
    tile = _tiles(*shape) if tiling == "geometry" else (8, 16)
    f = data_term(u0, c1, c2, p.nu, p.lambda1, p.lambda2)
    got, parts = sweep_twin(phi, f, (u0,), p, tile)
    want, wparts = fused_kernel.fused_iteration_reference(phi, u0, c1, c2, p)
    assert torch.equal(got, want)
    assert float(parts[3]) == float(wparts[3])
    _partials_close(parts, wparts, DTYPES[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("parity", [None, 0, 1])
def test_twin_is_bitwise_the_force_mode(parity, dtype):
    """The force mode (u0 is f) and its parity: the whole image the crop,
    no rim, the lattice offset."""
    phi, u0, _, _ = _gray((64, 128), 2, DTYPES[dtype])
    _, p = params()
    f = data_term(u0, 195.0, 52.0, p.nu, p.lambda1, p.lambda2)
    shard = (None if parity is None
             else _cuda.shard_args(64, 128, 1, parity, None, None))
    got, parts = sweep_twin(phi, f, (f,), p, _tiles(64, 128), shard)
    want, wparts = fused_kernel.fused_sweep_reference(phi, f, p, parity)
    assert torch.equal(got, want)
    assert float(parts[3]) == float(wparts[3])
    _partials_close(parts, wparts, DTYPES[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_twin_frames_are_the_batch_run(dtype):
    """Each frame on the batch launch's tiles (the geometry of 3 frames)
    is the plain batch run's frame, partials row by row."""
    frames = [_gray((64, 128), 10 + n, DTYPES[dtype]) for n in range(3)]
    phis = torch.stack([fr[0] for fr in frames])
    u0s = torch.stack([fr[1] for fr in frames])
    c1s = to_torch(np.array([195.0, 180.0, 170.0]), DTYPES[dtype])
    c2s = to_torch(np.array([52.0, 60.0, 48.0]), DTYPES[dtype])
    _, p = params()
    want, wparts = fused_kernel.fused_iteration_batch_reference(
        phis, u0s, c1s, c2s, p)
    tile = _tiles(64, 128)
    for n in range(3):
        f = data_term(u0s[n], c1s[n], c2s[n], p.nu, p.lambda1, p.lambda2)
        got, parts = sweep_twin(phis[n], f, (u0s[n],), p, tile)
        assert torch.equal(got, want[n])
        _partials_close(parts, wparts[n], DTYPES[dtype])


# 66 x 90 on 2x2 (33 x 45 shards) and 63 x 75 on 3x3 (21 x 25): odd
# shards, so both lattice parities, every edge flag and a centre shard
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("grid,shape", [((2, 2), (66, 90)),
                                        ((3, 3), (63, 75))])
def test_twin_is_bitwise_the_shard_canvas_run(grid, shape, dtype):
    phi, u0, c1, c2 = _gray(shape, 3, DTYPES[dtype])
    _, p = params()
    f = data_term(u0, c1, c2, p.nu, p.lambda1, p.lambda2)
    parities = set()
    for x, fx, shard in _canvases(phi, f, *grid, 4):
        crop = tuple(shard[1:5])
        tile = _tiles(*x.shape, crop=crop)
        want, wparts = chunk_shard_reference(x, fx, (fx,), p, 1, shard, 8)
        got, parts = sweep_twin(x, fx, (fx,), p, tile, shard)
        assert torch.equal(got, want), shard
        assert float(parts[3]) == float(wparts[3])
        _partials_close(parts, wparts, DTYPES[dtype])
        # an 8 x 16 tiling of the crop too (its last tiles partial)
        assert torch.equal(sweep_twin(x, fx, (fx,), p, (8, 16), shard)[0],
                           want)
        parities.add(shard[0])
    assert parities == {0, 1}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_twin_is_bitwise_fused_iteration_mc(dtype):
    phi, u, c1, c2 = _rgb((58, 90), 4, DTYPES[dtype])
    _, p = params()
    l1, l2 = p.channel_lambdas(3, LAM["lambda1"], LAM["lambda2"])
    f = data_term_mc(u, c1, c2, p, l1, l2)
    got, parts = sweep_twin(phi, f, tuple(u), p, _tiles(58, 90), nout=7)
    want, wparts = fused_kernel_mc.fused_iteration_mc_reference(
        phi, u, c1, c2, p, **LAM)
    assert torch.equal(got, want)
    assert float(parts[5]) == float(wparts[5])
    _partials_close(parts, wparts, DTYPES[dtype])


# the twin against the JAX package's kernels (interpret mode, f64) ---------

def _jax_close(got, parts, want, wparts, nheav):
    """phi within 1e-10 with identical masks; the first ``nheav`` partial
    slots (the Heaviside sums) at HEAV_RTOL, the rest at 1e-10."""
    want = np.asarray(want)
    assert_rel(got, want, 1e-10)
    assert np.array_equal(to_np(got) >= 0, want >= 0)
    wparts = np.asarray(wparts)
    assert_rel(parts[:nheav], wparts[:nheav], HEAV_RTOL)
    assert_rel(parts[nheav:], wparts[nheav:], 1e-10)


def test_twin_matches_the_jax_fused_iteration():
    phi, u0, _, _ = _gray((96, 128), 5, np.float64)
    pj, p = params()
    c1, c2 = 195.0, 52.0
    want, wparts = pallas_sweep.fused_iteration(
        jnp.asarray(to_np(phi)), jnp.asarray(to_np(u0)), c1, c2, pj,
        interpret=True)
    f = data_term(u0, c1, c2, p.nu, p.lambda1, p.lambda2)
    got, parts = sweep_twin(phi, f, (u0,), p, _tiles(96, 128))
    _jax_close(got, parts, want, wparts, 2)


@pytest.mark.parametrize("parity", [0, 1])
def test_twin_matches_the_jax_fused_sweep_with_parity(parity):
    phi, u0, _, _ = _gray((64, 128), 6, np.float64)
    pj, p = params()
    f = data_term(u0, 195.0, 52.0, p.nu, p.lambda1, p.lambda2)
    want, wparts = pallas_sweep.fused_sweep(
        jnp.asarray(to_np(phi)), jnp.asarray(to_np(f)), pj, parity=parity,
        interpret=True)
    got, parts = sweep_twin(phi, f, (f,), p, _tiles(64, 128),
                            _cuda.shard_args(64, 128, 1, parity, None, None))
    _jax_close(got, parts, want, wparts, 2)


def test_twin_matches_the_jax_fused_iteration_batch():
    frames = [_gray((64, 128), 20 + n, np.float64) for n in range(3)]
    phis = np.stack([to_np(fr[0]) for fr in frames])
    u0s = np.stack([to_np(fr[1]) for fr in frames])
    c1s, c2s = np.array([195.0, 180.0, 170.0]), np.array([52.0, 60.0, 48.0])
    pj, p = params()
    want, wparts = pallas_sweep.fused_iteration_batch(
        *(jnp.asarray(a) for a in (phis, u0s, c1s, c2s)), pj, interpret=True)
    tile = _tiles(64, 128)
    for n in range(3):
        u = to_torch(u0s[n])
        f = data_term(u, c1s[n], c2s[n], p.nu, p.lambda1, p.lambda2)
        got, parts = sweep_twin(to_torch(phis[n]), f, (u,), p, tile)
        _jax_close(got, parts, np.asarray(want)[n], np.asarray(wparts)[n], 2)


def test_twin_matches_the_jax_fused_iteration_mc():
    phi, u, c1, c2 = _rgb((64, 128), 7, np.float64)
    pj, p = params()
    want, wparts = pallas_sweep_mc.fused_iteration_mc(
        jnp.asarray(to_np(phi)), jnp.asarray(to_np(u)),
        jnp.asarray(to_np(c1)), jnp.asarray(to_np(c2)), pj, **LAM,
        interpret=True)
    l1, l2 = p.channel_lambdas(3, LAM["lambda1"], LAM["lambda2"])
    f = data_term_mc(u, c1, c2, p, l1, l2)
    got, parts = sweep_twin(phi, f, tuple(u), p, _tiles(64, 128), nout=7)
    _jax_close(got, parts, want, wparts, 4)


# the geometry ---------------------------------------------------------------

def _windows(h, w, crop, th, tw):
    r0, r1, c0, c1 = crop or (0, h, 0, w)
    for tr0 in range(r0, r1, th):
        for tc0 in range(c0, c1, tw):
            yield _cuda.band_window(tr0, min(tr0 + th, r1), tc0,
                                    min(tc0 + tw, c1), h, w, 1)


def _check_fits(h, w, crop, c):
    """Every window of the tiling inside its block: rows within PY strips,
    columns within PX pairs (an even start and width), cells within cap,
    the window load's slots within the threads; the block within the
    threads and shared memory of the design."""
    th, tw, px, py, cap = _cuda.sweep_geometry(h, w, crop)
    threads = -(-px * py // 32) * 32
    assert px * py <= _cuda.SWEEP_THREADS and cap % 2 == 0
    nsums, cc_len = (c + 4, 4 * c) if c else (5, 2)
    static = _cuda.sweep_static_bytes(nsums, cc_len)
    assert (_cuda.sweep_cell_bytes(c) * cap + static
            <= _cuda.SMEM_LIMIT + 1024)
    for wr0, wr1, wc0, wc1 in _windows(h, w, crop, th, tw):
        assert wr1 - wr0 <= py * _cuda.SWEEP_ROWS
        assert wc1 - wc0 <= 2 * px
        assert (wr1 - wr0) * (wc1 - wc0) <= cap
        assert wc0 % 2 == 0 and (wc1 - wc0) % 2 == 0
        assert (wc1 - wc0) // 4 + 2 <= threads  # sweep_load's slots
    return th, tw, px, py, cap, static


# the main path's launches: (h, w, frames, crop, channels), the blocks an
# SM the design gives each (64 registers a thread: 1024 threads an SM; K4's
# 20 B window cells: three 62 KB blocks) and the waves (blocks over 132 SMs
# of that many) it claims
MAIN = {
    "K1 force 512^2": ((512, 512, 1, None, 0), 4, 0.20),
    "K1 whole 4K": ((2160, 3840, 1, None, 0), 4, 6.06),
    "K1 batch 16 x 1080p": ((1080, 1920, 16, None, 0), 4, 24.24),
    "K1 shard 2x2 crop": ((1088, 1928, 1, (4, 1084, 4, 1924), 0), 4, 1.66),
    "K1 shard 3x3 crop": ((728, 1288, 1, (4, 724, 4, 1284), 0), 4, 0.74),
    "K4 4K RGB": ((2160, 3840, 1, None, 3), 3, 8.08),
}


@pytest.mark.parametrize("name", list(MAIN))
def test_main_path_geometry(name):
    (h, w, frames, crop, c), want_bps, want_waves = MAIN[name]
    th, tw, px, py, cap, static = _check_fits(h, w, crop, c)
    assert -(-px * py // 32) == 8  # 256 threads (248 on a shard canvas)
    bps = _cuda.sweep_blocks_per_sm(px * py, cap, static, c)
    assert bps == want_bps
    _, nblocks = _cuda.sweep_plan(h, w, None if crop is None else
                                  (0, *crop, 0, 0, 0, 0))
    waves = frames * nblocks / (bps * _cuda.SMS)
    assert abs(waves - want_waves) < 0.01, waves
    # the windows 1.16x the tiles, 1.21x on a shard canvas (the first
    # body's at 64 x 128: 1.10x, but 10 B a cell, 2 blocks an SM)
    assert cap <= (1.21 if crop else 1.17) * th * tw


@pytest.mark.parametrize("shape,crop,c", [
    ((58, 90), None, 0), ((96, 128), None, 0), ((16, 8), None, 0),
    ((2, 2), None, 0), ((6, 10), None, 3), ((1000, 1500), None, 3),
    ((1000, 1408), None, 0), ((42, 54), (4, 37, 4, 49), 0),
    ((1144, 1984), (32, 1112, 32, 1952), 0), ((90, 140), (9, 80, 9, 131), 0),
    ((46, 54), (4, 37, 5, 48), 0)])
def test_geometry_fits_every_window(shape, crop, c):
    _check_fits(*shape, crop, c)


def test_kernel_window_is_the_twins():
    for h, w in ((58, 90), (2160, 3840), (1088, 1928)):
        th, tw = _tiles(h, w)
        for tr0, tc0 in ((0, 0), (th, tw), (h - 8, w - 16), (17, 33)):
            tile = (tr0, min(tr0 + th, h), tc0, min(tc0 + tw, w))
            assert _cuda.band_window(*tile, h, w, 1) == _window(*tile, h, w,
                                                                 2)


def test_plan_counts_the_grid():
    """The block count a launch passes is the C launcher's grid: the
    crop's (or image's) tiles, per frame."""
    for h, w, shard in ((2160, 3840, None), (1080, 1920, None),
                        (1000, 1408, None),
                        (1088, 1928, _cuda.shard_args(
                            1088, 1928, 1, 1, (4, 1084, 4, 1924),
                            (1, 0, 1, 0))),
                        (46, 54, _cuda.shard_args(
                            46, 54, 1, 0, (4, 37, 5, 48), (0, 0, 0, 0)))):
        (th, tw, _, _, _), nblocks = _cuda.sweep_plan(h, w, shard)
        r0, r1, c0, c1 = (0, h, 0, w) if shard is None else shard[1:5]
        assert nblocks == math.ceil((r1 - r0) / th) * math.ceil((c1 - c0)
                                                                / tw)


_LAUNCHER = re.compile(r'extern "C" cudaError_t (\w+)\(([^)]*)\)', re.S)


def test_every_sweep_launcher_has_a_signature():
    found = {}
    for src in sorted((Path(_build.__file__).parent / "csrc").glob(
            "fused*.cu")):
        for name, args in _LAUNCHER.findall(src.read_text()):
            found[name] = args
    assert {"cv_fused_iteration", "cv_fused_iteration_batch",
            "cv_fused_iteration_shard", "cv_fused_sweep",
            "cv_fused_sweep_shard", "cv_fused_iteration_mc",
            "cv_sweep_occupancy", "cv_sweep_occupancy_force",
            "cv_sweep_occupancy_mc", "cv_fused_iteration_v1",
            "cv_fused_iteration_batch_v1", "cv_fused_iteration_shard_v1",
            "cv_fused_sweep_v1", "cv_fused_sweep_shard_v1",
            "cv_fused_iteration_mc_v1"} <= set(found)
    for name, args in found.items():
        assert name in _build.SIGNATURES, name
        assert len(args.split(",")) == len(_build.SIGNATURES[name]), name


# on the card: the single-sweep body against its first body -----------------

def _card(dev, shape, seed, rgb=False):
    rng = np.random.default_rng(seed)
    h, w = shape
    phi = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    u = rng.uniform(0, 255, (3, h, w) if rgb else shape).astype(np.float32)
    u = torch.from_numpy(u)
    if rgb:
        c1 = torch.tensor([150.0, 120.0, 100.0])
        c2 = torch.tensor([90.0, 130.0, 160.0])
    else:
        c1, c2 = torch.tensor(160.0), torch.tensor(90.0)
    return phi.to(dev), u.to(dev), c1.to(dev), c2.to(dev)


def _same(got, old, again, flip):
    """phi bitwise the first body's, the flips exactly, the other partials
    within 1e-6 relative (summed in f64 in another order); a second launch
    bitwise the first."""
    torch.cuda.synchronize()
    assert torch.equal(got[0], old[0])
    assert float(got[1][flip]) == float(old[1][flip])
    torch.testing.assert_close(got[1], old[1], rtol=1e-6, atol=0)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 384), (1000, 1408), (512, 512)])
def test_whole_image_and_force_modes_are_bitwise_the_first_body(shape):
    dev = cuda_device()
    phi, u0, c1, c2 = _card(dev, shape, 1)
    _, p = params()
    h, w = shape
    fk = fused_kernel
    n = fk.fused_iteration.launches
    got = fk.fused_iteration(phi, u0, c1, c2, p)
    again = fk.fused_iteration(phi, u0, c1, c2, p)
    assert fk.fused_iteration.launches == n + 2
    old = _cuda.launch_chunk("cv_fused_iteration_v1", phi, u0, c1, c2, p,
                             None, h, w)
    _same(got, old, again, 3)
    f = (u0 - 128.0) * 0.01
    for parity in (None, 1):
        got = fk.fused_sweep(phi, f, p, parity)
        again = fk.fused_sweep(phi, f, p, parity)
        if parity is None:
            old = _cuda.launch_chunk("cv_fused_sweep_v1", phi, f, 0.0, 0.0,
                                     p, None, h, w)
        else:
            old = _cuda.launch_chunk(
                "cv_fused_sweep_shard_v1", phi, f, 0.0, 0.0, p, None, h, w,
                shard=_cuda.shard_args(h, w, 1, parity, None, None))
        _same(got, old, again, 3)
        torch.testing.assert_close(
            got[0], fk.fused_sweep_reference(phi, f, p, parity)[0],
            rtol=1e-5, atol=1e-4)
    ref = fk.fused_iteration_reference(phi, u0, c1, c2, p)
    torch.testing.assert_close(fk.fused_iteration(phi, u0, c1, c2, p)[0],
                               ref[0], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_batch_frames_are_bitwise_their_single_launches_and_the_first_body():
    dev = cuda_device()
    frames = [_card(dev, (256, 384), 10 + i) for i in range(3)]
    phis = torch.stack([fr[0] for fr in frames])
    u0s = torch.stack([fr[1] for fr in frames])
    c1s = torch.stack([fr[2] for fr in frames])
    c2s = torch.stack([fr[3] for fr in frames])
    _, p = params()
    got = fused_kernel.fused_iteration_batch(phis, u0s, c1s, c2s, p)
    again = fused_kernel.fused_iteration_batch(phis, u0s, c1s, c2s, p)
    old = _cuda.launch_chunk_batch("cv_fused_iteration_batch_v1", phis, u0s,
                                   c1s, c2s, p, 256, 384)
    torch.cuda.synchronize()
    for i in range(3):
        _same((got[0][i], got[1][i]), (old[0][i], old[1][i]),
              (again[0][i], again[1][i]), 3)
        one = fused_kernel.fused_iteration(phis[i], u0s[i], c1s[i], c2s[i],
                                           p)
        torch.cuda.synchronize()
        assert torch.equal(one[0], got[0][i])
        assert torch.equal(one[1], got[1][i])


@pytest.mark.cuda
def test_shard_canvases_are_bitwise_the_first_body_and_the_whole_image():
    """Every shard canvas of 2x2 and 3x3 grids (D = 4): phi bitwise the
    first body's, each crop bitwise the whole-image launch's window."""
    dev = cuda_device()
    phi, u0, c1, c2 = _card(dev, (258, 384), 3)
    _, p = params()
    whole = fused_kernel.fused_iteration(phi, u0, c1, c2, p)[0]
    for nx, ny in ((2, 2), (3, 3)):
        h, w = 258 // nx, 384 // ny
        canvases = _canvases(phi.cpu(), u0.cpu(), nx, ny, 4)
        for i, (x, ux, shard) in enumerate(canvases):
            x, ux = x.to(dev).contiguous(), ux.to(dev).contiguous()
            par, r0, r1, c0, c1_, *edges = shard
            args = (x, ux, c1, c2, p, par, (r0, r1, c0, c1_), edges)
            got = fused_kernel.fused_iteration(*args)
            again = fused_kernel.fused_iteration(*args)
            old = _cuda.launch_chunk("cv_fused_iteration_shard_v1", x, ux,
                                     c1, c2, p, None, *x.shape, shard=shard)
            _same(got, old, again, 3)
            ix, iy = divmod(i, ny)
            assert torch.equal(got[0][r0:r1, c0:c1_],
                               whole[ix * h:(ix + 1) * h,
                                     iy * w:(iy + 1) * w])


@pytest.mark.cuda
def test_mc_is_bitwise_the_first_body():
    dev = cuda_device()
    for shape in ((256, 384), (1000, 1408)):
        phi, u, c1, c2 = _card(dev, shape, 4, rgb=True)
        _, p = params()
        got = fused_kernel_mc.fused_iteration_mc(phi, u, c1, c2, p, **LAM)
        again = fused_kernel_mc.fused_iteration_mc(phi, u, c1, c2, p, **LAM)
        l1, l2 = p.channel_lambdas(3, LAM["lambda1"], LAM["lambda2"])
        old = _cuda.launch_chunk_mc("cv_fused_iteration_mc_v1", phi, u, c1,
                                    c2, p, None, *shape, l1, l2, 7)
        _same(got, old, again, 5)
        ref = fused_kernel_mc.fused_iteration_mc_reference(phi, u, c1, c2, p,
                                                           **LAM)
        torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_launches_on_two_streams_agree():
    """Each stream has its own counters: launches queued on a side stream
    and the current one at once give the current stream's results."""
    dev = cuda_device()
    phi, u0, c1, c2 = _card(dev, (512, 512), 5)
    _, p = params()
    want = fused_kernel.fused_iteration(phi, u0, c1, c2, p)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for i in range(8):
        with torch.cuda.stream(side if i % 2 else
                               torch.cuda.current_stream(dev)):
            outs.append(fused_kernel.fused_iteration(phi, u0, c1, c2, p))
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_a_launch_of_another_block_count_is_refused():
    dev = cuda_device()
    phi, u0, c1, c2 = _card(dev, (256, 384), 6)
    _, p = params()
    lib = _build.library()
    (th, tw, px, py, cap), nblocks = _cuda.sweep_plan(256, 384)
    out = torch.empty_like(phi)
    block_parts = torch.empty((nblocks + 1, 5), dtype=torch.float64,
                              device=dev)
    counters = torch.zeros(1, dtype=torch.int32, device=dev)
    parts = torch.empty(8, device=dev)
    cc = torch.tensor([160.0, 90.0], device=dev)
    err = lib.cv_fused_iteration(
        phi.data_ptr(), u0.data_ptr(), cc.data_ptr(), out.data_ptr(),
        block_parts.data_ptr(), counters.data_ptr(), parts.data_ptr(), 256,
        384, th, tw, px, py, cap, nblocks + 1, p.mu, p.nu, p.lambda1,
        p.lambda2, *_cuda._common_params(p),
        torch.cuda.current_stream(dev).cuda_stream)
    assert err == 1  # cudaErrorInvalidValue
    n = ctypes.c_int(0)
    assert lib.cv_sweep_occupancy(0, px * py, 12 * cap, ctypes.byref(n)) == 0
    assert n.value >= 1
