"""Launch path shared by the red-black kernels (K1-K3 on a scalar image,
K1 on a stack of frames, K4-K6 on a C-channel image; K1 and K4 on the
single-sweep body of csrc/sweep.cuh, K2, K3, K5 and K6 on the banded body
of csrc/band.cuh, the first bodies, `_v1`, on csrc/redblack.cuh), the
exact-means resident kernels (K7 flat, K8 parity planes; scalar, batch and
C-channel modes) and their frozen-means chunk mode (K13), the 4-phase
kernels (K9 banded and resident, K10 parity planes), the morphological
kernels (K11, K12), the parity pack and unpack (K15, K16) and the
redistance (R1).

Checks the inputs, chooses the tile geometry (the resident kernels: the
cooperative grid of persistent tiles), allocates the outputs and scratch, and calls the kernel
library (``_build.library()``) on PyTorch's current stream. Nothing here
synchronizes with the device. A refused launch raises.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch

from .. import spans

# output tiles (rows, cols), largest first; 512 threads per block
TILES = ((64, 128), (32, 128), (32, 64), (16, 64), (16, 32))
# H100 shared memory per block (232,448 B) less room for the static part
SMEM_LIMIT = 232448 - 1024
# channel counts the multichannel kernels are compiled for
MAX_CHANNELS = 8
# frames of one batch launch: the grid's z limit
MAX_FRAMES = 65535


def tile_geometry(h: int, w: int, k: int, cell_bytes: int = 10,
                  span=None):
    """(TH, TW, cap) for k iterations per launch: the largest tile whose
    window (tile + ``span`` rows/cols of halo, 6k by default, clipped to the
    image) fits in shared memory at ``cell_bytes`` per window cell (10 for
    the red-black kernels: phi, f, half a buffer)."""
    span = 6 * k if span is None else span
    for th, tw in TILES:
        cap = min(h, th + span) * min(w, tw + span)
        if cell_bytes * cap <= SMEM_LIMIT:
            return th, tw, cap
    raise ValueError(f"k={k} needs more shared memory than a block has "
                     f"(window of the smallest tile exceeds {SMEM_LIMIT} B)")


# csrc/band.cuh (K2, K3, K5, K6): rows of a thread's strip, most threads a
# block, and the SM resources its tiles are chosen against: registers (64 a
# thread under __launch_bounds__(512, 2)), warps, shared memory (the SM's
# 228 KB, 1 KB of it reserved a block) and the H100 SXM's SM count
BAND_ROWS, BAND_THREADS = 12, 512
BAND_REGS, SM_REGS, SM_WARPS, SM_SMEM = 64, 65536, 64, 233472
SMS = 132
# tile candidates (rows, cols) of the band geometry
BAND_TILE_ROWS = tuple(range(8, 257, 8))
BAND_TILE_COLS = tuple(range(16, 513, 16))


def band_window(tr0, tr1, tc0, tc1, h, w, k):
    """Window [wr0, wr1) x [wc0, wc1) of the band body's tile [tr0, tr1) x
    [tc0, tc1) on an (h, w) image or canvas for k iterations: the tile plus
    2k each way, cut at the image, the columns widened to an even start and
    width (csrc/band.cuh band_kernel)."""
    wr0, wr1 = max(tr0 - 2 * k, 0), min(tr1 + 2 * k, h)
    wc0, wc1 = max(tc0 - 2 * k, 0) & ~1, min(tc1 + 2 * k, w)
    return wr0, wr1, wc0, wc1 + ((wc1 - wc0) & 1)


def plane_offset(i, j, h: int, w: int):
    """Offset of element (i, j) of an (h, w) image stored as parity planes
    (2, 2, h/2, w/2), plane (i & 1, j & 1) at row i >> 1, column j >> 1:
    the band body's packed address (csrc/redblack.cuh gaddr<true>). ``i``
    and ``j`` may be ints or integer tensors."""
    hp, wp = h // 2, w // 2
    return (((i & 1) * 2 + (j & 1)) * hp + (i >> 1)) * wp + (j >> 1)


def band_static_bytes(nsums: int, cc_len: int) -> int:
    """Static shared memory of band_kernel: the f64 reduction scratch and
    the means."""
    return 8 * nsums * (BAND_THREADS // 32) + 4 * cc_len


def band_blocks_per_sm(threads: int, cap: int, static: int) -> int:
    """Blocks of the band body an SM holds at ``threads`` threads and
    ``cap`` window cells (8 B each), by registers, warps and shared
    memory (the design's count; the card's own is
    :func:`band_occupancy`)."""
    warps = -(-threads // 32)
    return min(SM_REGS // (BAND_REGS * 32 * warps), SM_WARPS // warps,
               SM_SMEM // (8 * cap + static + 1024), 32)


@functools.lru_cache(maxsize=256)
def band_geometry(h: int, w: int, k: int, crop=None, nsums: int = 5,
                  cc_len: int = 2, sms: int = SMS):
    """(TH, TW, PX, PY, cap) of a band-body launch (K2, K5) on an (h, w)
    image, or on a canvas whose ``crop`` = (r0, r1, c0, c1) the tiles
    cover: TH x TW tiles, PX x PY threads (PX pairs across, PY strips of
    BAND_ROWS rows down, enough for the largest window), windows of at
    most ``cap`` cells. Among the tiles whose window fits a block, those
    that let an SM hold two blocks are taken where any does, and of them
    the one whose busiest SM (the blocks spread evenly over ``sms`` SMs)
    updates the fewest window cells, the larger tile on a tie."""
    shard = crop is not None
    th_all, tw_all = (h, w) if not shard else (crop[1] - crop[0],
                                               crop[3] - crop[2])
    static = band_static_bytes(nsums, cc_len)
    best = []
    for th in BAND_TILE_ROWS:
        for tw in BAND_TILE_COLS:
            wh = min(h, th + 4 * k)
            ww = min(w, tw + 4 * k + (2 if shard else 0))
            px, py = -(-ww // 2), -(-wh // BAND_ROWS)
            cap = wh * ww
            if px * py > BAND_THREADS or 8 * cap + static > SMEM_LIMIT + 1024:
                continue
            bps = band_blocks_per_sm(px * py, cap, static)
            nblocks = -(-th_all // th) * -(-tw_all // tw)
            load = -(-nblocks // sms) * cap
            best.append((bps < 2, load, -th * tw, (th, tw, px, py, cap)))
    if not best:
        raise ValueError(f"k={k} needs a larger window than a block of the "
                         f"band body holds ({BAND_THREADS} threads, "
                         f"{SMEM_LIMIT} B)")
    return min(best)[-1]


# csrc/sweep.cuh (K1, K4): rows of a thread's strip, most threads a block
# (__launch_bounds__ for SWEEP_MIN_BLOCKS of them an SM: 64 registers a
# thread)
SWEEP_ROWS, SWEEP_THREADS, SWEEP_MIN_BLOCKS = 6, 256, 4
SWEEP_REGS = SM_REGS // (SWEEP_THREADS * SWEEP_MIN_BLOCKS)
# the tile: 44 x 60 cells, a 48 x 64 window of 8 strips of SWEEP_ROWS rows
# by 32 column pairs, 256 threads (56 columns on a shard canvas, whose
# windows are two columns wider): the fastest of the tilings tried on an
# H100 at 4K, 16 x 1080p and 4K RGB (PERF.md §6)
SWEEP_TILE = (44, 60)


def sweep_cell_bytes(c: int) -> int:
    """Shared memory a window cell of the single-sweep body: phi, the old
    value and u0 (f in the force mode, C planes for K4)."""
    return 8 + 4 * max(c, 1)


def sweep_static_bytes(nsums: int, cc_len: int) -> int:
    """Static shared memory of sweep_kernel: the f64 reduction scratch, the
    means and the last-block flag."""
    return 8 * nsums * (BAND_THREADS // 32) + 4 * cc_len + 16


def sweep_blocks_per_sm(threads: int, cap: int, static: int, c: int) -> int:
    """Blocks of the single-sweep body an SM holds at ``threads`` threads
    and ``cap`` window cells, by registers, warps and shared memory (the
    design's count; the card's own is :func:`sweep_occupancy`)."""
    warps = -(-threads // 32)
    return min(SM_REGS // (SWEEP_REGS * 32 * warps), SM_WARPS // warps,
               SM_SMEM // (sweep_cell_bytes(c) * cap + static + 1024), 32)


@functools.lru_cache(maxsize=256)
def sweep_geometry(h: int, w: int, crop=None):
    """(TH, TW, PX, PY, cap) of a single-sweep launch (K1 in every mode, K4)
    on an (h, w) image, or on a canvas whose ``crop`` = (r0, r1, c0, c1)
    the tiles cover: SWEEP_TILE cut to the tiled region, PX x PY threads
    (PX pairs across, PY strips of SWEEP_ROWS rows down) for its largest
    window, the tile plus 2 each way (two columns more on a shard canvas
    for the even start and width), windows of at most ``cap`` cells."""
    shard = crop is not None
    th_all, tw_all = (h, w) if not shard else (crop[1] - crop[0],
                                               crop[3] - crop[2])
    th = min(SWEEP_TILE[0], th_all)
    tw = min(SWEEP_TILE[1] - (4 if shard else 0), tw_all + (tw_all & 1))
    wh = min(h, th + 4)
    ww = min(w, tw + 4 + (2 if shard else 0))
    return th, tw, -(-ww // 2), -(-wh // SWEEP_ROWS), wh * ww


def sweep_plan(h: int, w: int, shard=None):
    """((TH, TW, PX, PY, cap), blocks a frame) of a single-sweep launch;
    ``shard``: :func:`shard_args`' nine ints of a shard-canvas launch."""
    crop = None if shard is None else tuple(shard[1:5])
    geo = sweep_geometry(h, w, crop)
    th_all, tw_all = (h, w) if crop is None else (crop[1] - crop[0],
                                                  crop[3] - crop[2])
    return geo, math.ceil(th_all / geo[0]) * math.ceil(tw_all / geo[1])


def sweep_occupancy(c: int, shard: bool, threads: int, cap: int,
                    force: bool = False) -> int:
    """The card's blocks per SM of the single-sweep body (C channels, 0:
    K1; ``force``: its force mode) at ``threads`` threads and ``cap`` window
    cells (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes

    from .._build import library

    lib = library()
    n = ctypes.c_int(0)
    smem = sweep_cell_bytes(c) * cap
    if c:
        if shard:
            raise ValueError("K4 has no shard-canvas mode")
        err = lib.cv_sweep_occupancy_mc(c, threads, smem, ctypes.byref(n))
    elif force:
        err = lib.cv_sweep_occupancy_force(int(shard), threads, smem,
                                           ctypes.byref(n))
    else:
        err = lib.cv_sweep_occupancy(int(shard), threads, smem,
                                     ctypes.byref(n))
    if err:
        raise RuntimeError(f"sweep occupancy query failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return n.value


# one counter word a frame for the single-sweep body's last-block sum, a
# buffer per (device, stream): launches on one stream never run at once,
# and each launch leaves its counters at 0
_SWEEP_COUNTERS = {}


def _sweep_counters(dev, stream, n: int):
    key = (dev.index, stream.cuda_stream)
    buf = _SWEEP_COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _SWEEP_COUNTERS[key] = buf
    return buf


def _aligned16(t):
    """t, or a fresh copy where its data does not start on a 16-byte
    boundary (the window load's vectors need one)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_sweep(symbol: str, phi, u0, cc, params, c: int = 0,
                 frames=None, shard=None):
    """One launch of the single-sweep body (csrc/sweep.cuh): ``symbol``
    on phi (H, W), or (N, H, W) frames with ``frames`` = N, and u0 of
    phi's shape (f in the force mode) or channels-first (C, H, W) with
    ``c`` = C (K4); ``cc`` the means on the device, ``params`` the
    launcher's floats; ``shard``: :func:`shard_args`' nine ints. Returns
    (phi_new, partials: (8,), (N, 8) with frames, (C + 4,) for K4)."""
    from .._build import library

    h, w = phi.shape[-2:]
    check_even(h, w)
    dev = phi.device
    n = frames or 1
    if not 1 <= n <= MAX_FRAMES:
        raise ValueError(f"{n} frames; a launch takes 1 to {MAX_FRAMES}")
    (th, tw, px, py, cap), nblocks = sweep_plan(h, w, shard)
    phi, u0 = _aligned16(phi), _aligned16(u0)
    nsums, nout = (c + 4, c + 4) if c else (5, 8)
    out = torch.empty_like(phi)
    block_parts = torch.empty((n * nblocks, nsums), dtype=torch.float64,
                              device=dev)
    parts = torch.empty(nout if frames is None else (frames, nout),
                        dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)
    counters = _sweep_counters(dev, stream, n)
    extra = (frames,) if frames is not None else (c,) if c else ()
    lib = library()
    with torch.cuda.device(dev):
        err = getattr(lib, symbol)(
            phi.data_ptr(), u0.data_ptr(), cc.data_ptr(), out.data_ptr(),
            block_parts.data_ptr(), counters.data_ptr(), parts.data_ptr(), h,
            w, *extra, th, tw, px, py, cap, nblocks, *params, *(shard or ()),
            stream.cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return out, parts


def launch_fused(symbol: str, phi, u0, c1, c2, p, shard=None):
    """K1 (``cv_fused_iteration``, ``_shard``) or its force mode
    (``cv_fused_sweep``, ``_shard``; u0 is f, the means unused) on sweep.cuh.
    Returns (phi_new, partials (8,))."""
    _check_inputs(phi, u0)
    if u0.shape != phi.shape or phi.ndim != 2:
        raise ValueError(f"u0 {tuple(u0.shape)} vs phi {tuple(phi.shape)}: "
                         f"expected one (H, W) shape")
    params = (p.mu, p.nu, p.lambda1, p.lambda2, *_common_params(p))
    return launch_sweep(symbol, phi, u0, _means(c1, c2, phi.device), params,
                        shard=shard)


def launch_fused_batch(phis, u0s, c1s, c2s, p):
    """K1's batch mode on sweep.cuh: each frame of (N, H, W) stacks with
    per-frame means c1s, c2s (N,). Returns (phis_new, partials (N, 8))."""
    _check_inputs(phis, u0s)
    if u0s.shape != phis.shape or phis.ndim != 3:
        raise ValueError(f"u0 {tuple(u0s.shape)} vs phi {tuple(phis.shape)}: "
                         f"expected one (N, H, W) shape")
    n, dev = phis.shape[0], phis.device
    cc = torch.stack([torch.as_tensor(c, device=dev).reshape(n)
                      for c in (c1s, c2s)], dim=1).to(torch.float32)
    params = (p.mu, p.nu, p.lambda1, p.lambda2, *_common_params(p))
    return launch_sweep("cv_fused_iteration_batch", phis, u0s,
                        cc.contiguous(), params, frames=n)


def launch_fused_mc(phi, u0, c1, c2, p, l1, l2):
    """K4 on sweep.cuh: u0 channels-first (C, H, W), (C,) means, the
    per-channel lambda tuples. Returns (phi_new, partials (C + 4,))."""
    c = mc_channels(phi, u0)
    _check_inputs(phi, u0)
    if phi.ndim != 2:
        raise ValueError(f"phi must be (H, W), got {tuple(phi.shape)}")
    cc = _mc_means(c1, c2, l1, l2, c, phi.device)
    return launch_sweep("cv_fused_iteration_mc", phi, u0, cc,
                        (p.mu, p.nu, *_common_params(p)), c=c)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def band_occupancy(c: int, shard: bool, threads: int, cap: int,
                   packed: bool = False) -> int:
    """The card's blocks per SM of the band body (C channels, 0: K2; on
    parity planes with ``packed``: K3, K6) at ``threads`` threads and
    ``cap`` window cells (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).
    """
    import ctypes

    from .._build import library

    lib = library()
    n = ctypes.c_int(0)
    if packed and c:
        if shard:
            raise ValueError("K6 has no shard-canvas mode")
        err = lib.cv_packed_band_occupancy_mc(c, threads, 8 * cap,
                                              ctypes.byref(n))
    elif packed:
        err = lib.cv_packed_band_occupancy(int(shard), threads, 8 * cap,
                                           ctypes.byref(n))
    elif c:
        err = lib.cv_band_occupancy_mc(c, int(shard), threads, 8 * cap,
                                       ctypes.byref(n))
    else:
        err = lib.cv_band_occupancy(int(shard), threads, 8 * cap,
                                    ctypes.byref(n))
    if err:
        raise RuntimeError(f"band occupancy query failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return n.value


def mc_channels(phi, u0) -> int:
    """Channel count C of a channels-first u0 that matches phi: (C, H, W)
    for an (H, W) phi, (C, 2, 2, H/2, W/2) for parity planes; 1 <= C <= 8.
    """
    if u0.ndim != phi.ndim + 1 or tuple(u0.shape[1:]) != tuple(phi.shape):
        raise ValueError(f"u0 {tuple(u0.shape)} must be (C, *phi.shape) "
                         f"with phi {tuple(phi.shape)}")
    c = u0.shape[0]
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"{c} channels; the kernels take 1 to "
                         f"{MAX_CHANNELS}")
    return c


def _check_inputs(phi, u0, names=("phi", "u0")):
    if phi.device.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {phi.device}")
    for name, t in zip(names, (phi, u0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != phi.device:
            raise ValueError(f"{name} is on {t.device}, {names[0]} on "
                             f"{phi.device}")


def _common_params(p):
    return (p.eta2, p.dt * p.eps / math.pi, p.eps, p.eps * p.eps,
            1.0 / math.pi)


def _flag(v) -> int:
    return int(bool(v.item() if hasattr(v, "item") else v))


def shard_args(h: int, w: int, k: int, parity, crop, edges):
    """The nine ints of a shard-canvas launch on an (h, w) canvas for k
    iterations: (parity, r0, r1, c0, c1, top, bottom, left, right).

    ``crop`` = (r0, r1, c0, c1), the shard's own window (None: the whole
    canvas, and no rim); ``edges`` = the [top, bottom, left, right]
    global-edge flags (any truthy values, a tensor included: a CUDA one is
    read back; None: none). The canvas must hold the chunk's reach around
    the crop, 4k rows/cols up/left and 2k down/right, except on a flagged
    side, where two replica rows or columns suffice. Raises otherwise."""
    parity = int(parity.item() if hasattr(parity, "item") else parity) % 2
    if crop is None:  # the whole canvas, no rim: the whole-image sweep
        return parity, 0, h, 0, w, 0, 0, 0, 0
    r0, r1, c0, c1 = (int(v) for v in crop)
    top, bottom, left, right = (_flag(v) for v in
                                (edges if edges is not None else (0,) * 4))
    if not (0 <= r0 < r1 <= h and 0 <= c0 < c1 <= w):
        raise ValueError(f"crop {crop} is not a window of the {(h, w)} "
                         f"canvas")
    need = (2 if top else 4 * k, 2 if bottom else 2 * k,
            2 if left else 4 * k, 2 if right else 2 * k)
    have = (r0, h - r1, c0, w - c1)
    if any(a < b for a, b in zip(have, need)):
        raise ValueError(f"crop {crop} of the {(h, w)} canvas leaves "
                         f"{have} rows/cols (top, bottom, left, right) "
                         f"around it; k={k} with edges {edges} needs {need}")
    return parity, r0, r1, c0, c1, top, bottom, left, right


@functools.lru_cache(maxsize=64)
def _constant_means(c1: float, c2: float, device):
    """[c1, c2] as f32 on ``device`` for means given as numbers (K1's force
    mode passes 0, 0). Cached: a host-to-device copy per launch would wait
    for the stream."""
    return torch.tensor([c1, c2], dtype=torch.float32, device=device)


def _means(c1, c2, dev):
    """The [c1, c2] cc of a scalar launch, without a host-to-device copy
    where the means are numbers or already on ``dev``."""
    if not (isinstance(c1, torch.Tensor) or isinstance(c2, torch.Tensor)):
        return _constant_means(float(c1), float(c2), dev)
    return torch.stack([torch.as_tensor(c1, device=dev),
                        torch.as_tensor(c2, device=dev)]).to(torch.float32)


def launch_chunk(symbol: str, phi, u0, c1, c2, p, k, h: int, w: int,
                 shard=None):
    """Run scalar kernel ``symbol`` on image geometry (h, w); phi/u0 hold
    it flat or as parity planes. ``shard``: the :func:`shard_args` of a
    shard-canvas launch. Returns (phi_new, partials (8,) f32)."""
    _check_inputs(phi, u0)
    if u0.shape != phi.shape:
        raise ValueError(f"u0 {tuple(u0.shape)} vs phi {tuple(phi.shape)}")
    cc = _means(c1, c2, phi.device)
    params = (p.mu, p.nu, p.lambda1, p.lambda2, *_common_params(p))
    return _launch(symbol, phi, u0, cc, (), k, h, w, 5, 8, params,
                   shard=shard)


def _mc_means(c1, c2, l1, l2, c, dev):
    """The [c1 x C, c2 x C, l1/C x C, l2/C x C] cc of a multichannel
    launch."""
    return torch.cat([
        torch.as_tensor(c1, device=dev).reshape(c).to(torch.float32),
        torch.as_tensor(c2, device=dev).reshape(c).to(torch.float32),
        _weights(tuple(l1), tuple(l2), dev)])


def band_plan(phi, u0, k: int, shard=None, c: int = 0, sms: int = SMS):
    """(symbol, h, w, (TH, TW, PX, PY, cap), blocks) of a band-body launch
    on ``phi``: an (h, w) image (K2, K5 with ``c`` channels) or its parity
    planes (2, 2, h/2, w/2) (K3, K6), whose launch takes the flat one's
    geometry; ``shard``: the :func:`shard_args` of a shard-canvas launch
    (K2, K3, K5). Checks the shapes, not the device."""
    packed = phi.ndim == 4
    if packed:
        if tuple(phi.shape[:2]) != (2, 2):
            raise ValueError(f"expected (2, 2, H/2, W/2) planes, got "
                             f"{tuple(phi.shape)}")
        if c and shard is not None:
            raise ValueError("K6 has no shard-canvas mode")
        h, w = 2 * phi.shape[2], 2 * phi.shape[3]
    elif phi.ndim == 2:
        h, w = phi.shape
    else:
        raise ValueError(f"phi must be (H, W) or (2, 2, H/2, W/2) planes, "
                         f"got {tuple(phi.shape)}")
    if not c and u0.shape != phi.shape:
        raise ValueError(f"u0 {tuple(u0.shape)} vs phi {tuple(phi.shape)}")
    check_even(h, w)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    nsums, cc_len = (c + 4, 4 * c) if c else (5, 2)
    crop = None if shard is None else tuple(shard[1:5])
    geo = band_geometry(h, w, k, crop, nsums, cc_len, sms)
    th_all, tw_all = (h, w) if crop is None else (crop[1] - crop[0],
                                                  crop[3] - crop[2])
    blocks = math.ceil(th_all / geo[0]) * math.ceil(tw_all / geo[1])
    symbol = (("cv_packed_banded_chunk" if packed else "cv_banded_chunk")
              + ("_mc" if c else "") + ("" if shard is None else "_shard"))
    return symbol, h, w, geo, blocks


def launch_band(phi, u0, c1, c2, p, k: int, shard=None, l1=None, l2=None):
    """One launch of the band body (csrc/band.cuh): K2 on an (h, w) phi and
    u0, or K5 with a channels-first (C, h, w) u0, (C,) means and the
    per-channel lambda tuples ``l1``, ``l2``; K3 and K6 the same on parity
    planes (phi (2, 2, h/2, w/2), u0 of phi's shape or (C, *phi.shape)).
    ``shard``: the :func:`shard_args` of a shard-canvas launch (K2, K3,
    K5). Returns (phi_new, partials: (8,) for K2/K3, (16,) for K5/K6)."""
    from .._build import library

    c = 0 if l1 is None else mc_channels(phi, u0)
    _check_inputs(phi, u0)
    dev = phi.device
    symbol, h, w, (th, tw, px, py, cap), nblocks = band_plan(
        phi, u0, k, shard, c, _sm_count(dev.index))
    if phi.ndim == 2 and (phi.data_ptr() % 8 or u0.data_ptr() % 8):
        raise ValueError("the band body reads 8-byte pairs: phi and u0 must "
                         "start on an 8-byte boundary")
    nsums, nout = (c + 4, 16) if c else (5, 8)
    out = torch.empty_like(phi)
    block_parts = torch.empty((nblocks, nsums), dtype=torch.float64,
                              device=dev)
    parts = torch.empty(nout, dtype=torch.float32, device=dev)
    if c:
        cc = _mc_means(c1, c2, l1, l2, c, dev)
        params = (p.mu, p.nu, *_common_params(p))
    else:
        cc = _means(c1, c2, dev)
        params = (p.mu, p.nu, p.lambda1, p.lambda2, *_common_params(p))
    lib = library()
    with torch.cuda.device(dev):
        err = getattr(lib, symbol)(
            phi.data_ptr(), u0.data_ptr(), cc.data_ptr(), out.data_ptr(),
            block_parts.data_ptr(), parts.data_ptr(), h, w, *((c,) if c
                                                             else ()),
            k, th, tw, px, py, cap, *params, *(shard or ()),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return out, parts


@functools.lru_cache(maxsize=64)
def _weights(l1, l2, device):
    """[l1[c] / C..., l2[c] / C...] as f32 on ``device`` (the reference
    kernels' per-channel weights, divided in double). Cached: a fresh
    host-to-device copy per launch would wait for the stream."""
    c = len(l1)
    return torch.tensor([v / c for v in l1] + [v / c for v in l2],
                        dtype=torch.float32, device=device)


def launch_chunk_mc(symbol: str, phi, u0, c1, c2, p, k, h: int, w: int,
                    l1, l2, nout: int, shard=None):
    """Run multichannel kernel ``symbol``: u0 is channels-first
    (C, *phi.shape); c1, c2 are (C,) means; l1, l2 the per-channel lambda
    tuples; ``shard`` as :func:`launch_chunk`. Returns (phi_new, partials
    (nout,) f32)."""
    c = mc_channels(phi, u0)
    _check_inputs(phi, u0)
    cc = _mc_means(c1, c2, l1, l2, c, phi.device)
    params = (p.mu, p.nu, *_common_params(p))
    return _launch(symbol, phi, u0, cc, (c,), k, h, w, c + 4, nout, params,
                   shard=shard)


def launch_chunk_batch(symbol: str, phis, u0s, c1s, c2s, p, h: int, w: int):
    """Run scalar kernel ``symbol`` on each frame of (N, h, w) stacks with
    per-frame means c1s, c2s (N,). Returns (phis_new, partials (N, 8))."""
    _check_inputs(phis, u0s)
    if u0s.shape != phis.shape:
        raise ValueError(f"u0 {tuple(u0s.shape)} vs phi {tuple(phis.shape)}")
    n = phis.shape[0]
    if not 1 <= n <= MAX_FRAMES:
        raise ValueError(f"{n} frames; a batch launch takes 1 to "
                         f"{MAX_FRAMES}")
    dev = phis.device
    cc = torch.stack([torch.as_tensor(c, device=dev).reshape(n)
                      for c in (c1s, c2s)], dim=1).to(torch.float32)
    params = (p.mu, p.nu, p.lambda1, p.lambda2, *_common_params(p))
    return _launch(symbol, phis, u0s, cc.contiguous(), (n,), None, h, w, 5,
                   8, params, frames=n)


def check_even(h: int, w: int):
    if h % 2 or w % 2:
        raise ValueError(f"the kernels need even H and W, got {(h, w)}")


def crop_tiles(n: int, lo: int, hi: int, t: int) -> int:
    """Tiles of t cells along an axis of n cells cut at lo and hi (the
    whole-canvas tiling of K9's first body's shard mode, csrc/mp2_band.cu
    crop_tiles)."""
    return math.ceil(lo / t) + math.ceil((hi - lo) / t) + math.ceil((n - hi)
                                                                     / t)


def _launch(symbol, phi, u0, cc, chan, k, h, w, nsums, nout, params,
            reach=None, cell_bytes=10, frames=None, shard=None,
            canvas_tiles=False):
    """``reach``: the iterations whose halo the tiles carry (default k, or
    1 for the fused kernels, which take no k). ``frames``: phi and u0 hold
    that many images and the partials are (frames, nout). ``shard``: the
    nine ints of a shard-canvas launch, whose tiles cover the crop (the
    whole canvas, cut at the crop, with ``canvas_tiles``) and whose
    windows are two cells wider (an even start and width)."""
    from .._build import library

    check_even(h, w)
    if k is not None and k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    reach = reach or k or 1
    th, tw, cap = tile_geometry(
        h, w, reach, cell_bytes, span=None if shard is None else 6 * reach + 2)
    dev = phi.device
    out = torch.empty_like(phi)
    if canvas_tiles:
        nblocks = (crop_tiles(h, shard[1], shard[2], th)
                   * crop_tiles(w, shard[3], shard[4], tw))
    else:
        th_all, tw_all = (h, w) if shard is None else (shard[2] - shard[1],
                                                       shard[4] - shard[3])
        nblocks = math.ceil(th_all / th) * math.ceil(tw_all / tw)
    block_parts = torch.empty(((frames or 1) * nblocks, nsums),
                              dtype=torch.float64, device=dev)
    parts = torch.empty(nout if frames is None else (frames, nout),
                        dtype=torch.float32, device=dev)
    ptrs = (phi.data_ptr(), u0.data_ptr(), cc.data_ptr(), out.data_ptr(),
            block_parts.data_ptr(), parts.data_ptr())
    ks = () if k is None else (k,)
    lib = library()
    err = getattr(lib, symbol)(*ptrs, h, w, *chan, *ks, th, tw, cap, *params,
                               *(shard or ()),
                               torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return out, parts


# the first banded 4-phase body (csrc/mp2_band.cu mp2_band_kernel, the
# `_v1` launchers): shared-memory bytes per window cell (kMp2CellBytes:
# phi0, phi1, u0, f and half a buffer); its window carries the halo of two
# red-black iterations
MP2_CELL_BYTES = 18
MP2_REACH = 2
# the band body of K9 (csrc/mp2_band.cu mp2_coupled_kernel): the coupled
# iteration's halo (kMp2Halo), rows of a thread's strip (kMp2Rows),
# shared-memory bytes per window cell (phi0, phi1, u0 and the aux plane),
# its ten live partial slots
MP2_HALO, MP2_ROWS, MP2_BAND_CELL_BYTES, MP2_SUMS = 2, 6, 16, 10


def mp2_axis_tiles(n: int, lo: int, hi: int, t: int, fold: int):
    """[(t0, t1), ...]: the band body's tiles along an axis of n cells cut
    at lo and hi (a shard canvas's crop; 0 and n on a whole image), the
    mirror of csrc/mp2_band.cu Mp2Axis: tiles of t cells counted back from
    lo, forward from lo to hi and from hi to n; with ``fold`` the outermost
    tile of [0, lo) and of [hi, n), where partial, joins its inner
    neighbour; the first starts at 0, the last ends at n."""
    def outer(length):
        m = -(-length // t)
        return m - 1 if fold and length % t else m

    na, nb, nc = outer(lo), -(-(hi - lo) // t), outer(n - hi)
    tiles = ([(lo - (na - b) * t, lo - (na - 1 - b) * t) for b in range(na)]
             + [(lo + b * t, min(lo + (b + 1) * t, hi)) for b in range(nb)]
             + [(hi + b * t, hi + (b + 1) * t) for b in range(nc)])
    tiles[0] = (0, tiles[0][1])
    tiles[-1] = (tiles[-1][0], n)
    return tiles


def mp2_window(t0: int, t1: int, n: int, lo: int, hi: int,
               even: bool = False):
    """Window [w0, w1) of the band body's tile [t0, t1) along an axis of n
    cells with the crop [lo, hi): MP2_HALO each way, cut at the axis, one
    cell more into the crop where the tile ends at lo or starts at hi;
    ``even`` (the columns) widens it to an even start and width."""
    w0 = max(t0 - MP2_HALO - (t0 == hi), 0)
    w1 = min(t1 + MP2_HALO + (t1 == lo), n)
    if even:
        w0 &= ~1
        w1 += (w1 - w0) & 1
    return w0, w1


def mp2_static_bytes() -> int:
    """Static shared memory of the band body: the f64 reduction scratch
    and the four means."""
    return 8 * MP2_SUMS * (BAND_THREADS // 32) + 16


def mp2_blocks_per_sm(threads: int, cap: int) -> int:
    """Blocks of K9's band body an SM holds at ``threads`` threads and
    ``cap`` window cells, by registers, warps and shared memory (the
    design's count; the card's own is :func:`mp2_occupancy`)."""
    warps = -(-threads // 32)
    return min(SM_REGS // (BAND_REGS * 32 * warps), SM_WARPS // warps,
               SM_SMEM // (MP2_BAND_CELL_BYTES * cap + mp2_static_bytes()
                           + 1024), 32)


@functools.lru_cache(maxsize=None)
def _mp2_axis(n, lo, hi, t, fold, even):
    """(tile count, largest window) of one axis of the band body."""
    tiles = mp2_axis_tiles(n, lo, hi, t, fold)
    return len(tiles), max(b - a for a, b in (mp2_window(*x, n, lo, hi, even)
                                              for x in tiles))


def mp2_tiling(h: int, w: int, crop, th: int, tw: int, fold: int):
    """((TH, TW, fold, PX, PY, cap), blocks) of the band body's tiling of an
    (h, w) image or canvas (``crop`` as :func:`mp2_geometry`) into TH x TW
    tiles: the threads and window cells its largest window needs."""
    r0, r1, c0, c1 = crop or (0, h, 0, w)
    nr, wh = _mp2_axis(h, r0, r1, th, fold, False)
    nc, ww = _mp2_axis(w, c0, c1, tw, fold, True)
    return (th, tw, fold, ww // 2, -(-wh // MP2_ROWS), wh * ww), nr * nc


@functools.lru_cache(maxsize=256)
def mp2_geometry(h: int, w: int, crop=None, sms: int = SMS):
    """(TH, TW, fold, PX, PY, cap) of a K9 band-body launch on an (h, w)
    image or, with ``crop`` = (r0, r1, c0, c1), on a shard canvas (the
    whole canvas tiled, cut at the crop, the thin outer tiles folded where
    ``fold``): PX x PY threads (PX pairs across, PY strips of MP2_ROWS
    rows down, enough for the largest window), windows of at most ``cap``
    cells. Among the tilings whose window fits a block, those that let an
    SM hold two blocks are taken where any does, and of them the one whose
    busiest SM (the blocks spread evenly over ``sms`` SMs) updates the
    fewest window cells, the larger tile on a tie."""
    static = mp2_static_bytes()
    best = []
    for fold in ((0, 1) if crop is not None else (0,)):
        for th in BAND_TILE_ROWS:
            for tw in BAND_TILE_COLS:
                geo, nblocks = mp2_tiling(h, w, crop, th, tw, fold)
                _, _, _, px, py, cap = geo
                if (px * py > BAND_THREADS or MP2_BAND_CELL_BYTES * cap
                        + static > SMEM_LIMIT + 1024):
                    continue
                bps = mp2_blocks_per_sm(px * py, cap)
                load = -(-nblocks // sms) * cap
                best.append((bps < 2, load, -th * tw, fold, geo))
    if not best:
        raise ValueError(f"no K9 band-body tiling of the {(h, w)} image "
                         f"fits a block ({BAND_THREADS} threads, "
                         f"{SMEM_LIMIT} B)")
    return min(best)[-1]


def mp2_occupancy(shard: bool, threads: int, cap: int) -> int:
    """The card's blocks per SM of K9's band body at ``threads`` threads
    and ``cap`` window cells
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes

    from .._build import library

    n = ctypes.c_int(0)
    lib = library()
    err = lib.cv_mp2_band_occupancy(int(shard), threads,
                                    MP2_BAND_CELL_BYTES * cap,
                                    ctypes.byref(n))
    if err:
        raise RuntimeError(f"mp2 band occupancy query failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return n.value


def mp2_plan(h: int, w: int, shard=None, sms: int = SMS):
    """((TH, TW, fold, PX, PY, cap), blocks) of a K9 band-body launch on an
    (h, w) image, or with ``shard`` (:func:`shard_args`' nine ints) on a
    shard canvas: :func:`mp2_geometry`'s tiling."""
    crop = None if shard is None else tuple(shard[1:5])
    return mp2_tiling(h, w, crop, *mp2_geometry(h, w, crop, sms)[:3])


def launch_mp2(phis, u0, cs, p, shard=None, v1=False):
    """One banded 4-phase iteration (csrc/mp2_band.cu) on (2, H, W) level
    sets (shapes checked by the wrapper) with the four phase means ``cs``;
    with ``shard`` (:func:`shard_args`' nine ints) on a shard canvas, every
    cell swept. The band body; ``v1``: the first body (the yardstick the
    smoke and the cuda-marked tests hold it against). Returns (phis_new,
    partials (16,) f32)."""
    from .._build import library

    _check_inputs(phis, u0)
    h, w = u0.shape
    cc = torch.as_tensor(cs, device=phis.device).to(torch.float32)
    cc = cc.reshape(4).contiguous()
    params = (p.mu, p.nu, 0.0, 0.0, *_common_params(p))
    if v1:
        symbol = ("cv_mp2_iteration_v1" if shard is None
                  else "cv_mp2_iteration_shard_v1")
        return _launch(symbol, phis, u0, cc, (), None, h, w, 10, 16, params,
                       reach=MP2_REACH, cell_bytes=MP2_CELL_BYTES,
                       shard=shard, canvas_tiles=shard is not None)
    check_even(h, w)
    if phis.data_ptr() % 8 or u0.data_ptr() % 8:
        raise ValueError("the band body reads 8-byte pairs: phis and u0 must "
                         "start on an 8-byte boundary")
    dev = phis.device
    geo, nblocks = mp2_plan(h, w, shard, _sm_count(dev.index))
    out = torch.empty_like(phis)
    block_parts = torch.empty((nblocks, MP2_SUMS), dtype=torch.float64,
                              device=dev)
    parts = torch.empty(16, dtype=torch.float32, device=dev)
    symbol = "cv_mp2_iteration" if shard is None else "cv_mp2_iteration_shard"
    lib = library()
    with torch.cuda.device(dev):
        err = getattr(lib, symbol)(
            phis.data_ptr(), u0.data_ptr(), cc.data_ptr(), out.data_ptr(),
            block_parts.data_ptr(), parts.data_ptr(), h, w, *geo, nblocks,
            *params, *(shard or ()),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return out, parts


# threads per block of the resident kernels' first body (csrc/resident.cuh
# kResThreads)
RESIDENT_THREADS = 512
# the tile bodies (csrc/resident_tiles.cuh, mp2.cuh; K7-K10): threads a
# block, and room left beside the dynamic shared memory for the static part
# (the reduction scratch and the means, under 2 KB)
TILE_THREADS = 512
TILE_STATIC = 2048
# u32s of a tile-body launch's sync buffer: the grid-wide step's ticket and
# a spare, then its published words (two u32 each), one a mean; a frame
# group's buffer starts TILE_SYNC_STRIDE u32s after the one before
# (csrc/resident_tiles.cuh kSyncStride), on a cache line of its own
TILE_SYNC = 2 + 2 * 2 * MAX_CHANNELS
TILE_SYNC_STRIDE = 64
# the frame-group rule's price of a group's iteration skeleton (the rim
# waits, the group's step), in the cells of a block's tile whose sweeps
# take as long (chip_resident_variants.py --groups on the card)
GROUP_STEP_CELLS = 2800


def tile_smem_bytes(th: int, tw: int, channels: int, level_sets: int,
                    u0res: bool) -> int:
    """Dynamic shared memory of a tile body's block
    (csrc/resident_tiles.cuh ``tile_smem_bytes``): per level set the
    tile padded by one cell a side and half a tile for the new values (two
    level sets: a label byte a cell too), and u0's planes (one a channel)
    where ``u0res``."""
    pad = (th + 2) * (tw + 2)
    if level_sets == 1:
        return 4 * (pad + th * tw // 2
                    + (max(channels, 1) * th * tw if u0res else 0))
    return 4 * (2 * pad + th * tw + (th * tw if u0res else 0)) + th * tw


def tile_budget(per_sm: int = 1) -> int:
    """Dynamic shared memory a tile body's block may take at ``per_sm``
    blocks an SM: its share of the SM's (1 KB reserved a block), at most a
    block's limit, less the static part."""
    return min(SMEM_LIMIT + 1024, SM_SMEM // per_sm - 1024) - TILE_STATIC


@functools.lru_cache(maxsize=None)
def resident_tile_geometry(h: int, w: int, channels: int = 0,
                           level_sets: int = 1, sms: int = SMS,
                           per_sm: int = 1):
    """(TH, TW, GX, GY, u0res, smem) of a tile-body launch on an (h, w)
    image: a GY x GX grid of TH x TW tiles (TW even; the last row and
    column ragged) of one block each, ``channels`` u0 planes (0: a scalar
    image), one level set (K7/K8) or two (K9/K10). Blocks: as many as
    give every thread a cell pair, at most ``sms`` x ``per_sm``. Of the
    grids of that many blocks the one whose largest tile, with its ring,
    has the fewest cells, then the shortest border, then the widest tile. u0 stays in
    shared memory (u0res) where the block's budget (:func:`tile_budget`)
    holds it beside the level sets; smem is the block's dynamic bytes.
    Raises where even the level sets do not fit."""
    if level_sets not in (1, 2):
        raise ValueError(f"{level_sets} level sets; the bodies take 1 or 2")
    if h < 1 or w < 2 or w % 2:
        raise ValueError(f"image {(h, w)}: the bodies take even widths")
    want = max(1, min(sms * per_sm, h * w // 2 // TILE_THREADS))
    best = None
    for gy in range(1, min(want, h) + 1):
        gx = want // gy
        th = -(-h // gy)
        tw = -(-w // gx)
        tw += tw & 1
        key = ((th + 2) * (tw + 2), th + tw, -tw)
        if best is None or key < best[0]:
            best = (key, th, tw, -(-w // tw), -(-h // th))
    _, th, tw, gx, gy = best
    budget = tile_budget(per_sm)
    for u0res in (True, False):
        smem = tile_smem_bytes(th, tw, channels, level_sets, u0res)
        if smem <= budget:
            return th, tw, gx, gy, u0res, smem
    raise ValueError(f"the {(h, w)} image's {th}x{tw} tiles need {smem} B "
                     f"of shared memory, more than a block's {budget} at "
                     f"{per_sm} a {sms}-SM card")


@functools.lru_cache(maxsize=None)
def resident_capacity(symbol: str, c: int, device_index: int,
                      smem=None) -> int:
    """Most blocks of resident kernel ``symbol`` (C channels) that can be
    co-resident on the device: occupancy per SM times the SM count, from
    the library's ``_grid`` query, at ``smem`` dynamic bytes a block for
    the tile bodies (None: the first body's and K13's queries, which take
    none). Raises where the device cannot launch cooperatively."""
    import ctypes

    from .._build import library

    lib = library()
    n = ctypes.c_int(0)
    extra = () if smem is None else (smem,)
    with torch.cuda.device(device_index):
        err = getattr(lib, f"{symbol}_grid")(c, *extra, ctypes.byref(n))
    if err:
        raise RuntimeError(f"{symbol} occupancy query failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return n.value


@functools.lru_cache(maxsize=None)
def frame_groups(n: int, h: int, w: int, channels: int = 0,
                 sms: int = SMS):
    """(G, geometry) of a two-phase tile-body launch on ``n`` frames of
    (h, w) (``channels`` u0 planes, 0: scalar): G frame groups, group g
    running frames g, g + G, ... on the tiles of
    ``resident_tile_geometry(h, w, channels, 1, sms // G)``, one block
    each (csrc/resident_tiles.cuh). A group's iteration costs its skeleton
    (:data:`GROUP_STEP_CELLS`) plus its largest tile's cells; G makes
    ceil(n / G) of them the least, of the G whose tiles keep u0 in shared
    memory (G = 1 always qualifies; ties go to the smaller G). One frame:
    G = 1, today's geometry."""
    best = None
    for g in range(1, min(n, sms) + 1):
        try:
            geo = resident_tile_geometry(h, w, channels, 1, sms // g)
        except ValueError:
            if g == 1:
                raise
            continue
        if g > 1 and not geo[4]:
            continue
        cost = -(-n // g) * (GROUP_STEP_CELLS + geo[0] * geo[1])
        if best is None or cost < best[0]:
            best = (cost, g, geo)
    return best[1], best[2]


def group_plan(symbol: str, h: int, w: int, c: int, level_sets: int, dev,
               frames: int = 1):
    """The tile geometry of a launch on ``dev``, its frame groups (a
    stack's, :func:`frame_groups`; one for a single image) and the grid's
    block count, refused (raises) where the card cannot hold that many
    blocks at once: the spin-waits need every block resident.
    ``group_plan.launches`` counts the launches of more than one group
    (``launch_resident``)."""
    sms = _sm_count(dev.index)
    g, geo = (frame_groups(frames, h, w, c, sms) if frames > 1 else
              (1, resident_tile_geometry(h, w, c, level_sets, sms)))
    th, tw, gx, gy, _, smem = geo
    cap = resident_capacity(symbol, c, dev.index, smem)
    if g * gx * gy > cap:
        raise RuntimeError(f"{symbol}: {g} x {gx * gy} blocks of {smem} B "
                           f"cannot be co-resident on the card ({cap})")
    return geo, g, g * gx * gy


group_plan.launches = 0


def launch_resident(symbol: str, phi, u0, p, iters: int, unroll: int,
                    h: int, w: int, frames: int = 1, batch: bool = False,
                    l1=None, l2=None, v1: bool = False):
    """One cooperative launch of resident kernel ``symbol`` on image
    geometry (h, w): ``iters`` exact-means iterations. phi holds one image
    or ``frames`` of them (flat or parity planes); u0 is phi's shape for a
    scalar image, channels-first (C, *phi.shape) when per-channel lambda
    tuples ``l1``, ``l2`` are given. The tile body
    (csrc/resident_tiles.cuh; a stack's frames in the groups of
    :func:`group_plan`); ``v1``: the first body (csrc/resident.cuh, the
    yardstick the smoke and the cuda-marked tests hold it against).
    Returns (phi_new, partials): rows of 8 slots (C + 4 for C channels),
    one per ``unroll`` iterations, or one per frame when ``batch``."""
    from .._build import library

    c = 0
    if l1 is not None:
        c = mc_channels(phi, u0)
    elif u0.shape != phi.shape:
        raise ValueError(f"u0 {tuple(u0.shape)} vs phi {tuple(phi.shape)}")
    _check_inputs(phi, u0)
    check_even(h, w)
    dev = phi.device
    nrow = c + 4 if c else 8
    out = torch.empty_like(phi)
    usum = u0.reshape(c or frames, -1).sum(1, dtype=torch.float64)
    wts = _weights(tuple(l1), tuple(l2), dev) if c else None
    parts = torch.empty((frames if batch else iters // unroll, nrow),
                        dtype=torch.float32, device=dev)
    scalar_l = (p.lambda1, p.lambda2) if not c else (0.0, 0.0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = library()
    if v1:
        symbol += "_v1"
        cap = resident_capacity(symbol, c, dev.index)
        nblocks = max(1, min(cap, math.ceil(h * w // 2 / RESIDENT_THREADS)))
        tmp = torch.empty(h * w, dtype=torch.float32, device=dev)
        scratch = torch.empty(nblocks * (max(c, 1) + 4),
                              dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            err = getattr(lib, symbol)(
                phi.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                u0.data_ptr(), usum.data_ptr(),
                None if wts is None else wts.data_ptr(), scratch.data_ptr(),
                parts.data_ptr(), nblocks, frames, h, w, c, iters, unroll,
                int(batch), nrow, p.mu, p.nu, *scalar_l, *_common_params(p),
                stream)
        _raise_on(lib, symbol, err)
        return out, parts
    (th, tw, gx, gy, u0res, smem), groups, nblocks = group_plan(
        symbol, h, w, c, 1, dev, frames if batch else 1)
    # the blocks' slots, then the totals a row carries, a set a group
    scratch = torch.empty((nblocks + groups) * (max(c, 1) + 4),
                          dtype=torch.float64, device=dev)
    # the tagged rim words (a float and its iteration's tag), by parity
    rims = torch.zeros(2 * nblocks * 2 * (th + tw), dtype=torch.int64,
                       device=dev)
    sync = torch.zeros(max(TILE_SYNC, groups * TILE_SYNC_STRIDE),
                       dtype=torch.int32, device=dev)
    # a stack's frame groups, named in the profiler's trace
    grouped = (spans.span(f"cv.tile.groups.G{groups}xB{gx * gy}")
               if groups > 1 else contextlib.nullcontext())
    with torch.cuda.device(dev), grouped:
        err = getattr(lib, symbol)(
            phi.data_ptr(), out.data_ptr(), u0.data_ptr(), usum.data_ptr(),
            None if wts is None else wts.data_ptr(), scratch.data_ptr(),
            rims.data_ptr(), sync.data_ptr(), parts.data_ptr(), nblocks,
            frames, h, w, c, iters, unroll, int(batch), nrow, th, tw, gx,
            int(u0res), smem, groups, p.mu, p.nu, *scalar_l,
            *_common_params(p), stream)
    _raise_on(lib, symbol, err)
    if groups > 1:
        group_plan.launches += 1
    return out, parts


def launch_resident_chunk(symbol: str, phi, u0, c1, c2, p, k: int, h: int,
                          w: int, v1: bool = False):
    """One cooperative launch of frozen-means chunk kernel ``symbol`` (K13)
    on image geometry (h, w), phi and u0 flat or as parity planes: k
    iterations with means c1, c2. The tile body (csrc/resident_tiles.cuh's
    frozen mode, tiles from :func:`resident_tile_geometry`); ``v1``: the
    first body (csrc/resident.cuh). Returns (phi_new, partials (8,) f32 of
    the last iteration)."""
    from .._build import library

    if u0.shape != phi.shape:
        raise ValueError(f"u0 {tuple(u0.shape)} vs phi {tuple(phi.shape)}")
    _check_inputs(phi, u0)
    check_even(h, w)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    dev = phi.device
    out = torch.empty_like(phi)
    cc = _means(c1, c2, dev)
    parts = torch.empty(8, dtype=torch.float32, device=dev)
    params = (p.mu, p.nu, p.lambda1, p.lambda2, *_common_params(p))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = library()
    if v1:
        symbol += "_v1"
        cap = resident_capacity(symbol, 0, dev.index)
        nblocks = max(1, min(cap, math.ceil(h * w // 2 / RESIDENT_THREADS)))
        tmp = torch.empty(h * w, dtype=torch.float32, device=dev)
        # (nblocks, 2) H sums and (nblocks, 3) row sums
        scratch = torch.empty(nblocks * 5, dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            err = getattr(lib, symbol)(
                phi.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                u0.data_ptr(), cc.data_ptr(), scratch.data_ptr(),
                parts.data_ptr(), nblocks, h, w, k, *params, stream)
        _raise_on(lib, symbol, err)
        return out, parts
    (th, tw, gx, _, u0res, smem), _, nblocks = group_plan(symbol, h, w, 0,
                                                          1, dev)
    # the blocks' slots (H sums, then the row's sums), and the totals
    scratch = torch.empty((nblocks + 1) * 5, dtype=torch.float64, device=dev)
    # the tagged rim words and then the sync words, zeroed in one launch
    nrim = 2 * nblocks * 2 * (th + tw)
    words = torch.zeros(nrim + TILE_SYNC // 2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, symbol)(
            phi.data_ptr(), out.data_ptr(), u0.data_ptr(), cc.data_ptr(),
            scratch.data_ptr(), words.data_ptr(),
            words.data_ptr() + 8 * nrim,
            parts.data_ptr(), nblocks, h, w, k, th, tw, gx, int(u0res), smem,
            *params, stream)
    _raise_on(lib, symbol, err)
    return out, parts


def launch_pack(symbol: str, src, shape):
    """One K15/K16 launch (csrc/pack.cu): ``symbol`` 'cv_pack_planes' maps
    an (N, H, W) f32 stack to (N, 2, 2, H/2, W/2) planes, 'cv_unpack_planes'
    back; ``shape`` is the output's shape. Four columns a thread where W
    allows it, else two."""
    from .._build import library

    if src.dtype != torch.float32:
        raise TypeError(f"the pack kernels take float32, got {src.dtype}")
    n, h, w = (shape[0], 2 * shape[3], 2 * shape[4]) if len(shape) == 5 \
        else shape
    check_even(h, w)
    src = src.contiguous()
    if src.data_ptr() % 16:  # a view at an offset: the vector loads need
        src = src.clone()    # an aligned start (fresh buffers are)
    out = torch.empty(shape, dtype=torch.float32, device=src.device)
    lib = library()
    with torch.cuda.device(src.device):
        err = getattr(lib, symbol)(
            src.data_ptr(), out.data_ptr(), n, h, w, 4 if w % 4 == 0 else 2,
            torch.cuda.current_stream(src.device).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return out


def launch_mp2_resident(symbol: str, phis, u0, p, iters: int, unroll: int,
                        h: int, w: int, v1: bool = False):
    """One cooperative launch of 4-phase resident kernel ``symbol`` on image
    geometry (h, w): ``iters`` coupled iterations with exact means. phis
    holds the two level sets, each flat or as parity planes; u0 one image
    in the same layout. The tile body (csrc/mp2.cuh mp2_tile_kernel);
    ``v1``: the first body (mp2_resident_kernel). Returns (phis_new,
    partials (iters // unroll, 8))."""
    from .._build import library

    if phis.shape[0] != 2 or tuple(phis.shape[1:]) != tuple(u0.shape):
        raise ValueError(f"phis {tuple(phis.shape)} vs u0 "
                         f"{tuple(u0.shape)}: expected (2, *u0.shape)")
    _check_inputs(phis, u0)
    check_even(h, w)
    dev = phis.device
    out = torch.empty_like(phis)
    parts = torch.empty((iters // unroll, 8), dtype=torch.float32,
                        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = library()
    if v1:
        symbol += "_v1"
        cap = resident_capacity(symbol, 0, dev.index)
        nblocks = max(1, min(cap, math.ceil(h * w // 2 / RESIDENT_THREADS)))
        tmp = torch.empty_like(phis)
        lab = torch.empty(h * w, dtype=torch.uint8, device=dev)
        scratch = torch.empty(nblocks * 10, dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            err = getattr(lib, symbol)(
                phis.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                lab.data_ptr(), u0.data_ptr(), scratch.data_ptr(),
                parts.data_ptr(), nblocks, h, w, iters, unroll, p.mu, p.nu,
                *_common_params(p), stream)
        _raise_on(lib, symbol, err)
        return out, parts
    (th, tw, gx, _, u0res, smem), _, nblocks = group_plan(symbol, h, w, 0,
                                                          2, dev)
    # the blocks' 10 slots
    scratch = torch.empty(nblocks * 10, dtype=torch.float64, device=dev)
    # the tagged rim words of both level sets and then the sync words,
    # zeroed in one launch
    nrim = 2 * 2 * nblocks * 2 * (th + tw)
    words = torch.zeros(nrim + TILE_SYNC // 2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, symbol)(
            phis.data_ptr(), out.data_ptr(), u0.data_ptr(),
            scratch.data_ptr(), words.data_ptr(),
            words.data_ptr() + 8 * nrim,
            parts.data_ptr(), nblocks, h, w, iters, unroll, th, tw, gx,
            int(u0res), smem, p.mu, p.nu, *_common_params(p), stream)
    _raise_on(lib, symbol, err)
    return out, parts


# the morphological kernels: kind codes (csrc/morph_bits.cuh BitsKind,
# csrc/morph.cuh MorphKind) and the first body's shared-memory bytes per
# window cell (morph_cell_bytes)
MORPH_KINDS = {"acwe": 0, "gac": 1, "gac_pre": 2, "acwe_fused": 3,
               "acwe_sh": 4, "gac_pre_sh": 5}
MORPH_CELL_BYTES = {"acwe": 3, "gac": 11, "gac_pre": 11, "acwe_fused": 3,
                    "acwe_sh": 3, "gac_pre_sh": 11}
# the bit body (csrc/morph_bits.cuh): threads a block and the blocks an SM
# its __launch_bounds__ asks for (64 registers a thread); shared-memory
# words a window word (two state buffers and two force-sign planes, or
# eight attraction planes, the balloon mask and two state buffers); the
# words a window row may hold (a warp keeps a row's words in its lanes),
# those it holds if the halo leaves room, and the tile heights tried,
# tallest first
MORPH_THREADS, MORPH_MIN_BLOCKS = 512, 2
MORPH_WORDS = {"acwe": 4, "acwe_fused": 4, "acwe_sh": 4, "gac": 11,
               "gac_pre": 11, "gac_pre_sh": 11}
MORPH_MAX_WORDS, MORPH_ROW_WORDS = 32, 16
MORPH_TILE_ROWS = (128, 96, 64, 48, 32, 24, 16, 8)


def morph_static_bytes() -> int:
    """Static shared memory of morph_bits_kernel: the f64 reduction
    scratch, the four floats of cc and the last-block flag."""
    return 2 * 8 * (MORPH_THREADS // 32) + 16 + 4


def morph_blocks_per_sm(kind: str, cap: int) -> int:
    """Blocks of the bit body an SM holds at ``cap`` window words, by
    registers, warps and shared memory (the design's count; the card's own
    is :func:`morph_occupancy`)."""
    warps = MORPH_THREADS // 32
    regs = SM_REGS // (MORPH_THREADS * MORPH_MIN_BLOCKS)
    return min(SM_REGS // (regs * 32 * warps), SM_WARPS // warps,
               SM_SMEM // (4 * MORPH_WORDS[kind] * cap + morph_static_bytes()
                           + 1024), 32)


def _morph_axis(n: int, t: int) -> int:
    """Tiles of at most t cells over n cells, evened out: the tile size."""
    return -(-n // -(-n // t))


@functools.lru_cache(maxsize=256)
def morph_geometry(kind: str, h: int, w: int, halo: int, crop=None,
                   sms: int = SMS):
    """(TH, TW, WW, cap, nblocks) of a bit-body launch of ``kind`` on an
    (h, w) image, or on a shard block whose ``crop`` = (r0, r1, c0, c1) the
    tiles cover, with a ``halo``-cell window margin: tiles as wide as a
    window of MORPH_ROW_WORDS words leaves room for (MORPH_MAX_WORDS where
    the halo does not), evened out across the region; windows of at most
    WW words and cap = WW x rows words; and of the MORPH_TILE_ROWS with
    shared memory for MORPH_MIN_BLOCKS blocks an SM, the one whose busiest
    SM has the fewest window rows to load and sweep: ceil(blocks / SMs)
    times the window's rows (the taller of two equals). An SM's blocks
    share its issue slots, so the halo's recompute and load, not idle SMs,
    set the time (PERF.md §6, ``chip_morph_variants.py``: on an H100 this
    picks the fastest tile height, or one within a few percent of it, at
    4K and on a 2x2 shard block)."""
    th_all, tw_all = (h, w) if crop is None else (crop[1] - crop[0],
                                                  crop[3] - crop[2])
    if th_all < 1 or tw_all < 1:
        raise ValueError(f"no cells to tile in {(h, w)} (crop {crop})")
    words = MORPH_ROW_WORDS
    if 32 * words - 2 * halo < 64:
        words = MORPH_MAX_WORDS
    if 32 * words - 2 * halo < 32:
        raise ValueError(f"a halo of {halo} cells leaves no tile in a window "
                         f"row of {MORPH_MAX_WORDS} words")
    tw = _morph_axis(tw_all, 32 * words - 2 * halo)
    ww = -(-min(tw + 2 * halo, w) // 32)
    best = None
    for rows in MORPH_TILE_ROWS:
        th = min(rows, th_all)
        wrows = min(th + 2 * halo, h)
        cap = wrows * ww
        if morph_blocks_per_sm(kind, cap) < MORPH_MIN_BLOCKS:
            continue
        nblocks = -(-th_all // th) * -(-tw_all // tw)
        key = (-(-nblocks // sms) * wrows, -th)
        if best is None or key < best[0]:
            best = (key, (th, tw, ww, cap, nblocks))
    if best is None:
        raise ValueError(f"a halo of {halo} cells needs more shared memory "
                         f"than {MORPH_MIN_BLOCKS} blocks of the bit body "
                         f"an SM hold")
    return best[1]


def _morph_crop(h: int, w: int, shard):
    return None if shard is None else (shard[0], h - shard[1], shard[2],
                                       w - shard[3])


def morph_occupancy(kind: str, cap: int) -> int:
    """The card's blocks per SM of the bit body's ``kind`` at ``cap``
    window words (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes

    from .._build import library

    lib = library()
    n = ctypes.c_int(0)
    if kind == "acwe_fused":
        err = lib.cv_morph_fused_bits_occupancy(cap, ctypes.byref(n))
    else:
        err = lib.cv_morph_bits_occupancy(MORPH_KINDS[kind], cap,
                                          ctypes.byref(n))
    if err:
        raise RuntimeError(f"morph occupancy query failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return n.value


def _morph_geometry_v1(kind, h, w, k, halo):
    return tile_geometry(h, w, k, MORPH_CELL_BYTES[kind], span=2 * halo)


def _raise_on(lib, symbol, err):
    if err:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")


def launch_morph(kind: str, ls, aux, k: int, smoothing: int, parity0: int,
                 balloon: int, thr_b: float, halo: int, shard=None,
                 v1: bool = False):
    """One K11 launch (csrc/morph_band.cu) of ``kind`` ('acwe', 'gac',
    'gac_pre'; 'acwe_sh', 'gac_pre_sh' with ``shard`` = (pt, pb, pcl, pcr,
    top, bottom, left, right) ints) on an (H, W) binary level set: k
    iterations with a ``halo``-cell window margin, on the bit body
    (morph_bits.cuh), or with ``v1`` on the first body (morph.cuh). Returns
    the new level set."""
    from .._build import library

    _check_inputs(ls, aux, ("ls", "aux"))
    h, w = ls.shape
    out = torch.empty_like(ls)
    lib = library()
    stream = torch.cuda.current_stream(ls.device).cuda_stream
    symbol = "cv_morph_chunk" if shard is None else "cv_morph_chunk_shard"
    if v1:
        symbol += "_v1"
        geo = _morph_geometry_v1(kind, h, w, k, halo)
    else:
        geo = morph_geometry(kind, h, w, halo, _morph_crop(h, w, shard))
    err = getattr(lib, symbol)(
        ls.data_ptr(), aux.data_ptr(), out.data_ptr(), h, w,
        MORPH_KINDS[kind], k, smoothing, parity0, balloon, thr_b, halo, *geo,
        *(shard or ()), stream)
    _raise_on(lib, symbol, err)
    return out


def launch_morph_fused(ls, u0, cc, k: int, smoothing: int, parity0: int,
                       halo: int, v1: bool = False):
    """One K12 launch (csrc/morph_fused.cu): k MorphACWE iterations with
    the force from u0 and ``cc`` = (c_in, c_out, l1, l2) on the device, on
    the bit body (its last block sums the partials), or with ``v1`` on the
    first body (a second launch sums them). Returns (ls_new, partials (2,)
    f32: sum ls, sum u0 ls)."""
    from .._build import library

    _check_inputs(ls, u0, ("ls", "u0"))
    h, w = ls.shape
    dev = ls.device
    out = torch.empty_like(ls)
    parts = torch.empty(2, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)
    lib = library()
    if v1:
        th, tw, cap = _morph_geometry_v1("acwe_fused", h, w, k, halo)
        nblocks = math.ceil(h / th) * math.ceil(w / tw)
        block_parts = torch.empty((nblocks, 2), dtype=torch.float64,
                                  device=dev)
        err = lib.cv_morph_fused_chunk_v1(
            ls.data_ptr(), u0.data_ptr(), cc.data_ptr(), out.data_ptr(),
            block_parts.data_ptr(), parts.data_ptr(), h, w, k, smoothing,
            parity0, halo, th, tw, cap, stream.cuda_stream)
        _raise_on(lib, "cv_morph_fused_chunk_v1", err)
        return out, parts
    geo = morph_geometry("acwe_fused", h, w, halo)
    block_parts = torch.empty((geo[-1], 2), dtype=torch.float64, device=dev)
    counter = _sweep_counters(dev, stream, 1)
    with torch.cuda.device(dev):
        err = lib.cv_morph_fused_chunk(
            ls.data_ptr(), u0.data_ptr(), cc.data_ptr(), out.data_ptr(),
            block_parts.data_ptr(), counter.data_ptr(), parts.data_ptr(), h,
            w, k, smoothing, parity0, halo, *geo, stream.cuda_stream)
    _raise_on(lib, "cv_morph_fused_chunk", err)
    return out, parts


# csrc/reinit.cu's tile body (R1): most threads a block and rows a strip,
# registers a thread under __launch_bounds__ (two blocks an SM in f32, one
# in f64), the pass depths and the block shapes (PX columns, PY strips of
# RS rows: the window) the geometry chooses among, those that
# chip_reinit_variants.py times
REINIT_THREADS, REINIT_ROWS = 512, 16
REINIT_REGS = {4: 64, 8: 128}
REINIT_DEPTHS = (5, 10, 20)
REINIT_BLOCKS = ((128, 4, 16), (128, 4, 8), (128, 4, 12), (128, 2, 16),
                 (256, 2, 16), (256, 2, 8), (160, 3, 16), (96, 5, 16),
                 (64, 8, 8), (64, 4, 8), (32, 8, 4), (32, 16, 4))
# the geometry's cost model, in issue cycles of an SM: instructions a cell
# step, the warps an SM needs to issue at its rate, a launch's fixed cost,
# the bytes an SM's share of the memory rate moves a cycle, fitted to
# chip_reinit_variants.py's times on an H100 (PERF.md §6)
REINIT_CPI, REINIT_WARPS = 50, 8
REINIT_LAUNCH, REINIT_BYTES = 4000, 14


def reinit_smem(h: int, w: int, k: int, th: int, tw: int,
                itemsize: int) -> int:
    """Shared memory of the tile body's window: psi's two planes and the
    prepass values, each min(TH + 2k, H) + 2 rows by min(TW + 2k, W) + 2
    columns (csrc/reinit.cu tile_smem)."""
    return (min(th + 2 * k, h) + 2) * (min(tw + 2 * k, w) + 2) * 3 * itemsize


def reinit_blocks_per_sm(threads: int, smem: int, itemsize: int) -> int:
    """Blocks of the tile body an SM holds by registers, warps and shared
    memory (the design's count; the card's own is
    :func:`reinit_occupancy`)."""
    warps = -(-threads // 32)
    return min(SM_REGS // (REINIT_REGS[itemsize] * 32 * warps),
               SM_WARPS // warps, SM_SMEM // (smem + 1024), 32)


def reinit_passes(steps: int, k: int):
    """The steps of each of the ceil(steps / k) passes, split evenly
    (csrc/reinit.cu launch_tile)."""
    n = -(-steps // k)
    return [steps // n + (i < steps % n) for i in range(n)]


def _reinit_axis(n: int, window: int, k: int):
    """Tile extent on an axis of n cells for a window of ``window``: the
    whole axis where it fits, else the window less a halo each way."""
    return n if n <= window else window - 2 * k


@functools.lru_cache(maxsize=256)
def reinit_geometry(b: int, h: int, w: int, steps: int, itemsize: int = 4,
                    sms: int = SMS):
    """(k, TH, TW, PX, PY, RS) of a redistance of ``steps`` steps on a (b,
    h, w) stack of ``itemsize``-byte cells on the tile body: passes of at
    most k steps, TH x TW tiles, PX x PY threads of RS-row strips. Among
    the depths of REINIT_DEPTHS (and ``steps`` below them) and the block
    shapes of REINIT_BLOCKS, the least cost by a model of the busiest SM:
    the cells its blocks compute in each step (the window shrinking a cell
    a step from each cut side) at REINIT_CPI instructions, slowed where
    the SM holds fewer than REINIT_WARPS warps, against its share of the
    window loads and stores, plus a launch a pass."""
    best = None
    for k in sorted({min(d, steps) for d in REINIT_DEPTHS}):
        passes = reinit_passes(steps, k)
        for px, py, rs in REINIT_BLOCKS:
            th, tw = _reinit_axis(h, py * rs, k), _reinit_axis(w, px, k)
            if th < 1 or tw < 1:
                continue
            smem = reinit_smem(h, w, k, th, tw, itemsize)
            bps = reinit_blocks_per_sm(px * py, smem, itemsize)
            if bps < 1:
                continue
            per_sm = -(-(b * -(-h // th) * -(-w // tw)) // sms)
            wh, ww = min(th + 2 * k, h), min(tw + 2 * k, w)
            warps = min(bps, per_sm) * -(-px * py // 32)
            rate = min(1.0, warps / REINIT_WARPS)
            cost = 0
            for n_steps in passes:
                cells = sum(min(th + 2 * (k - n), h) * min(tw + 2 * (k - n), w)
                            for n in range(1, n_steps + 1))
                issue = per_sm * cells * REINIT_CPI / 128 / rate
                moved = per_sm * (2 * wh * ww + th * tw) * itemsize
                cost += max(issue, moved / REINIT_BYTES) + REINIT_LAUNCH
            key = (cost, -th * tw, px * py)
            if best is None or key < best[0]:
                best = (key, (k, th, tw, px, py, rs))
    if best is None:
        raise ValueError(f"no tile of the redistance fits ({h} x {w})")
    return best[1]


def reinit_occupancy(threads: int, smem: int, f64: bool,
                     device_index: int = 0) -> int:
    """Blocks of the tile body an SM of the card holds at ``threads``
    threads and ``smem`` bytes of window (cudaOccupancy...)."""
    import ctypes

    from .._build import library

    lib = library()
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.cv_reinit_occupancy(int(f64), threads, smem,
                                      ctypes.byref(n))
    _raise_on(lib, "cv_reinit_occupancy", err)
    return n.value


def launch_reinit(phi, steps: int, dtau: float, h: float,
                  v1: bool = False, geometry=None):
    """One redistance on R1 (csrc/reinit.cu) of an (H, W) level set or a
    (B, H, W) stack of them, float32 or float64, each frame on its own: the
    tile body's ceil(steps / k) passes at ``geometry`` = (k, TH, TW, PX,
    PY, RS) (default :func:`reinit_geometry`), or with ``v1`` the first
    body's prepass and ``steps`` step launches. Returns the redistanced
    tensor (a new one, ``phi``'s shape)."""
    from .._build import library

    if phi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"R1 takes float32 or float64, got {phi.dtype}")
    if phi.ndim not in (2, 3) or min(phi.shape) < 1:
        raise ValueError(f"R1 takes (H, W) or (B, H, W), got "
                         f"{tuple(phi.shape)}")
    b, h_, w = (1, *phi.shape) if phi.ndim == 2 else phi.shape
    if b > MAX_FRAMES:
        raise ValueError(f"R1 takes at most {MAX_FRAMES} frames, got {b}")
    phi = phi.contiguous()
    dev = phi.device
    f64 = int(phi.dtype == torch.float64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bufs = (torch.empty_like(phi), torch.empty_like(phi))
    lib = library()
    if v1:
        aux = torch.empty_like(phi)
        flags = torch.empty(phi.shape, dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            err = lib.cv_reinit_v1(
                phi.data_ptr(), aux.data_ptr(), flags.data_ptr(),
                bufs[0].data_ptr(), bufs[1].data_ptr(), b, h_, w, steps,
                float(dtau), float(h), f64, stream)
        _raise_on(lib, "cv_reinit_v1", err)
        return bufs[(steps - 1) % 2]
    geo = geometry or reinit_geometry(b, h_, w, steps, phi.element_size())
    with torch.cuda.device(dev):
        err = lib.cv_reinit(phi.data_ptr(), bufs[0].data_ptr(),
                            bufs[1].data_ptr(), b, h_, w, steps, *geo,
                            float(dtau), float(h), f64, stream)
    _raise_on(lib, "cv_reinit", err)
    return bufs[(len(reinit_passes(steps, geo[0])) - 1) % 2]
