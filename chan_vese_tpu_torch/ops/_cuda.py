"""Launch path shared by the red-black kernels (K1-K3 on a scalar image,
K1 on a stack of frames, K4-K6 on a C-channel image), the exact-means
resident kernels (K7 flat, K8 parity planes; scalar, batch and C-channel
modes) and their frozen-means chunk mode (K13), the 4-phase kernels (K9
banded and resident, K10 parity planes), the morphological kernels (K11,
K12) and the parity pack and unpack (K15, K16).

Checks the inputs, chooses the tile geometry (the resident kernels: the
cooperative grid), allocates the outputs and scratch, and calls the kernel
library (``_build.library()``) on PyTorch's current stream. Nothing here
synchronizes with the device. A refused launch raises.
"""

from __future__ import annotations

import functools
import math

import torch

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


def launch_chunk(symbol: str, phi, u0, c1, c2, p, k, h: int, w: int,
                 shard=None):
    """Run scalar kernel ``symbol`` on image geometry (h, w); phi/u0 hold
    it flat or as parity planes. ``shard``: the :func:`shard_args` of a
    shard-canvas launch. Returns (phi_new, partials (8,) f32)."""
    _check_inputs(phi, u0)
    if u0.shape != phi.shape:
        raise ValueError(f"u0 {tuple(u0.shape)} vs phi {tuple(phi.shape)}")
    dev = phi.device
    cc = torch.stack([torch.as_tensor(c1, device=dev),
                      torch.as_tensor(c2, device=dev)]).to(torch.float32)
    params = (p.mu, p.nu, p.lambda1, p.lambda2, *_common_params(p))
    return _launch(symbol, phi, u0, cc, (), k, h, w, 5, 8, params,
                   shard=shard)


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
    dev = phi.device
    cc = torch.cat([
        torch.as_tensor(c1, device=dev).reshape(c).to(torch.float32),
        torch.as_tensor(c2, device=dev).reshape(c).to(torch.float32),
        _weights(tuple(l1), tuple(l2), dev)])
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
    whole-canvas tiling of K9's shard mode, csrc/mp2_band.cu crop_tiles)."""
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


# shared-memory bytes per window cell of the banded 4-phase kernel
# (csrc/mp2.cuh kMp2CellBytes: phi0, phi1, u0, f and half a buffer); its
# window carries the halo of two red-black iterations
MP2_CELL_BYTES = 18
MP2_REACH = 2


def launch_mp2(phis, u0, cs, p, shard=None):
    """One banded 4-phase iteration (csrc/mp2_band.cu) on (2, H, W) level
    sets (shapes checked by the wrapper) with the four phase means ``cs``;
    with ``shard`` (:func:`shard_args`' nine ints) on a shard canvas, every
    cell swept. Returns (phis_new, partials (16,) f32)."""
    _check_inputs(phis, u0)
    h, w = u0.shape
    cc = torch.as_tensor(cs, device=phis.device).to(torch.float32)
    cc = cc.reshape(4).contiguous()
    params = (p.mu, p.nu, 0.0, 0.0, *_common_params(p))
    symbol = "cv_mp2_iteration" if shard is None else "cv_mp2_iteration_shard"
    return _launch(symbol, phis, u0, cc, (), None, h, w, 10, 16, params,
                   reach=MP2_REACH, cell_bytes=MP2_CELL_BYTES, shard=shard,
                   canvas_tiles=shard is not None)


# threads per block of the resident kernels (csrc/resident.cuh kResThreads)
RESIDENT_THREADS = 512


@functools.lru_cache(maxsize=None)
def resident_capacity(symbol: str, c: int, device_index: int) -> int:
    """Most blocks of resident kernel ``symbol`` (C channels) that can be
    co-resident on the device: occupancy per SM times the SM count, from
    the library's ``_grid`` query. Raises where the device cannot launch
    cooperatively."""
    import ctypes

    from .._build import library

    lib = library()
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = getattr(lib, f"{symbol}_grid")(c, ctypes.byref(n))
    if err:
        raise RuntimeError(f"{symbol} occupancy query failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return n.value


def launch_resident(symbol: str, phi, u0, p, iters: int, unroll: int,
                    h: int, w: int, frames: int = 1, batch: bool = False,
                    l1=None, l2=None):
    """One cooperative launch of resident kernel ``symbol`` on image
    geometry (h, w): ``iters`` exact-means iterations. phi holds one image
    or ``frames`` of them (flat or parity planes); u0 is phi's shape for a
    scalar image, channels-first (C, *phi.shape) when per-channel lambda
    tuples ``l1``, ``l2`` are given. Returns (phi_new, partials): rows of
    8 slots (C + 4 for C channels), one per ``unroll`` iterations, or one
    per frame when ``batch``."""
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
    cap = resident_capacity(symbol, c, dev.index)
    nblocks = max(1, min(cap, math.ceil(h * w // 2 / RESIDENT_THREADS)))
    out = torch.empty_like(phi)
    tmp = torch.empty(h * w, dtype=torch.float32, device=dev)
    usum = u0.reshape(c or frames, -1).sum(1, dtype=torch.float64)
    wts = _weights(tuple(l1), tuple(l2), dev) if c else None
    scratch = torch.empty(nblocks * (max(c, 1) + 4), dtype=torch.float64,
                          device=dev)
    parts = torch.empty((frames if batch else iters // unroll, nrow),
                        dtype=torch.float32, device=dev)
    scalar_l = (p.lambda1, p.lambda2) if not c else (0.0, 0.0)
    lib = library()
    with torch.cuda.device(dev):
        err = getattr(lib, symbol)(
            phi.data_ptr(), out.data_ptr(), tmp.data_ptr(), u0.data_ptr(),
            usum.data_ptr(), None if wts is None else wts.data_ptr(),
            scratch.data_ptr(), parts.data_ptr(), nblocks, frames, h, w, c,
            iters, unroll, int(batch), nrow, p.mu, p.nu, *scalar_l,
            *_common_params(p), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return out, parts


def launch_resident_chunk(symbol: str, phi, u0, c1, c2, p, k: int, h: int,
                          w: int):
    """One cooperative launch of frozen-means chunk kernel ``symbol`` (K13)
    on image geometry (h, w), phi and u0 flat or as parity planes: k
    iterations with means c1, c2. Returns (phi_new, partials (8,) f32 of
    the last iteration)."""
    from .._build import library

    if u0.shape != phi.shape:
        raise ValueError(f"u0 {tuple(u0.shape)} vs phi {tuple(phi.shape)}")
    _check_inputs(phi, u0)
    check_even(h, w)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    dev = phi.device
    cap = resident_capacity(symbol, 0, dev.index)
    nblocks = max(1, min(cap, math.ceil(h * w // 2 / RESIDENT_THREADS)))
    out = torch.empty_like(phi)
    tmp = torch.empty(h * w, dtype=torch.float32, device=dev)
    cc = torch.stack([torch.as_tensor(c1, device=dev),
                      torch.as_tensor(c2, device=dev)]).to(torch.float32)
    # (nblocks, 2) H sums and (nblocks, 3) row sums
    scratch = torch.empty(nblocks * 5, dtype=torch.float64, device=dev)
    parts = torch.empty(8, dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        err = getattr(lib, symbol)(
            phi.data_ptr(), out.data_ptr(), tmp.data_ptr(), u0.data_ptr(),
            cc.data_ptr(), scratch.data_ptr(), parts.data_ptr(), nblocks, h,
            w, k, p.mu, p.nu, p.lambda1, p.lambda2, *_common_params(p),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
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
                        h: int, w: int):
    """One cooperative launch of 4-phase resident kernel ``symbol`` on image
    geometry (h, w): ``iters`` coupled iterations with exact means. phis
    holds the two level sets, each flat or as parity planes; u0 one image
    in the same layout. Returns (phis_new, partials (iters // unroll, 8))."""
    from .._build import library

    if phis.shape[0] != 2 or tuple(phis.shape[1:]) != tuple(u0.shape):
        raise ValueError(f"phis {tuple(phis.shape)} vs u0 "
                         f"{tuple(u0.shape)}: expected (2, *u0.shape)")
    _check_inputs(phis, u0)
    check_even(h, w)
    dev = phis.device
    cap = resident_capacity(symbol, 0, dev.index)
    nblocks = max(1, min(cap, math.ceil(h * w // 2 / RESIDENT_THREADS)))
    out = torch.empty_like(phis)
    tmp = torch.empty_like(phis)
    lab = torch.empty(h * w, dtype=torch.uint8, device=dev)
    scratch = torch.empty(nblocks * 10, dtype=torch.float64, device=dev)
    parts = torch.empty((iters // unroll, 8), dtype=torch.float32,
                        device=dev)
    lib = library()
    with torch.cuda.device(dev):
        err = getattr(lib, symbol)(
            phis.data_ptr(), out.data_ptr(), tmp.data_ptr(), lab.data_ptr(),
            u0.data_ptr(), scratch.data_ptr(), parts.data_ptr(), nblocks, h,
            w, iters, unroll, p.mu, p.nu, *_common_params(p),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return out, parts


# the morphological kernels (csrc/morph.cuh): kind codes and shared-memory
# bytes per window cell (MorphKind, morph_cell_bytes)
MORPH_KINDS = {"acwe": 0, "gac": 1, "gac_pre": 2, "acwe_sh": 4,
               "gac_pre_sh": 5}
MORPH_CELL_BYTES = {"acwe": 3, "gac": 11, "gac_pre": 11, "acwe_fused": 3,
                    "acwe_sh": 3, "gac_pre_sh": 11}


def _morph_geometry(kind, ls, aux, k, halo):
    _check_inputs(ls, aux, ("ls", "u0" if kind == "acwe_fused" else "aux"))
    h, w = ls.shape
    return (h, w, *tile_geometry(h, w, k, MORPH_CELL_BYTES[kind],
                                 span=2 * halo))


def launch_morph(kind: str, ls, aux, k: int, smoothing: int, parity0: int,
                 balloon: int, thr_b: float, halo: int, shard=None):
    """One K11 launch (csrc/morph_band.cu) of ``kind`` ('acwe', 'gac',
    'gac_pre'; 'acwe_sh', 'gac_pre_sh' with ``shard`` = (pt, pb, pcl, pcr,
    top, bottom, left, right) ints) on an (H, W) binary level set: k
    iterations with a ``halo``-cell window margin. Returns the new level
    set."""
    from .._build import library

    h, w, th, tw, cap = _morph_geometry(kind, ls, aux, k, halo)
    out = torch.empty_like(ls)
    lib = library()
    args = (ls.data_ptr(), aux.data_ptr(), out.data_ptr(), h, w,
            MORPH_KINDS[kind], k, smoothing, parity0, balloon, thr_b, halo,
            th, tw, cap)
    stream = torch.cuda.current_stream(ls.device).cuda_stream
    symbol = "cv_morph_chunk" if shard is None else "cv_morph_chunk_shard"
    err = getattr(lib, symbol)(*args, *(shard or ()), stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return out


def launch_morph_fused(ls, u0, cc, k: int, smoothing: int, parity0: int,
                       halo: int):
    """One K12 launch (csrc/morph_fused.cu): k MorphACWE iterations with
    the force from u0 and ``cc`` = (c_in, c_out, l1, l2) on the device.
    Returns (ls_new, partials (2,) f32: sum ls, sum u0 ls)."""
    from .._build import library

    h, w, th, tw, cap = _morph_geometry("acwe_fused", ls, u0, k, halo)
    out = torch.empty_like(ls)
    nblocks = math.ceil(h / th) * math.ceil(w / tw)
    block_parts = torch.empty((nblocks, 2), dtype=torch.float64,
                              device=ls.device)
    parts = torch.empty(2, dtype=torch.float32, device=ls.device)
    lib = library()
    err = lib.cv_morph_fused_chunk(
        ls.data_ptr(), u0.data_ptr(), cc.data_ptr(), out.data_ptr(),
        block_parts.data_ptr(), parts.data_ptr(), h, w, k, smoothing,
        parity0, halo, th, tw, cap,
        torch.cuda.current_stream(ls.device).cuda_stream)
    if err:
        raise RuntimeError(f"cv_morph_fused_chunk launch failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")
    return out, parts
