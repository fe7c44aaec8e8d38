"""Halo exchange on the card (K14). Counterpart of
``chan_vese_tpu/parallel/halo_rdma.py``.

:func:`exchange_halo2d_rdma` returns exactly what
:func:`.halo.exchange_halo2d` returns, bitwise, by another mechanism. The
reference has two stages: the rows, then the columns of the row-extended
blocks, so that the corners ride along. Each stage is a ring along one
grid axis. Shard i's hi strip goes into shard i + 1's leading halo and its
lo strip into shard i - 1's trailing halo, indices modulo the axis length.
At the global image edges the wrapped strips give way to replicas of the
shard's own edge row or column, as the reference overwrites them. An axis
of one shard is a self-ring: both of its halos are replicas. Together the
two stages are one clamped gather: shard (ix, iy) at global offset (r0,
c0), padded by D, holds u[..., clamp(r0 - D + i), clamp(c0 - D + j)].

On CUDA devices the exchange is one launch of ``csrc/halo_gather.cu`` on
each device that holds a shard (:func:`_gather`): each warp writes one
padded row from the grid row that owns its clamped global row, the
neighbours' strips and the replicas included. The launch geometry is
built once per grid and kept (:func:`_gather_plan`); a call allocates
each device's padded blocks as one buffer and fills only the base
pointers. Sources on another card are read through peer pointers over
NVLink; CUDA stream waits order the launch after each source's work and
the source's later work after the launch. On CPU devices the plain
version runs
(:func:`exchange_halo2d_rdma_reference`): strips moved by list rotation
(:func:`_ring_shift_reference`), replicas and ``torch.cat``. Launches are
counted in ``exchange_halo2d_rdma.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from array import array

import torch

from .halo import _check_depth

# shards of a grid the gather takes (csrc/halo_gather.cu kMaxShards)
_MAX_SHARDS = 64


def _rings(blocks, dim: int):
    """The grid's rings along ``dim`` (-2: the shards of a grid column,
    -1: of a grid row), each a list of (ix, iy) in ring order."""
    nx, ny = len(blocks), len(blocks[0])
    if dim == -2:
        return [[(ix, iy) for ix in range(nx)] for iy in range(ny)]
    return [[(ix, iy) for iy in range(ny)] for ix in range(nx)]


def _ring_shift_reference(los, his):
    """Plain version of the ring along one grid axis: (from_lo, from_hi),
    from_lo[i] = his[i - 1] and from_hi[i] = los[i + 1], indices modulo the
    ring's length, each on the receiving shard's device (the reference's
    ``_ring_exchange``: hi strip to the next shard's from_lo, lo strip to
    the previous shard's from_hi)."""
    from_lo = his[-1:] + his[:-1]
    from_hi = los[1:] + los[:1]
    return ([s.to(d.device) for s, d in zip(from_lo, his)],
            [s.to(d.device) for s, d in zip(from_hi, los)])


def _ring_pad_reference(blocks, depth: int, dim: int):
    """Plain version of one stage: every block extended by ``depth`` along
    ``dim`` with the ring's strips, replicas where the ring wraps."""
    out = [list(row) for row in blocks]
    for ring in _rings(blocks, dim):
        xs = [blocks[ix][iy] for ix, iy in ring]
        from_lo, from_hi = _ring_shift_reference(
            [x.narrow(dim, 0, depth) for x in xs],
            [x.narrow(dim, x.shape[dim] - depth, depth) for x in xs])
        last = len(ring) - 1
        for i, ((ix, iy), x) in enumerate(zip(ring, xs)):
            ext = list(x.shape)
            ext[dim] = depth
            before = x.narrow(dim, 0, 1).expand(ext) if i == 0 else from_lo[i]
            after = (x.narrow(dim, x.shape[dim] - 1, 1).expand(ext)
                     if i == last else from_hi[i])
            out[ix][iy] = torch.cat([before, x, after], dim=dim)
    return out


def exchange_halo2d_rdma_reference(blocks, depth: int = 4):
    """Plain version of :func:`exchange_halo2d_rdma`, on any device."""
    _check_depth(blocks, depth)
    return _ring_pad_reference(_ring_pad_reference(blocks, depth, -2),
                               depth, -1)


@functools.lru_cache(maxsize=None)
def _enable_peer(dev: int, peer: int):
    """Let device ``dev`` store into ``peer``'s memory (CUDA keeps it for
    the process, so once a pair)."""
    from .._build import library

    lib = library()
    err = lib.cv_halo_peer_access(dev, peer)
    if err:
        raise RuntimeError(f"peer access cuda:{dev} -> cuda:{peer} failed: "
                           f"{lib.cv_error_string(err).decode()} ({err})")


class _GatherGeo(ctypes.Structure):
    """csrc/halo_gather.cu's GatherGeo: one device's launch. Shards are
    numbered ix ny + iy; strides in elements."""
    _fields_ = [("src_slice", ctypes.c_longlong * _MAX_SHARDS),
                ("src_row", ctypes.c_int * _MAX_SHARDS),
                ("h", ctypes.c_int * _MAX_SHARDS),
                ("w", ctypes.c_int * _MAX_SHARDS),
                ("rows0", ctypes.c_int * (_MAX_SHARDS + 1)),
                ("dst", ctypes.c_int * _MAX_SHARDS),
                ("row0", ctypes.c_int * _MAX_SHARDS),
                ("nx", ctypes.c_int), ("ny", ctypes.c_int),
                ("ndst", ctypes.c_int), ("depth", ctypes.c_int),
                ("slices", ctypes.c_int), ("total", ctypes.c_int)]


def _key(xs, depth: int, nx: int, ny: int):
    """What a gather plan depends on: the depth, the grid and each block's
    shape, strides, device and dtype (``xs`` the blocks row by row)."""
    return (depth, nx, ny,
            tuple((x.shape, x.stride(), x.device, x.dtype) for x in xs))


def _flat_strides(shape, stride):
    """(slice stride, row stride) of a block whose leading dimensions fold
    into one with unit column stride, else None."""
    if shape[-1] > 1 and stride[-1] != 1:
        return None
    lead = [(n, s) for n, s in zip(shape[:-2], stride[:-2]) if n > 1]
    for (_, s), (n1, s1) in zip(lead, lead[1:]):
        if s != s1 * n1:
            return None
    return (lead[-1][1] if lead else 0), stride[-2]


class _Launch:
    """One device's part of a plan: its geometry (and its address), the
    shards it pads, the shape of its buffer, the padded blocks' shapes and
    offsets in it, in elements (uniform: one block a row of the buffer,
    taken with ``unbind``), and the other devices it reads."""

    def __init__(self, device, geo, dst, shapes, offsets, uniform, remote):
        self.device, self.geo, self.dst = device, geo, dst
        self.geo_addr = ctypes.addressof(geo)
        self.shapes, self.offsets, self.uniform = shapes, offsets, uniform
        self.buffer = ((len(dst), *shapes[0]) if uniform else
                       (offsets[-1] + math.prod(shapes[-1]),))
        self.remote = remote


class _Plan:
    def __init__(self, launches, copy, dtype, esize):
        self.launches, self.copy, self.dtype = launches, copy, dtype
        self.esize = esize


@functools.lru_cache(maxsize=64)
def _gather_plan(key):
    """The gather's launches for the grid ``key`` describes (:func:`_key`),
    or None where every block lies on the CPU (the plain version runs).
    Raises where the grid is not one the gather takes: a mix of CUDA and
    other devices, element sizes other than 4 and 8 bytes or mixed dtypes,
    more than ``_MAX_SHARDS`` shards, grid rows or columns of unequal
    extents or leading dimensions, a depth below 1 or above a shard's
    height or width."""
    depth, nx, ny, metas = key
    kinds = {dev.type for _, _, dev, _ in metas}
    if kinds == {"cpu"}:
        return None
    if kinds != {"cuda"}:
        raise ValueError(f"exchange_halo2d_rdma: blocks on {sorted(kinds)}; "
                         f"every shard must lie on a CUDA device, or every "
                         f"one on the CPU")
    dtypes = {dt for _, _, _, dt in metas}
    dtype = next(iter(dtypes))
    esize = torch.empty((), dtype=dtype).element_size()
    if len(dtypes) != 1 or esize not in (4, 8):
        raise TypeError("exchange_halo2d_rdma on CUDA takes blocks of one "
                        "dtype with 4- or 8-byte elements")
    if nx * ny > _MAX_SHARDS:
        raise ValueError(f"exchange_halo2d_rdma on CUDA takes at most "
                         f"{_MAX_SHARDS} shards, got {nx}x{ny}")
    shapes = [tuple(shape) for shape, _, _, _ in metas]
    lead = shapes[0][:-2]
    for s, shape in enumerate(shapes):
        ix, iy = divmod(s, ny)
        if (shape[:-2] != lead or shape[-2] != shapes[ix * ny][-2]
                or shape[-1] != shapes[iy][-1]):
            raise ValueError(f"exchange_halo2d_rdma: block ({ix}, {iy}) "
                             f"{shape} does not fit its grid row and column")
        if not 1 <= depth <= min(shape[-2:]):
            raise ValueError(f"halo depth {depth} must lie in 1.."
                             f"{min(shape[-2:])} for block ({ix}, {iy}) "
                             f"{shape}")
    slices = math.prod(lead)
    copy, strides = [], []
    for shape, stride, _, _ in metas:
        flat = _flat_strides(shape, stride)
        copy.append(flat is None)
        strides.append(flat if flat is not None else (
            shape[-2] * shape[-1], shape[-1]))
    rows0 = [0]
    for ix in range(nx):
        rows0.append(rows0[-1] + shapes[ix * ny][-2])
    launches = []
    for d in dict.fromkeys(dev for _, _, dev, _ in metas):
        geo = _GatherGeo(nx=nx, ny=ny, depth=depth, slices=slices)
        for s, (shape, (ss, sr)) in enumerate(zip(shapes, strides)):
            geo.src_slice[s], geo.src_row[s] = ss, sr
            geo.h[s], geo.w[s] = shape[-2], shape[-1]
        for ix, r in enumerate(rows0):
            geo.rows0[ix] = r
        dst, out_shapes, offsets, remote = [], [], [], set()
        rows = numel = 0
        for s, (_, _, dev, _) in enumerate(metas):
            if dev != d:
                continue
            ix, iy = divmod(s, ny)
            ph, pw = shapes[s][-2] + 2 * depth, shapes[s][-1] + 2 * depth
            geo.dst[len(dst)], geo.row0[len(dst)] = s, rows
            dst.append(s)
            out_shapes.append((*lead, ph, pw))
            offsets.append(numel)
            rows += slices * ph
            numel += slices * ph * pw
            remote |= {metas[jx * ny + jy][2]
                       for jx in range(max(ix - 1, 0), min(ix + 2, nx))
                       for jy in range(max(iy - 1, 0), min(iy + 2, ny))}
        geo.ndst, geo.total = len(dst), rows
        remote.discard(d)
        launches.append(_Launch(
            d, geo, dst, out_shapes, offsets,
            len(set(out_shapes)) == 1, sorted(remote, key=lambda e: e.index)))
    return _Plan(launches, copy, dtype, esize)


def _gather(xs, ny: int, plan: _Plan):
    """The exchange on CUDA devices of the grid whose blocks are ``xs``,
    row by row, ``ny`` a row: K14 launched once on each device that holds
    a shard, into that device's padded blocks (views of one buffer).
    Returns the grid of padded blocks."""
    from .._build import library

    if any(plan.copy):
        xs = [x.contiguous() if c else x for x, c in zip(xs, plan.copy)]
    src = [x.data_ptr() for x in xs]
    lib = library()
    es = plan.esize
    outs = [None] * len(xs)
    for lp in plan.launches:
        d = lp.device
        # the launch reads each source after the work queued on it
        for e in lp.remote:
            _enable_peer(d.index, e.index)
            torch.cuda.current_stream(d).wait_stream(
                torch.cuda.current_stream(e))
        buf = torch.empty(lp.buffer, dtype=plan.dtype, device=d)
        base = buf.data_ptr()
        ptrs = array("Q", src)
        ptrs.extend(base + off * es for off in lp.offsets)
        # the current stream's handle without a Stream object (a fifth of
        # the call's host time)
        err = lib.cv_halo_gather(lp.geo_addr, ptrs.buffer_info()[0], es,
                                 d.index,
                                 torch._C._cuda_getCurrentRawStream(d.index))
        if err:
            raise RuntimeError(f"cv_halo_gather launch failed: "
                               f"{lib.cv_error_string(err).decode()} ({err})")
        exchange_halo2d_rdma.launches += 1
        if lp.uniform:
            for s, o in zip(lp.dst, buf.unbind(0)):
                outs[s] = o
        else:
            for s, shape, off in zip(lp.dst, lp.shapes, lp.offsets):
                outs[s] = buf.narrow(0, off, math.prod(shape)).view(shape)
        # a source's memory and later writes wait for the launch's reads
        for e in lp.remote:
            stream = torch.cuda.current_stream(d)
            torch.cuda.current_stream(e).wait_stream(stream)
            for x in xs:
                if x.device == e:
                    x.record_stream(stream)
    return [outs[i:i + ny] for i in range(0, len(outs), ny)]


def exchange_halo2d_rdma(blocks, depth: int = 4):
    """Pad each (..., h, w) block of the grid to (..., h + 2 depth, w + 2
    depth) with halos: exactly :func:`.halo.exchange_halo2d` (and its
    batched form). CUDA blocks (every shard's device a CUDA device;
    elements of 4 or 8 bytes) launch K14 once a device. CPU blocks run the
    plain version. A mesh mixing the two raises."""
    ny = len(blocks[0])
    xs = [x for row in blocks for x in row]
    plan = _gather_plan(_key(xs, depth, len(blocks), ny))
    if plan is None:
        return exchange_halo2d_rdma_reference(blocks, depth)
    return _gather(xs, ny, plan)


exchange_halo2d_rdma.launches = 0
