"""Halo exchange by ring shifts written straight into the padded blocks
(K14). Counterpart of ``chan_vese_tpu/parallel/halo_rdma.py``.

:func:`exchange_halo2d_rdma` returns exactly what
:func:`.halo.exchange_halo2d` returns, bitwise, by another mechanism. It
has the reference's two stages: the rows, then the columns of the
row-extended blocks, so that the corners ride along. Each stage is a ring
along one grid axis. Shard i's hi strip goes into shard i + 1's leading
halo and its lo strip into shard i - 1's trailing halo, indices modulo the
axis length. At the global image edges the wrapped strips give way to
replicas of the shard's own edge row or column, as the reference
overwrites them. An axis of one shard is a self-ring: both of its halos
are replicas.

On CUDA devices each stage is one launch of ``csrc/halo_ring.cu`` a device
(:func:`_ring_shift`). The launch on a shard's device stores the shard
into the centre of its padded block and its strips into its neighbours'
padded blocks, which the wrapper allocates with ``torch.empty``. A
neighbour on another card receives the strips by peer stores over NVLink,
the counterpart of the TPU kernel's remote DMA. CUDA events order those
stores after the destination's allocation and the destination's later
work after them, as the reference's barrier semaphore does. On CPU devices
the plain version runs (:func:`exchange_halo2d_rdma_reference`): strips
moved by list rotation (:func:`_ring_shift_reference`), replicas and
``torch.cat``. Launches are counted in ``exchange_halo2d_rdma.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .halo import _check_depth

# tasks a launch takes (csrc/halo_ring.cu kMaxTasks): three a shard
_MAX_TASKS = 48


class _Task(ctypes.Structure):
    """csrc/halo_ring.cu's RingTask: rows x cols elements of each of
    ``batch`` slices from src to dst, strides in elements (src_row 0 or
    src_col 0: a row or column replica)."""
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("src_batch", ctypes.c_longlong),
                ("dst_batch", ctypes.c_longlong),
                ("src_row", ctypes.c_int), ("src_col", ctypes.c_int),
                ("dst_row", ctypes.c_int), ("rows", ctypes.c_int),
                ("cols", ctypes.c_int), ("batch", ctypes.c_int)]


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


def _slices(x):
    """x as an (N, h, w) view whose rows are contiguous (a copy where
    that needs one)."""
    x3 = x.reshape(-1, *x.shape[-2:])
    return x3 if x3.stride(-1) == 1 else x3.contiguous()


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


def _ring_tasks(xs, outs, depth: int, dim: int):
    """K14's tasks of one stage, by the launching (source) device. Per
    shard: its centre copy; its hi strip into the next shard's leading
    halo, or where the ring wraps its edge replica into its own trailing
    halo; its lo strip into the previous shard's trailing halo, or the
    replica into its own leading one. Each task is (the RingTask fields,
    the destination's grid position), from ``data_ptr`` and offsets in
    elements: no views are made, so the host's cost stays small."""
    row = dim == -2
    tasks = {}
    for ring in _rings(xs, dim):
        geo = []
        for ix, iy in ring:
            x, o = xs[ix][iy], outs[ix][iy]
            n, h, w = x.shape
            geo.append(dict(
                x=x.data_ptr(), xb=x.stride(0), xr=x.stride(1), n=n, h=h,
                w=w, o=o.data_ptr(), ob=o.shape[1] * o.shape[2],
                orow=o.shape[2], es=x.element_size(), dev=x.device,
                pos=(ix, iy)))
        for i, g in enumerate(geo):
            es, xr, orow = g["es"], g["xr"], g["orow"]
            ext = g["h"] if row else g["w"]           # cells along dim
            sx, so = (xr, orow) if row else (1, 1)    # elements a step
            rows, cols = (depth, g["w"]) if row else (g["h"], depth)
            rep = (0, 1) if row else (xr, 0)  # src_row 0 / src_col 0
            out = tasks.setdefault(g["dev"], [])
            out.append(((g["x"], g["o"] + depth * so * es, g["xb"], g["ob"],
                         xr, 1, orow, g["h"], g["w"], g["n"]), g["pos"]))
            if i + 1 < len(geo):
                nx = geo[i + 1]
                out.append(((g["x"] + (ext - depth) * sx * es, nx["o"],
                             g["xb"], nx["ob"], xr, 1, nx["orow"], rows, cols,
                             g["n"]), nx["pos"]))
            else:
                out.append(((g["x"] + (ext - 1) * sx * es,
                             g["o"] + (depth + ext) * so * es, g["xb"],
                             g["ob"], *rep, orow, rows, cols, g["n"]),
                            g["pos"]))
            if i > 0:
                pv = geo[i - 1]
                p_ext, p_so = ((pv["h"], pv["orow"]) if row
                               else (pv["w"], 1))
                out.append(((g["x"], pv["o"] + (depth + p_ext) * p_so * es,
                             g["xb"], pv["ob"], xr, 1, pv["orow"], rows, cols,
                             g["n"]), pv["pos"]))
            else:
                out.append(((g["x"], g["o"], g["xb"], g["ob"], *rep, orow,
                             rows, cols, g["n"]), g["pos"]))
    return tasks


def _ring_shift(blocks, depth: int, dim: int):
    """One stage on CUDA devices: K14 launched once on each device that
    holds a shard (a launch per 16 shards), every block extended by
    ``depth`` along ``dim``. Returns the grid of new blocks."""
    from .._build import library

    xs = [[_slices(x) for x in row] for row in blocks]
    outs = []
    for row in xs:
        out_row = []
        for x in row:
            ext = list(x.shape)
            ext[dim] += 2 * depth
            out_row.append(torch.empty(ext, dtype=x.dtype, device=x.device))
        outs.append(out_row)
    tasks = _ring_tasks(xs, outs, depth, dim)
    streams = {d: torch.cuda.current_stream(d) for d in tasks}
    # the barrier: a launch on d stores into e's buffers only after e's
    # stream has allocated them, and e's later work waits for the stores
    remote = {(d, outs[ix][iy].device) for d, ts in tasks.items()
              for _, (ix, iy) in ts if outs[ix][iy].device != d}
    for d, e in remote:
        _enable_peer(d.index, e.index)
        streams[d].wait_stream(torch.cuda.current_stream(e))
    lib = library()
    esize = xs[0][0].element_size()
    for d, ts in tasks.items():
        for k in range(0, len(ts), _MAX_TASKS):
            chunk = ts[k:k + _MAX_TASKS]
            arr = (_Task * len(chunk))(*(_Task(*t) for t, _ in chunk))
            with torch.cuda.device(d):
                err = lib.cv_halo_ring(ctypes.addressof(arr), len(chunk),
                                       esize, streams[d].cuda_stream)
            if err:
                raise RuntimeError(f"cv_halo_ring launch failed: "
                                   f"{lib.cv_error_string(err).decode()} "
                                   f"({err})")
            exchange_halo2d_rdma.launches += 1
    for d, e in remote:
        torch.cuda.current_stream(e).wait_stream(streams[d])
    for d, ts in tasks.items():
        for _, (ix, iy) in ts:
            if outs[ix][iy].device != d:
                outs[ix][iy].record_stream(streams[d])
    return [[o.reshape(*b.shape[:-2], *o.shape[-2:])
             for o, b in zip(orow, brow)] for orow, brow in zip(outs, blocks)]


def exchange_halo2d_rdma(blocks, depth: int = 4):
    """Pad each (..., h, w) block of the grid to (..., h + 2 depth, w + 2
    depth) with halos: exactly :func:`.halo.exchange_halo2d` (and its
    batched form), by ring shifts. CUDA blocks (every shard's device a
    CUDA device; elements of 4 or 8 bytes) launch K14, two stages a
    device; CPU blocks run the plain version. A mesh mixing the two
    raises."""
    _check_depth(blocks, depth)
    kinds = {x.device.type for row in blocks for x in row}
    if kinds == {"cpu"}:
        return exchange_halo2d_rdma_reference(blocks, depth)
    if kinds != {"cuda"}:
        raise ValueError(f"exchange_halo2d_rdma: blocks on {sorted(kinds)}; "
                         f"every shard must lie on a CUDA device, or every "
                         f"one on the CPU")
    sizes = {x.element_size() for row in blocks for x in row}
    if not sizes <= {4, 8} or len({x.dtype for row in blocks
                                   for x in row}) != 1:
        raise TypeError("exchange_halo2d_rdma on CUDA takes blocks of one "
                        "dtype with 4- or 8-byte elements")
    return _ring_shift(_ring_shift(blocks, depth, -2), depth, -1)


exchange_halo2d_rdma.launches = 0
