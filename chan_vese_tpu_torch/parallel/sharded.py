"""Spatially sharded Chan-Vese: one large image split over an (x, y) grid
mesh of shards, with halo exchange. Counterpart of
``chan_vese_tpu/parallel/sharded.py``: ``segment_sharded`` and
``segment_sharded_fixed_trace`` for the two-phase PDE, and
``segment_multiphase_sharded`` and
``segment_multiphase_sharded_fixed_trace`` for M coupled level sets, gray
and RGB.

One process drives every shard (a single controller, as ``shard_map`` on
one host): the shards are a list of rows of blocks, each on its mesh
device, and each step loops over them. Per iteration (``comm_k = 1``):

    exchange depth-4 halos of phi (rows, then columns: corners ride along)
    red half-sweep on each padded block, the replica rim refreshed at the
      global edges, black half-sweep; crop the block
    per-shard partial sums -> their sum in row-major shard order, in f64
      on the mesh's first device (the reference's psum) -> c1, c2, delta

``comm_k = k > 1`` exchanges a 4k-deep halo once per k frozen-means
iterations (the banded trajectory class; a remainder chunk ends the
run). With the kernels, each shard's step is one launch on its halo-padded
canvas: K1's shard mode per iteration, K2's (K5's for C channels, at
every comm_k) per chunk, K3's on parity planes with ``packed=True``, the
chunk state then staying on planes (one K15 pack before the loop, one K16
unpack after it, plane halos exchanged at half depth).

The multiphase solver computes the 2^M phase means from the shards' sums,
then sweeps the level sets in order, each on its depth-4 padded block with
every level set exchanged anew (phi_m's coupling term sees phi_{m-1}'s
update). ``comm_k = k > 1`` exchanges 8k-deep halos of every level set
once per k coupled iterations with the means frozen. With the kernels (M =
2, gray), each iteration is one launch of K9's shard mode per shard on its
canvas, k launches on one canvas a chunk, the means carried through the
kernel's partials.

Intended differences from the reference: results are gathered onto the
mesh's first device (the reference returns arrays sharded over the mesh);
the kernels' canvases are (h + 2D, w + 2D), rounded up to an even width,
without the reference's 128/256-lane pad (a TPU layout need), while the
routing predicates are evaluated on the lane-padded geometry, so that a
call takes the reference's route.

``reinit_every > 0`` (per-iteration routes only, as the reference) ends
every reinit_every-th iteration with a redistance of each shard: one
exchange of a ``reinit_steps``-deep halo (whatever ``halo`` says), the
redistance of the padded block (R1 on the card), the crop; the two-phase
solver then takes its means anew from the shards' sums, the multiphase
one from its next iteration's phase sums.

``halo`` picks the exchange of the level sets, with the reference's
routing and raises: 'ppermute' (:func:`.halo.exchange_halo2d`), 'rdma'
(:func:`.halo_rdma.exchange_halo2d_rdma`, K14's ring shifts on the card;
bitwise the same blocks) or 'overlap': each shard's interior swept from
its own cells while the exchange runs on a second CUDA stream, then the
rim recomputed from strips of the exchanged block (the plain route
bitwise the exchange-then-sweep one; with the kernels, K1's or K2's shard
mode as the interior, the reference's hybrid trajectory). The image's
one-time halos stay on the plain exchange, as in the reference.
"""

from __future__ import annotations

import contextlib
import math
from importlib import import_module
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import spans
from ..models.fused import (_delta_from_partials, _fold_scalar_lambdas,
                            segment_fused)
from ..models.multiphase import (MultiphaseResult, _coupling_term,
                                 init_multiphase, labels_from_phis)
from ..models.scalar import SegResult
from ..ops import (banded_kernel, fused_kernel, multiphase_kernel,
                   packed_kernel)
from ..ops.numerics import dirac, heaviside
from ..ops.reductions import (data_term, loop_continue, means_from_sums,
                              phase_means, phase_weights)
from ..ops.sweep import _update_all
from ..params import CVParams
from ..utils.init_phi import init_phi
from .data_parallel import _on
from .halo import exchange_halo2d, exchange_halo2d_batched
from .halo_rdma import exchange_halo2d_rdma
from .mesh import Mesh, gather_grid, grid_sharding, shard_grid

# ops.reinit the module (the ops package exports the function under its
# name), so that R1 is reached through one attribute by every caller
_reinit = import_module("..ops.reinit", __package__)

_D = 4  # halo depth of the per-iteration exchange


def _global_coords(shape, ix, iy, h, w, pad, device):
    """(g_i, g_j) int64 grids (broadcastable) of a block of ``shape``
    padded by ``pad`` on each side."""
    gi = torch.arange(shape[0], device=device)[:, None] + (ix * h - pad)
    gj = torch.arange(shape[1], device=device)[None, :] + (iy * w - pad)
    return gi, gj


# the sides of a padded block that may be canvas edges (top, bottom, left,
# right); a strip of the block holds only some of them
_ALL_EDGES = (True, True, True, True)


def _resync_replicas(pad, ix, iy, nx, ny, depth=_D, edges=_ALL_EDGES):
    """The padded block with its global-edge replica halos refreshed from
    the current edge cells, at full ``depth``, rows before columns, on the
    sides ``edges`` allows."""
    top, bottom, left, right = edges
    pad = pad.clone()
    if top and ix == 0:
        pad[:depth] = pad[depth]
    if bottom and ix == nx - 1:
        pad[-depth:] = pad[-depth - 1]
    if left and iy == 0:
        pad[:, :depth] = pad[:, depth:depth + 1]
    if right and iy == ny - 1:
        pad[:, -depth:] = pad[:, -depth - 1:-depth]
    return pad


def _local_checkerboard(shape, ix, iy, h, w, dtype, device, period=5.0):
    gi, gj = _global_coords(shape, ix, iy, h, w, 0, device)
    k = math.pi / period
    return torch.sin(gi.to(dtype) * k) * torch.sin(gj.to(dtype) * k)


def _sqrt(x):
    """The correctly rounded square root, as XLA's and CUDA's: torch's CPU
    kernel (Sleef's, within 0.5001 ulp) rounds about 1% of f64 cells the
    other way, so on the CPU numpy's takes it."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _local_circle(shape, ix, iy, h, w, H, W, dtype, device, r=None):
    gi, gj = _global_coords(shape, ix, iy, h, w, 0, device)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    r = min(H, W) / 4.0 if r is None else r
    gi, gj = gi.to(dtype), gj.to(dtype)
    return r - _sqrt((gi - cy) ** 2 + (gj - cx) ** 2)


def _local_rect(shape, ix, iy, h, w, H, W, dtype, device, margin=None):
    """Sharded mirror of utils/init_phi.rect (global-coordinate SDF)."""
    gi, gj = _global_coords(shape, ix, iy, h, w, 0, device)
    m = min(H, W) / 8.0 if margin is None else margin
    gi, gj = gi.to(dtype), gj.to(dtype)
    return torch.minimum(torch.minimum(gi - m, (H - 1 - m) - gi),
                         torch.minimum(gj - m, (W - 1 - m) - gj))


def _make_phi0(shape, kind, dtype, mesh: Mesh):
    """The start, built shard by shard on each shard's device from global
    coordinates: a grid of (H/nx, W/ny) blocks."""
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    H, W = shape
    h, w = H // nx, W // ny

    def local(ix, iy):
        dev = mesh.device(ix, iy)
        if kind == "checkerboard":
            v = _local_checkerboard((h, w), ix, iy, h, w, dtype, dev)
        elif kind in ("circle", "disk"):
            v = _local_circle((h, w), ix, iy, h, w, H, W, dtype, dev)
        elif kind in ("small disk", "small-disk"):
            v = _local_circle((h, w), ix, iy, h, w, H, W, dtype, dev,
                              r=min(H, W) / 8.0)
        elif kind == "rect":
            v = _local_rect((h, w), ix, iy, h, w, H, W, dtype, dev)
        else:
            raise ValueError(f"unsupported sharded init {kind!r}")
        return v.expand(h, w).contiguous()

    return [[local(ix, iy) for iy in range(ny)] for ix in range(nx)]


# the reference's routing predicates, on its lane-padded canvas geometry

def _canvas_cols(w: int, depth: int = _D) -> int:
    """The reference's lane-aligned canvas width for a (h+2d, w+2d) padded
    shard (routing only: the port's canvases are not lane-padded)."""
    return -(-(w + 2 * depth) // 128) * 128


def _pallas_ok(h: int, w: int) -> bool:
    return h % 8 == 0 and fused_kernel.supports(h + 2 * _D, _canvas_cols(w))


def _pallas_banded_ok(h: int, w: int, comm_k: int, channels: int = 0) -> bool:
    """Can the banded kernel run per shard inside comm_k-deep chunks?
    Remainder chunks run fewer iterations on the same canvas, and the
    predicates are monotone in k, so checking comm_k covers them."""
    D = 4 * comm_k
    hc, wc = h + 2 * D, _canvas_cols(w, D)
    if channels:
        return (h % 8 == 0
                and banded_kernel.supports_banded_mc(hc, wc, comm_k,
                                                     channels))
    return h % 8 == 0 and banded_kernel.supports_banded(hc, wc, comm_k)


def _packed_canvas_cols(w: int, depth: int) -> int:
    """The reference's 256-aligned canvas width of the packed shard kernel
    (routing only)."""
    return -(-(w + 2 * depth) // 256) * 256


def _packed_banded_shard_ok(h: int, w: int, comm_k: int) -> bool:
    """Can the packed banded kernel run per shard inside comm_k chunks?
    Even shards and the even depth D = 4 comm_k put every canvas origin on
    an even global cell: the packed shard kernel's static parity."""
    D = 4 * comm_k
    return (h % 2 == 0 and w % 2 == 0 and comm_k > 1
            and packed_kernel.supports_packed_banded(
                h + 2 * D, _packed_canvas_cols(w, D), comm_k))


# one shard's step ---------------------------------------------------------

def _sweep_local(pad, f, p, red, black, ix, iy, nx, ny, depth=_D,
                 edges=_ALL_EDGES):
    """Red and black half-sweeps on a padded block (or a strip of one), the
    replica halos refreshed in between."""
    upd = _update_all(pad, f, p.mu, p.dt, p.eps, p.eta2)
    pad = torch.where(red, upd, pad)
    pad = _resync_replicas(pad, ix, iy, nx, ny, depth, edges)
    upd = _update_all(pad, f, p.mu, p.dt, p.eps, p.eta2)
    return torch.where(black, upd, pad)


def _chunk_iterate(pad, f, p, red, black, pos, nx, ny, depth, k,
                   edges=_ALL_EDGES):
    """k chunk iterations on a depth-padded block or a strip of one: the
    replicas refreshed from the current edge cells before every iteration
    but the first (whose exchange or edge pad built them: the reference's
    refresh there is a no-op), then the red and black half-sweeps. Returns
    (final, the state before the last iteration)."""
    cur = prev = pad
    for it in range(k):
        prev = cur
        if it:
            cur = _resync_replicas(cur, *pos, nx, ny, depth, edges)
        cur = _sweep_local(cur, f, p, red, black, *pos, nx, ny, depth, edges)
    return cur, prev


def _edge_pad(x, depth: int):
    """(..., h, w) -> (..., h + 2 depth, w + 2 depth) padded with replicas
    of x's own edge rows and columns (the reference's ``jnp.pad(mode=
    'edge')``): a block with no neighbour's data."""
    h, w = x.shape[-2:]
    rows = torch.arange(-depth, h + depth, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-depth, w + depth, device=x.device).clamp(0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def _partials(new, prev, u0_loc, eps):
    """[s_uH (per channel for an (h, w, C) block), s_H, s_dphi2, flips,
    s_absdphi] of a shard's transition prev -> new."""
    h_eps = heaviside(new, eps)
    d = new - prev
    flips = ((new >= 0) != (prev >= 0)).to(new.dtype)
    if u0_loc.ndim == 3:
        s_uh = torch.sum(u0_loc * h_eps[..., None], dim=(0, 1))
    else:
        s_uh = torch.sum(u0_loc * h_eps)[None]
    return torch.cat([s_uh, torch.stack([
        torch.sum(h_eps), torch.sum(d * d), torch.sum(flips),
        torch.sum(torch.abs(d))])])


def _jnp_chunk(sh, pad, u0_pad, c1, c2, k, pos, depth):
    """k frozen-means iterations of one padded block on the plain path
    (the reference's jnp route; k = 1 is its per-iteration step). Returns
    (new, prev) of the block's own cells."""
    p, lambdas, nx, ny = sh.p, sh.lambdas, sh.nx, sh.ny
    red, black = sh.lattice(pos, pad.shape, depth, pad.device)
    if lambdas is None:
        f = data_term(u0_pad, c1, c2, p.nu, p.lambda1, p.lambda2)
    else:
        f = data_term(u0_pad, c1, c2, p.nu, *lambdas)
    pad, prev = _chunk_iterate(pad, f, p, red, black, pos, nx, ny, depth, k)
    crop = (slice(depth, depth + sh.h), slice(depth, depth + sh.w))
    return pad[crop], prev[crop]


def _even_cols(x):
    """x with one edge-replicated column more where its width is odd (the
    kernels' canvases have an even width)."""
    return torch.cat([x, x[..., -1:]], dim=-1) if x.shape[-1] % 2 else x


def _fix_edge_replicas_planes(planes, edges, crop_p):
    """Restore the flat clamped-replica convention at the global edges of
    a freshly plane-exchanged canvas, depth 2 (all the kernels read): the
    exchange replicates each plane's own edge, the flat convention wants
    the global edge row/column, so canvas rows r0-1 and r0-2 (plane row
    r0p - 1 of both row planes) take edge row r0 (plane a = 0), and so on.
    crop_p = the plane-coordinate crop (r0p, r1p, c0p, c1p)."""
    r0p, r1p, c0p, c1p = crop_p
    top, bottom, left, right = edges
    planes = planes.clone()
    if top:
        planes[:, :, r0p - 1, :] = planes[0:1, :, r0p, :]
    if bottom:
        planes[:, :, r1p, :] = planes[1:2, :, r1p - 1, :]
    if left:
        planes[:, :, :, c0p - 1] = planes[:, 0:1, :, c0p]
    if right:
        planes[:, :, :, c1p] = planes[:, 1:2, :, c1p - 1]
    return planes


class _Grid:
    """A sharded run's grid of shards: the mesh, the image's blocks, and
    each shard's lattice parity and global-edge flags; ``_each`` runs a
    function on every shard and ``psum`` sums their partials."""

    def __init__(self, u0, p: CVParams, mesh: Mesh):
        self.p, self.mesh = p, mesh
        self.nx, self.ny = mesh.shape["x"], mesh.shape["y"]
        self.first = mesh.devices[0]
        self.vec = u0.ndim == 3
        self.nchan = u0.shape[2] if self.vec else 1
        self.u0 = shard_grid(u0, grid_sharding(mesh))
        self.h, self.w = self.u0[0][0].shape[:2]
        self.dtype = u0.dtype
        self.n_pix = torch.tensor(self.nx * self.h * self.ny * self.w,
                                  dtype=u0.dtype, device=self.first)

    def positions(self):
        return [(ix, iy) for ix in range(self.nx) for iy in range(self.ny)]

    def _each(self, fn, *grids):
        """fn(pos, *blocks) for every shard in row-major order, each in
        its device's context."""
        out = []
        for ix, iy in self.positions():
            with _on(self.mesh.device(ix, iy)):
                out.append(fn((ix, iy), *(g[ix][iy] for g in grids)))
        return out

    def gather(self, blocks):
        """The blocks' image on the mesh's first device."""
        return gather_grid(blocks, self.mesh)

    def grid(self, flat):
        return [flat[ix * self.ny:(ix + 1) * self.ny] for ix in range(self.nx)]

    def psum(self, parts):
        """The per-shard partials summed in row-major shard order, in f64
        on the first device, returned in the image's dtype."""
        acc = parts[0].to(self.first, torch.float64)
        for q in parts[1:]:
            acc = acc + q.to(self.first, torch.float64)
        return acc.to(self.dtype)

    def parity(self, pos):
        return (pos[0] * self.h + pos[1] * self.w) % 2

    def edges(self, pos):
        ix, iy = pos
        return (ix == 0, ix == self.nx - 1, iy == 0, iy == self.ny - 1)

    def crop(self, depth: int):
        """A padded block's own cells (r0, r1, c0, c1)."""
        return (depth, depth + self.h, depth, depth + self.w)

    def lattice(self, pos, shape, depth: int, device):
        """(red, black) masks of a block padded by ``depth``: the global
        red-black lattice on cells inside the image, neither outside."""
        ix, iy = pos
        gi, gj = _global_coords(shape, ix, iy, self.h, self.w, depth, device)
        valid = ((gi >= 0) & (gi < self.nx * self.h) & (gj >= 0)
                 & (gj < self.ny * self.w))
        odd = (gi + gj) % 2 == 1
        return ~odd & valid, odd & valid

    def cfirst(self):
        """The image blocks, channels-first for C channels."""
        if not self.vec:
            return self.u0
        return [[u.permute(2, 0, 1).contiguous() for u in row]
                for row in self.u0]


class _Shards(_Grid):
    """The state of a two-phase sharded run that its routes share: the
    grid, the start and the sums behind the means."""

    def __init__(self, u0, p: CVParams, mesh: Mesh, lambdas, phi0):
        super().__init__(u0, p, mesh)
        self.lambdas = lambdas
        self.phi0 = (_make_phi0(u0.shape[:2], p.init, u0.dtype, mesh)
                     if phi0 is None else shard_grid(phi0,
                                                     grid_sharding(mesh)))
        c = self.nchan
        self.sum_u = self.psum(self._each(
            lambda pos, u: torch.sum(u, dim=(0, 1)).reshape(c), self.u0))
        self.c1, self.c2 = self.means_of(self.phi0)

    def means_of(self, phi):
        """The means of a state: the smooth-Heaviside sums, summed over
        the shards."""
        return self.means(self.psum(self._each(lambda pos, u, ph: _partials(
            ph, ph, u, self.p.eps), self.u0, phi)))

    def means(self, parts):
        c = self.nchan
        s_uh = parts[:c] if self.vec else parts[0]
        s_u = self.sum_u if self.vec else self.sum_u[0]
        return means_from_sums(s_uh, parts[c], s_u, self.n_pix)

    def delta(self, parts):
        return _delta_from_partials(parts, self.n_pix, self.p,
                                    self.nchan - 1)


def _channels_last(pad):
    return pad.permute(1, 2, 0) if pad.ndim == 3 else pad


def _exchange(blocks, depth: int, halo: str):
    """The halo exchange by mechanism name (the reference's ``_exchange``):
    K14's ring shifts for 'rdma', else :func:`.halo.exchange_halo2d`.
    Blocks may carry leading dimensions (a stack of level sets)."""
    if halo == "rdma":
        return exchange_halo2d_rdma(blocks, depth)
    return exchange_halo2d(blocks, depth)


def _side_streams(halo: str, mesh: Mesh):
    """A second stream on each CUDA device of the mesh for the overlap
    route's exchange (none on CPU devices or for the other mechanisms)."""
    if halo != "overlap":
        return {}
    return {d: torch.cuda.Stream(d) for d in dict.fromkeys(mesh.devices)
            if d.type == "cuda"}


def _overlapped(streams, blocks, depth: int, interior):
    """(exchange_halo2d(blocks, depth), interior()): the exchange queued on
    each device's side stream while ``interior`` (the shards' launches from
    their own cells) runs on the current streams, the counterpart of XLA's
    async collective-permute under the reference's overlap route. The
    current streams wait for the exchange before returning, so the stitch
    that follows reads finished halos. On CPU devices the two run in turn.
    """
    if not streams:
        return exchange_halo2d(blocks, depth), interior()
    for dev, side in streams.items():
        side.wait_stream(torch.cuda.current_stream(dev))
    with contextlib.ExitStack() as stack:
        for side in streams.values():
            stack.enter_context(torch.cuda.stream(side))
        pad = exchange_halo2d(blocks, depth)
    for row in blocks:
        for b in row:  # read on the side stream
            b.record_stream(streams[b.device])
    out = interior()
    for dev, side in streams.items():
        torch.cuda.current_stream(dev).wait_stream(side)
    for row in pad:
        for b in row:  # made on the side stream, read on the current one
            b.record_stream(torch.cuda.current_stream(b.device))
    return pad, out


def _overlap_stitch(g, pos, xs, pad, force, masks, depth: int, strip: int,
                    k: int):
    """The rim of interior-only results ``xs`` (the final state and, where
    given, the state before the last iteration) overwritten from four
    strips of the exchanged ``pad`` swept k chunk iterations, their replica
    refresh restricted to the canvas edges each strip holds: the
    reference's ``_overlap_stitch`` (depth 4, 16-cell strips) and the
    stitch of ``_sharded_chunk_overlap`` (depth 4k, 3 depth strips). The
    rim is the composite stencil's reach, ``depth`` rows and columns
    top/left, depth/2 bottom/right. ``force(window)`` is the data term on
    a window of the padded block; ``masks`` its (red, black)."""
    p, D, S, h, w = g.p, depth, strip, g.h, g.w
    ph, pw = h + 2 * D, w + 2 * D
    red, black = masks

    def run(rs, re, cs, ce, edges):
        win = (slice(rs, re), slice(cs, ce))
        return _chunk_iterate(pad[win], force(win), p, red[win], black[win],
                              pos, g.nx, g.ny, D, k, edges)

    n_s = run(0, S, 0, pw, (True, False, True, True))
    s_s = run(ph - S, ph, 0, pw, (False, True, True, True))
    w_s = run(0, ph, 0, S, (True, True, True, False))
    e_s = run(0, ph, pw - S, pw, (True, True, False, True))
    tw, bw = D, D // 2
    out = []
    for i, x in enumerate(xs):
        x = x.clone()
        x[0:tw, :] = n_s[i][D:D + tw, D:D + w]
        x[h - bw:h, :] = s_s[i][S - D - bw:S - D, D:D + w]
        x[:, 0:tw] = w_s[i][D:D + h, D:D + tw]
        x[:, w - bw:w] = e_s[i][D:D + h, S - D - bw:S - D]
        out.append(x)
    return out


# rim strips of the per-iteration overlap route: 16 canvas rows/columns
_STRIP = 16


class _Step:
    """One route's step over every shard: ``run(phi, c1, c2, size)``
    returns (phi blocks, partials summed over the shards). ``halo`` names
    the exchange: 'ppermute' (:func:`.halo.exchange_halo2d`), 'rdma' (K14)
    or 'overlap' (the interior from each shard's own cells while the
    exchange runs on a second stream, then the rim stitched)."""

    def __init__(self, sh: _Shards, use_pallas: bool, depth: int,
                 packed: bool, chunked: bool, halo: str):
        self.sh, self.use_pallas, self.D = sh, use_pallas, depth
        self.packed, self.chunked, self.halo = packed, chunked, halo
        u0_pad = exchange_halo2d_batched(sh.cfirst(), depth)
        if packed:
            # the image canvas on parity planes, packed once (K15)
            self.u0 = [[packed_kernel.pack_planes(u) for u in row]
                       for row in u0_pad]
        elif use_pallas:
            self.u0 = [[_even_cols(u) for u in row] for row in u0_pad]
        else:
            self.u0 = [[_channels_last(u) for u in row] for row in u0_pad]
        self.streams = _side_streams(halo, sh.mesh)
        if halo == "overlap":  # the padded blocks' lattices, for the strips
            shape = (sh.h + 2 * depth, sh.w + 2 * depth)
            self.masks = {pos: sh.lattice(pos, shape, depth,
                                          sh.mesh.device(*pos))
                          for pos in sh.positions()}

    def _launch(self, pos, canvas, u0c, c1, c2, size):
        """The shard's kernel on its canvas: (new canvas, partials)."""
        sh, D = self.sh, self.D
        crop = sh.crop(D)
        parity, edges = sh.parity(pos), sh.edges(pos)
        if sh.vec:
            l1, l2 = sh.lambdas
            new, parts = banded_kernel.banded_chunk_mc_sharded(
                canvas, u0c, c1, c2, sh.p, size, parity, edges, crop,
                unroll=4 if size % 4 == 0 else 1, lambda1=l1, lambda2=l2)
        elif self.chunked:
            new, parts = banded_kernel.banded_chunk_sharded(
                canvas, u0c, c1, c2, sh.p, size, parity, edges, crop,
                unroll=4 if size % 4 == 0 else 1)
        else:
            new, parts = fused_kernel.fused_iteration(
                canvas, u0c, c1, c2, sh.p, parity=parity, crop=crop,
                edges=edges)
        return new, parts[:sh.nchan + 4]

    def _packed(self, pos, pad, u0c, c1, c2, size):
        sh, D = self.sh, self.D
        crop = sh.crop(D)
        crop_p = tuple(c // 2 for c in crop)
        edges = sh.edges(pos)
        canvas = _fix_edge_replicas_planes(pad, edges, crop_p)
        new, parts = packed_kernel.packed_banded_chunk_sharded(
            canvas, u0c, c1, c2, sh.p, size, edges, crop)
        return new[:, :, crop_p[0]:crop_p[1], crop_p[2]:crop_p[3]], parts[:5]

    def run(self, phi, c1, c2, size):
        if self.halo == "overlap":
            return self._run_overlap(phi, c1, c2, size)
        sh, D = self.sh, self.D
        pad = (exchange_halo2d_batched(phi, D // 2) if self.packed
               else _exchange(phi, D, self.halo))

        def one(pos, pad, u0c):
            dev = pad.device
            a, b = c1.to(dev), c2.to(dev)
            if self.packed:
                return self._packed(pos, pad, u0c, a, b, size)
            if self.use_pallas:
                new, parts = self._launch(pos, _even_cols(pad), u0c, a, b,
                                          size)
                return new[D:D + sh.h, D:D + sh.w], parts
            new, prev = _jnp_chunk(sh, pad, u0c, a, b, size, pos, D)
            u0_loc = u0c[D:D + sh.h, D:D + sh.w]
            return new, _partials(new, prev, u0_loc, sh.p.eps)

        outs = sh._each(one, pad, self.u0)
        return (sh.grid([o[0] for o in outs]),
                sh.psum([o[1] for o in outs]))

    def _interior(self, pos, phi, u0c, c1, c2, size):
        """The overlap route's interior: ``size`` iterations of the shard
        from its block edge-padded with its own cells, so independent of
        the exchange in flight (the reference's ``_overlap_new``,
        ``_overlap_pallas_new`` and the interior of
        ``_sharded_chunk_overlap``). K1's shard mode per iteration, K2's in
        chunks, where ``size`` splits into (size - 1) + 1 launches for the
        state before the last iteration; else the plain chunk. Returns
        (final, state before the last iteration) of the shard's cells,
        whose rim the stitch replaces."""
        sh, D = self.sh, self.D
        crop = (slice(D, D + sh.h), slice(D, D + sh.w))
        local = _edge_pad(phi, D)
        if not self.use_pallas:
            f = data_term(u0c, c1, c2, sh.p.nu, sh.p.lambda1, sh.p.lambda2)
            red, black = self.masks[pos]
            new, prev = _chunk_iterate(local, f, sh.p, red, black, pos,
                                       sh.nx, sh.ny, D, size)
            return new[crop], prev[crop]
        canvas = _even_cols(local)
        if not self.chunked:
            return self._launch(pos, canvas, u0c, c1, c2, 1)[0][crop], phi
        prev = (self._launch(pos, canvas, u0c, c1, c2, size - 1)[0]
                if size > 1 else canvas)
        new = self._launch(pos, prev, u0c, c1, c2, 1)[0]
        return new[crop], prev[crop]

    def _run_overlap(self, phi, c1, c2, size):
        """The overlap route's step (gray): the interiors on the current
        streams while the exchange runs on the side streams, then each
        shard's rim stitched from strips of its exchanged block and the
        partials taken from the stitched (new, prev), as the reference."""
        sh, D, p = self.sh, self.D, self.sh.p
        strip = 3 * D if self.chunked else _STRIP

        def means(dev):
            return c1.to(dev), c2.to(dev)

        pad, inner = _overlapped(self.streams, phi, D, lambda: sh._each(
            lambda pos, ph, u0c: self._interior(pos, ph, u0c,
                                                *means(ph.device), size),
            phi, self.u0))

        def one(pos, pd, u0c, xs):
            a, b = means(pd.device)
            u0_pad = u0c[:, :sh.w + 2 * D]  # the kernels' canvas is even

            def force(win):
                return data_term(u0_pad[win], a, b, p.nu, p.lambda1,
                                 p.lambda2)

            new, prev = _overlap_stitch(sh, pos, xs, pd, force,
                                        self.masks[pos], D, strip, size)
            u0_loc = u0_pad[D:D + sh.h, D:D + sh.w]
            return new, _partials(new, prev, u0_loc, p.eps)

        outs = sh._each(one, pad, self.u0, sh.grid(inner))
        return (sh.grid([o[0] for o in outs]),
                sh.psum([o[1] for o in outs]))


def _energy(sh: _Shards, phi, c1, c2):
    """The Chan-Vese energy of the sharded level set, summed over the
    shards: forward differences read the south/east neighbour through a
    1-deep halo, whose global-edge replicas make the clamped difference
    vanish at the image boundary, as ``ops.reductions.energy``."""
    p = sh.p
    pad1 = exchange_halo2d(phi, 1)

    def local(pos, pad, new, u0_loc):
        dev = new.device
        a, b = c1.to(dev), c2.to(dev)
        ph = pad[1:-1, 1:-1]
        gx = pad[2:, 1:-1] - ph
        gy = pad[1:-1, 2:] - ph
        h = heaviside(new, p.eps)
        length = torch.sum(dirac(new, p.eps) * torch.sqrt(gx * gx + gy * gy))
        area = torch.sum(h)
        if sh.vec:
            l1, l2 = (torch.as_tensor(v, dtype=new.dtype, device=dev)
                      for v in sh.lambdas)
            fit1 = torch.sum(torch.mean(l1 * (u0_loc - a) ** 2, dim=-1) * h)
            fit2 = torch.sum(torch.mean(l2 * (u0_loc - b) ** 2, dim=-1)
                             * (1.0 - h))
            return (p.mu * length + p.nu * area + fit1 + fit2)[None]
        fit1 = torch.sum((u0_loc - a) ** 2 * h)
        fit2 = torch.sum((u0_loc - b) ** 2 * (1.0 - h))
        return (p.mu * length + p.nu * area + p.lambda1 * fit1
                + p.lambda2 * fit2)[None]

    return sh.psum(sh._each(local, pad1, phi, sh.u0))[0]


def _drive(g: _Grid, max_iter, fixed, comm_k, chunked, advance):
    """The stopping rule of every sharded route: ``advance(size)`` runs
    ``size`` iterations and returns their delta (a tensor on the first
    device). Chunked: full comm_k chunks, then one remainder chunk, so the
    cap is exact; else one iteration at a time. Tolerance mode reads delta
    once a chunk (an iteration); fixed mode reads nothing. Returns (iters,
    delta)."""
    p = g.p
    n, streak = 0, 0
    delta = torch.tensor(math.inf, dtype=g.dtype, device=g.first)
    delta_f = math.inf

    def run(size):
        nonlocal n, streak, delta, delta_f
        delta = advance(size)
        if not fixed:  # one read of delta a chunk (an iteration)
            delta_f = delta.item()
            below = torch.tensor(delta_f, dtype=g.dtype) < p.tol
            # a below-tol chunk credits its full size: patience stays
            # iteration-denominated across drivers
            streak = streak + size if bool(below) else 0
        n += size

    def not_stopped():
        done = streak >= p.patience and n >= p.min_iter
        return not (done or (n > 0 and not math.isfinite(delta_f)))

    if chunked:
        full = (max_iter // comm_k) * comm_k
        while n < full and (fixed or not_stopped()):
            run(comm_k)
        rem = max_iter - full
        if rem and n < max_iter and (fixed or not_stopped()):
            run(rem)
    else:
        while (n < max_iter) if fixed else loop_continue(
                n, delta_f, streak, p, max_iter):
            run(1)
    return n, delta


def _sharded_reinit(g: _Grid, blocks, n: int):
    """The reinit cadence on a grid of (h, w) blocks or (M, h, w) stacks:
    after iteration ``n``, every p.reinit_every-th, one exchange of a
    ``reinit_steps``-deep halo, the redistance of each padded block (each
    level set on its own) and the crop: the redistance propagates a cell
    a step, so the crop sees no edge of the pad. Returns the blocks, or
    None where the cadence does not fire."""
    p = g.p
    if not _reinit.reinit_fires(n, p):
        return None
    D = p.reinit_steps
    return g.grid(g._each(
        lambda pos, pad: _reinit.reinit(pad, D)[..., D:D + g.h, D:D + g.w],
        exchange_halo2d(blocks, D)))


def _run_sharded(sh: _Shards, max_iter, fixed, use_pallas, comm_k, packed,
                 halo):
    """The solver over the shards: (phi blocks, c1, c2, iters, delta)."""
    chunked = comm_k > 1 or (sh.vec and use_pallas)
    step = _Step(sh, use_pallas, 4 * comm_k if chunked else _D, packed,
                 chunked, halo)
    phi = sh.phi0
    if packed:
        phi = [[packed_kernel.pack_planes(b) for b in row] for row in phi]
    c1, c2 = sh.c1, sh.c2
    n = 0

    def advance(size):
        nonlocal phi, c1, c2, n
        phi, parts = step.run(phi, c1, c2, size)
        c1, c2 = sh.means(parts)
        redistanced = _sharded_reinit(sh, phi, n)
        if redistanced is not None:  # comm_k = 1 here: size is 1
            phi = redistanced
            c1, c2 = sh.means_of(phi)
        n += size
        return sh.delta(parts)

    n, delta = _drive(sh, max_iter, fixed, comm_k, chunked, advance)
    if packed:  # one unpack (K16) a shard
        phi = [[packed_kernel.unpack_planes(b) for b in row] for row in phi]
    return phi, c1, c2, n, delta


def _on_mesh(x, mesh: Mesh):
    """An input moved to the mesh's first device (as a tensor)."""
    return torch.as_tensor(x).to(mesh.devices[0])


def segment_sharded(u0, p: CVParams = CVParams(), mesh: Optional[Mesh] = None,
                    phi0: Optional[torch.Tensor] = None,
                    max_iter: Optional[int] = None, fixed: bool = False,
                    use_pallas: Optional[bool] = None,
                    lambda1=None, lambda2=None,
                    halo: str = "ppermute",
                    comm_k: int = 1,
                    packed: Optional[bool] = None) -> SegResult:
    """Segment one large image sharded over a 2-D ('x', 'y') grid mesh.

    u0: (H, W) grayscale or (H, W, C) vector-valued (per-channel
    lambda1/lambda2 tuples supported), with H % nx == 0 and W % ny == 0.
    Tolerance mode by default; ``fixed=True`` runs exactly ``max_iter``
    (or p.max_iter) iterations and reads nothing back to the host;
    tolerance mode reads delta once a chunk (once an iteration at
    comm_k = 1). Returns a SegResult whose phi and mask are gathered onto
    the mesh's first device.

    comm_k: one 4k-deep halo exchange per comm_k frozen-means iterations
    (the banded trajectory class), with convergence checked per chunk.
    use_pallas: None takes the kernels when every mesh device is a CUDA
    device and the reference's predicate holds for the shard (K1's shard
    mode per iteration for a gray image, K2's per chunk at comm_k > 1,
    K5's for C channels at every comm_k); True on CPU devices runs the
    kernels' plain versions through the same drivers (the reference's
    ``interpret=True``). packed=True runs the gray chunks on parity planes
    (K3's shard mode; even shards, comm_k > 1). A 1x1 mesh on the
    per-iteration kernel route runs :func:`..models.fused.segment_fused`,
    as the reference does. halo: 'ppermute', 'rdma' (K14) or 'overlap'
    (module docstring; gray only, shards of at least 16x16, packed only
    with 'ppermute').
    """
    if mesh is None:
        raise ValueError("segment_sharded needs a mesh "
                         "(parallel.mesh.make_grid_mesh)")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    H, W = u0.shape[:2]
    if H % nx or W % ny:
        raise ValueError(f"image {tuple(u0.shape)} not divisible by mesh "
                         f"({nx}, {ny})")
    cap = max_iter if max_iter is not None else p.max_iter
    if halo not in ("ppermute", "rdma", "overlap"):
        raise ValueError(f"unknown halo mechanism {halo!r}")
    if halo == "overlap" and min(H // nx, W // ny) < 16:
        raise ValueError("halo='overlap' needs shards of at least 16x16 "
                         "(the rim strips span 16 canvas rows/cols)")
    if comm_k < 1:
        raise ValueError("comm_k must be >= 1")
    if comm_k > 1:
        if p.reinit_every:
            raise ValueError(
                "comm_k > 1 supports no reinit cadence (frozen-means "
                "chunks have no per-iteration boundary to hang it on)")
        if halo == "overlap" and u0.ndim == 3:
            raise ValueError("overlap x comm_k supports grayscale only")
        if 4 * comm_k > min(H // nx, W // ny):
            raise ValueError(
                f"comm_k={comm_k} needs 4*comm_k-deep halos, larger than "
                f"the shard ({H // nx}, {W // ny})")
    vec = u0.ndim == 3
    if vec:
        if halo != "ppermute":
            raise ValueError(f"halo={halo!r} supports grayscale images only")
        lambdas = p.channel_lambdas(u0.shape[-1], lambda1, lambda2)
    else:
        p = _fold_scalar_lambdas(p, lambda1, lambda2)
        lambdas = None
    if p.reinit_every and p.reinit_steps > min(H // nx, W // ny):
        raise ValueError(
            f"reinit_steps={p.reinit_steps} exceeds the shard size "
            f"({H // nx}, {W // ny}); the halo-aware redistance exchanges a "
            f"depth-reinit_steps halo from immediate neighbors only - lower "
            f"reinit_steps or use a coarser mesh")
    on_cuda = all(d.type == "cuda" for d in mesh.devices)
    if comm_k > 1 or vec:
        ch = u0.shape[-1] if vec else 0
        ok = _pallas_banded_ok(H // nx, W // ny, comm_k, ch) and not (
            vec and (p.reinit_every or comm_k == 1 and halo != "ppermute"))
        if use_pallas is None:
            use_pallas = on_cuda and ok
        elif use_pallas and not ok:
            raise ValueError(
                f"banded pallas path unsupported for shard "
                f"({tuple(u0.shape)}, mesh ({nx}, {ny}), comm_k={comm_k})")
    elif use_pallas is None:
        use_pallas = on_cuda and _pallas_ok(H // nx, W // ny)
    elif use_pallas and not _pallas_ok(H // nx, W // ny):
        raise ValueError(f"pallas path unsupported for shard "
                         f"({tuple(u0.shape)}, mesh ({nx}, {ny}))")
    packed_ok = (not vec and comm_k > 1 and bool(use_pallas)
                 and halo == "ppermute"
                 and _packed_banded_shard_ok(H // nx, W // ny, comm_k))
    if packed is None:
        packed = False
    elif packed and not packed_ok:
        raise ValueError(
            f"packed sharded banded path unsupported for shard "
            f"({tuple(u0.shape)}, mesh ({nx}, {ny}), comm_k={comm_k}, "
            f"halo={halo!r}, use_pallas={use_pallas})")
    u0 = _on_mesh(u0, mesh)
    if phi0 is not None:
        phi0 = _on_mesh(phi0, mesh)
    if nx == 1 and ny == 1 and not vec and use_pallas and comm_k == 1:
        # a 1x1 mesh: the shard is the image, so the canvas machinery is
        # pure tax; the single-image fused driver runs the same math
        if phi0 is None:
            phi0 = init_phi((H, W), p.init, u0.dtype, device=u0.device)
        return segment_fused(u0, p, phi0=phi0, fixed=fixed, max_iter=cap)

    sh = _Shards(u0, p, mesh, lambdas, phi0)
    phi, c1, c2, iters, delta = _run_sharded(sh, cap, fixed,
                                             bool(use_pallas), comm_k,
                                             bool(packed), halo)
    phi = gather_grid(phi, mesh)
    return SegResult(phi, phi >= 0, iters, delta, c1, c2)


class ShardedTrace(NamedTuple):
    phi: torch.Tensor
    mask: torch.Tensor
    energy: torch.Tensor   # (iters,)
    delta: torch.Tensor    # (iters,)
    c1: torch.Tensor       # (iters[, C])
    c2: torch.Tensor


def segment_sharded_fixed_trace(u0, p: CVParams = CVParams(),
                                mesh: Optional[Mesh] = None,
                                iters: int = 100,
                                phi0: Optional[torch.Tensor] = None,
                                use_pallas: Optional[bool] = None,
                                lambda1=None, lambda2=None,
                                halo: str = "ppermute") -> ShardedTrace:
    """Fixed-iteration sharded run with per-iteration energy, delta and
    means traces (the parity artifact of BASELINE.json:5, computed from
    the shards' sums without a gather): the energy after each sweep, with
    means from the post-sweep phi; c1/c2 are the means each iteration
    used, as ``models.scalar.segment_fixed``'s trace (the energy before
    the cadence's redistance). The per-iteration route only (K1's shard
    mode on the kernels, gray), through any ``halo``; nothing is read
    back to the host."""
    if mesh is None:
        raise ValueError("segment_sharded_fixed_trace needs a mesh")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    H, W = u0.shape[:2]
    if H % nx or W % ny:
        raise ValueError(f"image {tuple(u0.shape)} not divisible by mesh "
                         f"({nx}, {ny})")
    if halo not in ("ppermute", "rdma", "overlap"):
        raise ValueError(f"unknown halo mechanism {halo!r}")
    vec = u0.ndim == 3
    if vec:
        if halo != "ppermute":
            raise ValueError(f"halo={halo!r} supports grayscale only")
        lambdas = p.channel_lambdas(u0.shape[-1], lambda1, lambda2)
    else:
        p = _fold_scalar_lambdas(p, lambda1, lambda2)
        lambdas = None
    ok = _pallas_ok(H // nx, W // ny)
    if use_pallas is None:
        use_pallas = (not vec and all(d.type == "cuda" for d in mesh.devices)
                      and ok)
    elif use_pallas and (vec or not ok):
        raise ValueError(f"pallas path unsupported for shard "
                         f"({tuple(u0.shape)}, mesh ({nx}, {ny}))")
    u0 = _on_mesh(u0, mesh)
    sh = _Shards(u0, p, mesh, lambdas,
                 None if phi0 is None else _on_mesh(phi0, mesh))
    step = _Step(sh, bool(use_pallas), _D, False, False, halo)
    phi, c1, c2 = sh.phi0, sh.c1, sh.c2
    es, ds, c1s, c2s = [], [], [], []
    for n in range(iters):
        phi, parts = step.run(phi, c1, c2, 1)
        c1n, c2n = sh.means(parts)
        es.append(_energy(sh, phi, c1n, c2n))
        ds.append(sh.delta(parts))
        c1s.append(c1)
        c2s.append(c2)
        c1, c2 = c1n, c2n
        redistanced = _sharded_reinit(sh, phi, n)
        if redistanced is not None:
            phi = redistanced
            c1, c2 = sh.means_of(phi)
    first = sh.first

    def stack(xs):
        return (torch.stack(xs) if xs
                else torch.empty(0, dtype=sh.dtype, device=first))

    phi = gather_grid(phi, mesh)
    return ShardedTrace(phi, phi >= 0, stack(es), stack(ds), stack(c1s),
                        stack(c2s))


# the sharded multiphase solver ---------------------------------------------

_TINY = 1e-30  # the phase means' empty-phase guard


def _mp_pallas_ok(p: CVParams, u0, nx, ny, m_sets, depth: int = _D) -> bool:
    """The reference's envelope of K9's shard mode (M = 2 gray, red-black,
    no reinit, 8-row shards), on its lane-padded canvas geometry."""
    if u0.ndim != 2 or m_sets != 2 or p.order != "redblack" \
            or p.reinit_every:
        return False
    h, w = u0.shape[0] // nx, u0.shape[1] // ny
    return (h % 8 == 0
            and multiphase_kernel.supports_mp2(h + 2 * depth,
                                               _canvas_cols(w, depth)))


def _shard_phis(phis, mesh: Mesh):
    """(M, H, W) level sets -> the grid of each shard's (M, h, w) stack."""
    per = [shard_grid(phis[m], grid_sharding(mesh))
           for m in range(phis.shape[0])]
    return [[torch.stack([g[ix][iy] for g in per])
             for iy in range(len(per[0][0]))] for ix in range(len(per[0]))]


def _gather_phis(phis, mesh: Mesh):
    """The inverse of :func:`_shard_phis`, on the mesh's first device."""
    return torch.stack([gather_grid([[b[m] for b in row] for row in phis],
                                    mesh)
                        for m in range(phis[0][0].shape[0])])


def _sharded_phase_means(g: _Grid, phis):
    """The 2^M phase means (per channel for RGB) of the shards' level sets,
    from each shard's sums of u w_s and w_s summed over the shards: a list
    on the first device."""
    def local(pos, u, ph):
        ws = phase_weights(ph, g.p.eps)
        if g.vec:
            nums = [torch.sum(u * w[..., None], dim=(0, 1)) for w in ws]
        else:
            nums = [torch.sum(u * w)[None] for w in ws]
        return torch.cat(nums + [torch.sum(w)[None] for w in ws])

    tot = g.psum(g._each(local, g.u0, phis))
    ns, c = 2 ** phis[0][0].shape[0], g.nchan
    return [(tot[s * c:(s + 1) * c] if g.vec else tot[s])
            / torch.clamp(tot[ns * c + s], min=_TINY) for s in range(ns)]


def _label_flips(new, old):
    """Cells whose phase label changed; 0 * sum(new) NaN-poisons the count
    when a level set went non-finite."""
    return (torch.sum((labels_from_phis(new) != labels_from_phis(old))
                      .to(new.dtype)) + 0.0 * torch.sum(new))[None]


def _image_pads(g: _Grid, depth: int):
    """The image blocks padded by ``depth`` (channels last for RGB)."""
    return [[_channels_last(u) for u in row]
            for row in exchange_halo2d_batched(g.cfirst(), depth)]


def _mp_iteration(g: _Grid, phis, u0_pad, halo: str, overlap):
    """One coupled iteration on the plain path (the reference's
    ``_sharded_multiphase_iteration``): the phase means, then each level
    set in order swept on its depth-4 padded block, every level set
    exchanged anew for its coupling term. ``overlap`` (the side streams
    and each shard's lattice) takes the overlap route for every level set.
    Returns (phis, delta)."""
    p, m_sets = g.p, phis[0][0].shape[0]
    cs = _sharded_phase_means(g, phis)
    new = phis
    for m in range(m_sets):
        if overlap is not None:
            new = _mp_overlap_set(g, new, u0_pad, cs, m, *overlap)
            continue
        pads = _exchange(new, _D, halo)

        def one(pos, pad, up, cur, m=m):
            red, black = g.lattice(pos, pad.shape[1:], _D, pad.device)
            f = _coupling_term(up, pad, [c.to(pad.device) for c in cs], m,
                               p)
            upd = _sweep_local(pad[m], f, p, red, black, *pos, g.nx, g.ny)
            out = cur.clone()
            out[m] = upd[_D:_D + g.h, _D:_D + g.w]
            return out
        new = g.grid(g._each(one, pads, u0_pad, new))
    flips = g.psum(g._each(lambda pos, a, b: _label_flips(a, b), new,
                           phis))[0]
    return new, flips / g.n_pix


def _mp_overlap_set(g: _Grid, phis, u0_pad, cs, m: int, streams, masks):
    """Level set m's sweep on the overlap route (the reference's
    ``_sharded_multiphase_m_overlap``): the interior from every level
    set's block edge-padded with its own cells (the coupling term is
    pointwise, so interior cells read no halo of any level set) while the
    exchange of the whole stack runs on the side streams, then the rim
    stitched from strips of the exchanged blocks. Returns the grid of
    stacks with level set m updated."""
    p, D = g.p, _D

    def interior(pos, ph, up):
        local = _edge_pad(ph, D)
        red, black = masks[pos]
        f = _coupling_term(up, local, [c.to(ph.device) for c in cs], m, p)
        upd = _sweep_local(local[m], f, p, red, black, *pos, g.nx, g.ny)
        return upd[D:D + g.h, D:D + g.w]

    pads, inner = _overlapped(streams, phis, D,
                              lambda: g._each(interior, phis, u0_pad))

    def one(pos, pd, up, nm, cur):
        c = [x.to(pd.device) for x in cs]

        def force(win):
            return _coupling_term(up[win], pd[(slice(None),) + win], c, m, p)

        stitched, = _overlap_stitch(g, pos, [nm], pd[m], force, masks[pos],
                                    D, _STRIP, 1)
        out = cur.clone()
        out[m] = stitched
        return out

    return g.grid(g._each(one, pads, u0_pad, g.grid(inner), phis))


def _mp_chunk(g: _Grid, phis, u0_pad, cs, k: int, depth: int, halo: str):
    """k coupled iterations with the phase means ``cs`` frozen, on each
    shard's depth-deep padded blocks (the reference's plain
    ``_sharded_multiphase_chunk``): the replicas refreshed before each
    iteration and between its half-sweeps. Returns (phis, the new state's
    means, delta of the last iteration)."""
    p, D = g.p, depth
    crop = (slice(D, D + g.h), slice(D, D + g.w))

    def one(pos, pad, up):
        red, black = g.lattice(pos, pad.shape[1:], D, pad.device)
        c = [x.to(pad.device) for x in cs]
        cur = prev = list(pad)
        for _ in range(k):
            prev = cur
            cur = [_resync_replicas(x, *pos, g.nx, g.ny, D) for x in cur]
            for m in range(len(cur)):
                f = _coupling_term(up, cur, c, m, p)
                cur[m] = _sweep_local(cur[m], f, p, red, black, *pos, g.nx,
                                      g.ny, D)
        new = torch.stack([x[crop] for x in cur])
        return new, _label_flips(new, torch.stack([x[crop] for x in prev]))

    outs = g._each(one, _exchange(phis, D, halo), u0_pad)
    new = g.grid([o[0] for o in outs])
    flips = g.psum([o[1] for o in outs])[0]
    return new, _sharded_phase_means(g, new), flips / g.n_pix


def _mp_kernel_chunk(g: _Grid, phis, u0c, cs, k: int, depth: int,
                     halo: str):
    """k launches of K9's shard mode on each shard's depth-deep canvas
    (the reference's ``_sharded_multiphase_iteration_pallas`` at k = 1 and
    its kernel chunk): the whole canvas advances between launches; the
    means come back from the last launch's partials summed over the
    shards. Returns (phis, means (4,), delta)."""
    D, crop = depth, g.crop(depth)

    def one(pos, canvas, uc):
        canvas, c = _even_cols(canvas), cs.to(canvas.device)
        parts = None
        for _ in range(k):
            canvas, parts = multiphase_kernel.mp2_iteration_sharded(
                canvas, uc, c, g.p, g.parity(pos), g.edges(pos), crop)
        return canvas[:, D:D + g.h, D:D + g.w], parts[:10]

    outs = g._each(one, _exchange(phis, D, halo), u0c)
    parts = g.psum([o[1] for o in outs])
    cs = parts[0:4] / torch.clamp(parts[4:8], min=_TINY)
    # 0 * s_dphi2 NaN-poisons the flip metric on divergence
    return (g.grid([o[0] for o in outs]), cs,
            parts[8] / g.n_pix + 0.0 * parts[9])


def _mp_step(g: _Grid, use_pallas: bool, comm_k: int, halo: str):
    """A route's step(phis, cs, size) -> (phis, cs, delta), cs the means
    the next step starts from (None on the per-iteration plain route,
    which computes its own)."""
    D = 8 * comm_k if comm_k > 1 else _D
    if use_pallas:
        u0c = [[_even_cols(u) for u in row]
               for row in exchange_halo2d(g.u0, D)]
        return lambda ph, cs, size: _mp_kernel_chunk(g, ph, u0c, cs, size,
                                                     D, halo)
    u0_pad = _image_pads(g, D)
    if comm_k > 1:
        return lambda ph, cs, size: _mp_chunk(g, ph, u0_pad, cs, size, D,
                                              halo)
    overlap = None
    if halo == "overlap":
        shape = (g.h + 2 * D, g.w + 2 * D)
        overlap = (_side_streams(halo, g.mesh),
                   {pos: g.lattice(pos, shape, D, g.mesh.device(*pos))
                    for pos in g.positions()})

    def iteration(ph, cs, size):
        ph, delta = _mp_iteration(g, ph, u0_pad, halo, overlap)
        return ph, None, delta
    return iteration


def _check_multiphase(u0, p: CVParams, mesh, halo, comm_k, m_sets,
                      use_pallas, depth):
    """The reference's argument checks (ValueError); returns use_pallas
    resolved."""
    if mesh is None:
        raise ValueError("needs a mesh (parallel.mesh.make_grid_mesh)")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    H, W = u0.shape[:2]
    if H % nx or W % ny:
        raise ValueError(f"image {tuple(u0.shape)} not divisible by mesh")
    if halo not in ("ppermute", "rdma", "overlap"):
        raise ValueError(f"unknown halo mechanism {halo!r}")
    if halo == "overlap":
        if comm_k > 1:
            raise ValueError("multiphase overlap x comm_k not supported; "
                             "use halo='ppermute' with comm_k")
        if min(H // nx, W // ny) < 16:
            raise ValueError("halo='overlap' needs shards of at least "
                             "16x16 (stitch strip width)")
    if comm_k < 1:
        raise ValueError("comm_k must be >= 1")
    if comm_k > 1:
        if p.reinit_every:
            raise ValueError("multiphase comm_k > 1 supports no reinit "
                             "cadence (frozen-means chunks)")
        if 8 * comm_k > min(H // nx, W // ny):
            raise ValueError(
                f"multiphase comm_k={comm_k} needs 8*comm_k-deep halos, "
                f"larger than the shard ({H // nx}, {W // ny})")
    ok = (_mp_pallas_ok(p, u0, nx, ny, m_sets, depth)
          and halo != "overlap")
    if use_pallas is None:
        use_pallas = all(d.type == "cuda" for d in mesh.devices) and ok
    elif use_pallas and not ok:
        raise ValueError(
            f"fused multiphase pallas path unsupported for "
            f"{tuple(u0.shape)} on mesh ({nx}, {ny}) with halo={halo!r} "
            f"(needs M=2 grayscale, redblack order, no reinit, "
            f"8-row-aligned shards, non-overlap halos)")
    return bool(use_pallas)


def _mp_start(u0, m_sets, phis0, mesh):
    if phis0 is None:
        phis0 = init_multiphase(u0.shape[:2], m_sets, dtype=u0.dtype,
                                device=mesh.devices[0])
    return _shard_phis(_on_mesh(phis0, mesh), mesh)


def segment_multiphase_sharded(u0, p: CVParams = CVParams(),
                               mesh: Optional[Mesh] = None,
                               m_sets: int = 2,
                               phis0: Optional[torch.Tensor] = None,
                               max_iter: Optional[int] = None,
                               fixed: bool = False,
                               use_pallas: Optional[bool] = None,
                               halo: str = "ppermute",
                               comm_k: int = 1) -> MultiphaseResult:
    """Multiphase Vese-Chan (M coupled level sets, 2^M phases) over a 2-D
    ('x', 'y') grid mesh. u0: (H, W) or (H, W, C), divisible by the mesh.
    Tolerance mode on the label-flip fraction by default; ``fixed=True``
    runs exactly ``max_iter`` (or p.max_iter) iterations. Returns a
    MultiphaseResult whose phis and labels are gathered onto the mesh's
    first device, and the phase means of the final state.

    use_pallas: None takes K9's shard mode where every mesh device is a
    CUDA device and the reference's envelope holds (M = 2 gray, red-black,
    no reinit, 8-row shards): one launch an iteration per shard, the means
    carried through its partials. True on CPU devices runs its plain
    version through the same driver (the reference's ``interpret=True``).
    comm_k: one 8k-deep exchange of every level set per comm_k coupled
    iterations with frozen phase means (the chunk's last iteration's flips
    are its metric; patience counts iterations), a remainder chunk ending
    the run. halo: 'ppermute', 'rdma' (K14, every route) or 'overlap'
    (the plain per-iteration route only, shards of at least 16x16).
    reinit_every > 0 (the plain per-iteration route, comm_k = 1)
    redistances every level set on the cadence, after the iteration's
    flips.
    """
    depth = 8 * comm_k if comm_k > 1 else _D
    with spans.span("cv.drv.setup"):
        use_pallas = _check_multiphase(u0, p, mesh, halo, comm_k, m_sets,
                                       use_pallas, depth)
        cap = max_iter if max_iter is not None else p.max_iter
        u0 = _on_mesh(u0, mesh)
        g = _Grid(u0, p, mesh)
        phis = _mp_start(u0, m_sets, phis0, mesh)
        step = _mp_step(g, use_pallas, comm_k, halo)
        cs = (torch.stack(_sharded_phase_means(g, phis)) if use_pallas
              else _sharded_phase_means(g, phis) if comm_k > 1 else None)

    n = 0

    def advance(size):
        nonlocal phis, cs, n
        with spans.span("cv.drv.step"):
            phis, cs, delta = step(phis, cs, size)
            redistanced = _sharded_reinit(g, phis, n)
            if redistanced is not None:  # the plain route: cs is None
                phis = redistanced
            n += size
            return delta

    iters, delta = _drive(g, cap, fixed, comm_k, comm_k > 1, advance)
    with spans.span("cv.drv.finish"):
        phis = _gather_phis(phis, mesh)
        cs = torch.stack(phase_means(u0, phis, p.eps))
        return MultiphaseResult(phis, labels_from_phis(phis), iters, delta,
                                cs)


def _sharded_multiphase_energy(g: _Grid, phis):
    """The multiphase energy of the sharded level sets, summed over the
    shards: the phase means from the shards' sums, forward differences
    through a 1-deep halo (as ``models.multiphase.multiphase_energy`` on
    the assembled image)."""
    p = g.p
    cs = _sharded_phase_means(g, phis)

    def local(pos, u, ph, pad):
        c = [x.to(ph.device) for x in cs]
        fit = torch.zeros((), dtype=ph.dtype, device=ph.device)
        for w, cc in zip(phase_weights(ph, p.eps), c):
            d = (torch.mean((u - cc) ** 2, dim=-1) if g.vec
                 else (u - cc) ** 2)
            fit = fit + torch.sum(d * w)
        reg = torch.zeros((), dtype=ph.dtype, device=ph.device)
        for m in range(ph.shape[0]):
            core = pad[m, 1:-1, 1:-1]
            gx = pad[m, 2:, 1:-1] - core
            gy = pad[m, 1:-1, 2:] - core
            reg = reg + p.mu * torch.sum(dirac(ph[m], p.eps)
                                         * torch.sqrt(gx * gx + gy * gy))
            reg = reg + p.nu * torch.sum(heaviside(ph[m], p.eps))
        return (fit + reg)[None]

    return g.psum(g._each(local, g.u0, phis,
                          exchange_halo2d_batched(phis, 1)))[0]


class MultiphaseShardedTrace(NamedTuple):
    phis: torch.Tensor     # (M, H, W)
    labels: torch.Tensor   # (H, W) int32
    energy: torch.Tensor   # (iters,)
    delta: torch.Tensor    # (iters,) label-flip fractions


def segment_multiphase_sharded_fixed_trace(
        u0, p: CVParams = CVParams(), mesh: Optional[Mesh] = None,
        iters: int = 100, m_sets: int = 2,
        phis0: Optional[torch.Tensor] = None,
        use_pallas: Optional[bool] = None,
        halo: str = "ppermute") -> MultiphaseShardedTrace:
    """Fixed-iteration sharded multiphase run with the energy and the
    label-flip fraction of every iteration, from the shards' sums (the
    schedule of ``models.multiphase.segment_multiphase_fixed``: the energy
    after each coupled iteration). The per-iteration routes: K9's shard
    mode (M = 2 gray, means carried) or the plain path; phis and labels
    gathered onto the mesh's first device."""
    if mesh is None:
        raise ValueError("needs a mesh (parallel.mesh.make_grid_mesh)")
    use_pallas = _check_multiphase(u0, p, mesh, halo, 1, m_sets, use_pallas,
                                   _D)
    u0 = _on_mesh(u0, mesh)
    g = _Grid(u0, p, mesh)
    phis = _mp_start(u0, m_sets, phis0, mesh)
    step = _mp_step(g, use_pallas, 1, halo)
    cs = torch.stack(_sharded_phase_means(g, phis)) if use_pallas else None
    es, ds = [], []
    for n in range(iters):
        phis, cs, delta = step(phis, cs, 1)
        es.append(_sharded_multiphase_energy(g, phis))
        ds.append(delta)
        redistanced = _sharded_reinit(g, phis, n)
        if redistanced is not None:
            phis = redistanced

    def stack(xs):
        return (torch.stack(xs) if xs
                else torch.empty(0, dtype=g.dtype, device=g.first))

    phis = _gather_phis(phis, mesh)
    return MultiphaseShardedTrace(phis, labels_from_phis(phis), stack(es),
                                  stack(ds))
