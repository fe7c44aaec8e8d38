"""K2 and K5: k red-black iterations per pass over device memory, means
frozen, on a scalar image (K2) or a C-channel one (K5).

Counterpart of ``chan_vese_tpu/ops/pallas_banded.py`` (``_banded_kernel``
/ ``_banded_kernel_fusej`` and ``_banded_mc_kernel`` /
``_banded_mc_kernel_fusej``, on a whole image and on a shard canvas). On a
CUDA tensor :func:`banded_chunk` launches ``csrc/banded.cu`` and
:func:`banded_chunk_mc` ``csrc/banded_mc.cu``, and their shard-canvas
modes :func:`banded_chunk_sharded` and :func:`banded_chunk_mc_sharded` the
same files' shard launchers, all four on the body of ``csrc/band.cuh``
(:func:`._cuda.launch_band`); on a CPU tensor each runs its ``_reference``
plain version.

Trajectory class: c1/c2 stay frozen across the k iterations of a chunk;
the partials describe the LAST iteration's transition. k = 1 is the fused
kernel's schedule exactly.

``_halos``, ``band_rows_banded(_mc)`` and ``supports_banded(_mc)`` are the
reference's routing predicates (pure integer functions of the shape). The
VMEM and alignment terms inside them are the reference's routing, not
limits of the Hopper kernel, which takes any even H and W.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import spans
from ..params import CVParams
from . import _cuda
from .fused_kernel import _VMEM_LIMIT, chunk_reference, chunk_shard_reference
from .fused_kernel_mc import chunk_reference_mc, data_term_mc
from .reductions import data_term

# routing constant of chan_vese_tpu/ops/pallas_banded.py
_TILES = 34


def _halos(k: int) -> Tuple[int, int]:
    """(up, down) halo rows of the reference kernel, 8-row aligned."""
    up = -(-4 * k // 8) * 8
    dn = -(-2 * k // 8) * 8
    return up, dn


def _tile_height_cap(w: int, up: int, dn: int, extra: int = 0) -> int:
    t_cap = _VMEM_LIMIT // (w * 4 * (27 + extra))
    return max(8, (t_cap - up - dn) // 8 * 8)


def band_rows_banded(h: int, w: int, k: int) -> int:
    """The reference's band height for k in-tile iterations."""
    up, dn = _halos(k)
    per_row = w * 4 * _TILES
    b = max(8, (_VMEM_LIMIT // per_row) // 8 * 8)
    b = min(b, _tile_height_cap(w, up, dn))
    return min(b, max(8, ((h - up - dn) // 8) * 8))


def supports_banded(h: int, w: int, k: int) -> bool:
    """Whether the reference routes (h, w, k) to its banded kernel."""
    up, dn = _halos(k)
    return (w % 128 == 0 and h % 8 == 0 and 1 <= k <= 64
            and band_rows_banded(h, w, k) + up + dn <= h)


def banded_chunk_reference(phi, u0, c1, c2, p: CVParams, k: int = 8):
    """Plain PyTorch version of :func:`banded_chunk`."""
    return chunk_reference(phi, u0, c1, c2, p, k)


def banded_chunk(phi, u0, c1, c2, p: CVParams, k: int = 8,
                 unroll: int = 1, fuse: bool = False):
    """Run k red-black iterations with frozen means.

    Returns (phi_new, partials (8,)). ``unroll`` and ``fuse`` are accepted
    for signature parity with the reference; they changed only the TPU
    grid, never the values, and the Hopper kernel ignores them.
    """
    with spans.span("cv.launch.banded_chunk"):
        if unroll < 1 or k % unroll:
            raise ValueError(f"unroll must divide k (got k={k}, "
                             f"unroll={unroll})")
        if phi.device.type == "cpu":
            return banded_chunk_reference(phi, u0, c1, c2, p, k)
        out = _cuda.launch_band(phi, u0, c1, c2, p, k)
        banded_chunk.launches += 1
        return out


banded_chunk.launches = 0


def banded_chunk_sharded_reference(canvas, u0_canvas, c1, c2, p: CVParams,
                                   k: int, parity, edges, crop):
    """Plain PyTorch version of :func:`banded_chunk_sharded`."""
    shard = _cuda.shard_args(*canvas.shape, k, parity, crop, edges)
    f = data_term(u0_canvas, c1, c2, p.nu, p.lambda1, p.lambda2)
    return chunk_shard_reference(canvas, f, (u0_canvas,), p, k, shard, 8)


def banded_chunk_sharded(canvas, u0_canvas, c1, c2, p: CVParams, k: int,
                         parity, edges, crop, unroll: int = 1,
                         fuse: bool = False):
    """k frozen-means iterations on a halo-padded shard canvas (the
    sharded solver's chunk, ``parallel/sharded.py``): ``parity`` offsets
    the red-black lattice, ``edges`` = [top, bottom, left, right] flags the
    canvas sides that are global image edges (their replica rim is
    refreshed after every half-sweep), and ``crop`` = (r0, r1, c0, c1) is
    the shard's own window, to which the tiles and the partials are
    restricted; the canvas outside it is returned as it came in. The
    canvas must hold the chunk's reach around the crop
    (:func:`._cuda.shard_args`). Returns (canvas_new, partials (8,)).

    The reference's routing predicate is the driver's to check, on the
    reference's lane-padded canvas geometry: the Hopper kernel takes any
    even canvas. ``unroll``/``fuse``: as :func:`banded_chunk`. CPU
    tensors run the plain version; CUDA tensors launch
    ``cv_banded_chunk_shard`` (``csrc/banded.cu``, the band body) or
    raise.
    """
    with spans.span("cv.launch.banded_chunk_sharded"):
        if unroll < 1 or k % unroll:
            raise ValueError(f"unroll must divide k (got k={k}, "
                             f"unroll={unroll})")
        h, w = canvas.shape
        shard = _cuda.shard_args(h, w, k, parity, crop, edges)
        if canvas.device.type == "cpu":
            return banded_chunk_sharded_reference(canvas, u0_canvas, c1, c2, p,
                                                  k, parity, edges, crop)
        out = _cuda.launch_band(canvas, u0_canvas, c1, c2, p, k, shard=shard)
        banded_chunk_sharded.launches += 1
        return out


banded_chunk_sharded.launches = 0


def band_rows_banded_mc(h: int, w: int, k: int, c: int) -> int:
    """The reference's band height for the C-channel kernel."""
    up, dn = _halos(k)
    per_row = w * 4 * (_TILES + 2 * c)
    b = max(8, (_VMEM_LIMIT // per_row) // 8 * 8)
    b = min(b, _tile_height_cap(w, up, dn, extra=2 * (c - 1)))
    return min(b, max(8, ((h - up - dn) // 8) * 8))


def supports_banded_mc(h: int, w: int, k: int, c: int) -> bool:
    """Whether the reference routes (h, w, k, c) to its banded mc kernel."""
    up, dn = _halos(k)
    return (w % 128 == 0 and h % 8 == 0 and 1 <= k <= 64 and 1 <= c <= 8
            and band_rows_banded_mc(h, w, k, c) + up + dn <= h)


def banded_chunk_mc_reference(phi, u0_cfirst, c1, c2, p: CVParams,
                              k: int = 8, lambda1=None, lambda2=None):
    """Plain PyTorch version of :func:`banded_chunk_mc`."""
    return chunk_reference_mc(phi, u0_cfirst, c1, c2, p, k, lambda1,
                              lambda2, 16)


def banded_chunk_mc(phi, u0_cfirst, c1, c2, p: CVParams, k: int = 8,
                    unroll: int = 1, lambda1=None, lambda2=None,
                    fuse: bool = False):
    """k frozen-means iterations on a (C, H, W) image; c1, c2: (C,) means.

    Returns (phi_new, partials (16,)): [s_uH per channel..., s_H,
    s_dphi2, flips, s_absdphi, 0...] of the last iteration's transition.
    ``unroll``/``fuse``: as :func:`banded_chunk`.
    """
    with spans.span("cv.launch.banded_chunk_mc"):
        if unroll < 1 or k % unroll:
            raise ValueError(f"unroll must divide k (got k={k}, "
                             f"unroll={unroll})")
        C = _cuda.mc_channels(phi, u0_cfirst)
        if phi.device.type == "cpu":
            return banded_chunk_mc_reference(phi, u0_cfirst, c1, c2, p, k,
                                             lambda1, lambda2)
        l1, l2 = p.channel_lambdas(C, lambda1, lambda2)
        out = _cuda.launch_band(phi, u0_cfirst, c1, c2, p, k, l1=l1, l2=l2)
        banded_chunk_mc.launches += 1
        return out


banded_chunk_mc.launches = 0


def banded_chunk_mc_sharded_reference(canvas, u0_canvas_cfirst, c1, c2,
                                      p: CVParams, k: int, parity, edges,
                                      crop, lambda1=None, lambda2=None):
    """Plain PyTorch version of :func:`banded_chunk_mc_sharded`."""
    C = _cuda.mc_channels(canvas, u0_canvas_cfirst)
    shard = _cuda.shard_args(*canvas.shape, k, parity, crop, edges)
    l1, l2 = p.channel_lambdas(C, lambda1, lambda2)
    c1 = torch.as_tensor(c1, dtype=canvas.dtype,
                         device=canvas.device).reshape(C)
    c2 = torch.as_tensor(c2, dtype=canvas.dtype,
                         device=canvas.device).reshape(C)
    f = data_term_mc(u0_canvas_cfirst, c1, c2, p, l1, l2)
    return chunk_shard_reference(canvas, f, list(u0_canvas_cfirst), p, k,
                                 shard, 16)


def banded_chunk_mc_sharded(canvas, u0_canvas_cfirst, c1, c2, p: CVParams,
                            k: int, parity, edges, crop, unroll: int = 1,
                            lambda1=None, lambda2=None, fuse: bool = False):
    """The multichannel twin of :func:`banded_chunk_sharded`: k
    frozen-means iterations on a shard canvas with a (C, Hc, Wc)
    channels-first image canvas and (C,) means. Same parity/edges/crop
    contract; returns (canvas_new, partials (16,)) restricted to the crop.
    CPU tensors run the plain version; CUDA tensors launch
    ``cv_banded_chunk_mc_shard`` (``csrc/banded_mc.cu``) or raise."""
    with spans.span("cv.launch.banded_chunk_mc_sharded"):
        if unroll < 1 or k % unroll:
            raise ValueError(f"unroll must divide k (got k={k}, "
                             f"unroll={unroll})")
        C = _cuda.mc_channels(canvas, u0_canvas_cfirst)
        h, w = canvas.shape
        shard = _cuda.shard_args(h, w, k, parity, crop, edges)
        if canvas.device.type == "cpu":
            return banded_chunk_mc_sharded_reference(
                canvas, u0_canvas_cfirst, c1, c2, p, k, parity, edges, crop,
                lambda1, lambda2)
        l1, l2 = p.channel_lambdas(C, lambda1, lambda2)
        out = _cuda.launch_band(canvas, u0_canvas_cfirst, c1, c2, p, k,
                                shard=shard, l1=l1, l2=l2)
        banded_chunk_mc_sharded.launches += 1
        return out


banded_chunk_mc_sharded.launches = 0
