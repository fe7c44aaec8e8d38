"""Banded multi-iteration drivers: K2/K3 on grayscale images (the scalar
main path), K5/K6 on vector-valued (H, W, C) ones (the RGB main path).

Counterpart of ``chan_vese_tpu/models/banded.py``. A run is a host loop of
chunks; each chunk is one kernel launch doing k red-black iterations with
c1/c2 frozen, and the next chunk's means come from its partials
(frozen-means-per-chunk trajectory class; k = 1 is the fused driver's
schedule). The schedule is the reference's: full k-chunks, then one
remainder chunk, so the max_iter cap is exact.

Convergence and divergence are evaluated at chunk boundaries from the last
in-chunk iteration's partials; ``patience`` is iteration-denominated (a
below-tol chunk credits its full size to the streak). The tolerance loop
runs one chunk ahead: it queues chunk n + 1 on chunk n's iterate and means
before it reads chunk n's delta (on a CUDA device a non-blocking copy into
pinned memory, queued before chunk n + 1, and a wait on an event after
it), so the device runs the next chunk while the host reads and decides.
A stop throws the chunk ahead away and keeps chunk n's state, so the
answer is the one-chunk-at-a-time loop's, bit for bit. One read a chunk.

Routing follows the reference exactly (``auto_config``/``_supported``,
``auto_config_mc``/``_supported_mc``): a call takes the same route, and so
the same trajectory class, as in ``chan_vese_tpu`` at every shape. Off
the banded envelope, or with a reinit cadence, it runs the fused driver
(K1/K4), which itself falls back to the plain path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import spans
from ..ops import banded_kernel, packed_kernel
from ..ops.reductions import means_from_sums, region_means
from ..params import CVParams
from .fused import _delta_from_partials, _kernel_image, _lambdas
from .scalar import SegResult, _phi0


def _supported(u0, p: CVParams, k: int) -> bool:
    # a reinit cadence needs a boundary every iteration: the fused route
    return (banded_kernel.supports_banded(*u0.shape, k)
            and p.order == "redblack" and not p.reinit_every)


def _supported_mc(u0, p: CVParams, k: int) -> bool:
    H, W, C = u0.shape
    return (banded_kernel.supports_banded_mc(H, W, k, C)
            and p.order == "redblack" and not p.reinit_every)


def auto_config(H, W, k=None, unroll=None, packed=None, fuse=None):
    """Resolve (k, unroll, packed, fuse) exactly as the reference does.

    The reference's choices were measured on its own hardware; they are
    kept unchanged here so that routing (flat vs packed, k) and hence the
    trajectory class agree with ``chan_vese_tpu``. Re-deriving them for
    the H100 is ROADMAP M4 follow-up work. ``unroll`` and ``fuse`` do not
    change values and the Hopper kernels ignore them.
    """
    if k is None:
        k = 8
    if packed is None:
        packed = (H * W >= 2160 * 3840
                  and packed_kernel.supports_packed_banded(H, W, k))
    if unroll is None:
        if packed:
            bp, _, _ = packed_kernel.band_rows_packed(H, W, k)
            will_fuse = (fuse is True
                         or (fuse is None and k <= 8
                             and H * W >= 2160 * 3840))
            unroll = 4 if (will_fuse and k % 4 == 0 and bp <= 96) else 1
        else:
            unroll = 4
    if fuse is None:
        fuse = unroll == 4 and k <= 8 and H * W >= 2160 * 3840
    return k, unroll, packed, fuse


def auto_config_mc(H, W, C, k=None, unroll=None, packed=None, fuse=None):
    """(k, unroll, packed, fuse) for the multichannel banded drivers,
    resolved exactly as the reference's ``auto_config_mc`` (its choices
    were measured on its own hardware and are kept so that routing, and
    the trajectory class, agree with ``chan_vese_tpu``): packed from 4K
    area up where the plane envelope allows, flat below."""
    if k is None:
        k = 8
    if packed is None:
        packed = (H * W >= 2160 * 3840
                  and packed_kernel.supports_packed_banded_mc(H, W, k, C))
    if unroll is None:
        if packed:
            bp, _, _ = packed_kernel.band_rows_packed_mc(H, W, k, C)
            unroll = 4 if (k % 4 == 0 and bp <= 96) else 1
        else:
            unroll = 4
    if fuse is None:
        if packed:
            fuse = k <= 8 and H * W >= 2160 * 3840
        else:
            fuse = unroll == 4 and k <= 8 and H * W >= 2160 * 3840
    return k, unroll, packed, fuse


class _Chunker:
    """State shared by the drivers: the (optionally packed, channels-first)
    iterate and image, the per-run sums behind the means, and the chunk
    launch. A grayscale image runs K2/K3, a C-channel one K5/K6."""

    def __init__(self, u0, p, phi0, k, unroll, packed, fuse, lambda1=None,
                 lambda2=None):
        H, W = u0.shape[:2]
        self.p, self.unroll, self.fuse = p, unroll, fuse
        self.lambda1, self.lambda2 = lambda1, lambda2
        with spans.span("cv.sync.n_pix"):
            self.n_pix = torch.tensor(H * W, dtype=u0.dtype,
                                      device=u0.device)
        self.c1, self.c2 = region_means(u0, phi0, p.eps)
        img, self.sum_u, self.nchan = _kernel_image(u0)
        self.offset = max(self.nchan, 1) - 1
        if self.nchan:
            self.packed = packed and packed_kernel.supports_packed_banded_mc(
                H, W, k, self.nchan)
        else:
            self.packed = packed and packed_kernel.supports_packed_banded(
                H, W, k)
        if self.packed:
            # img is (H, W) or channels-first (C, H, W): one pack for both
            self.phi = packed_kernel.pack_planes(phi0)
            self.u0 = packed_kernel.pack_planes(img)
        else:
            self.phi, self.u0 = phi0, img

    def run(self, size: int):
        """One chunk of ``size`` iterations; returns its partials."""
        un = self.unroll if size % self.unroll == 0 else 1
        if self.nchan:
            op = (packed_kernel.packed_banded_chunk_mc if self.packed
                  else banded_kernel.banded_chunk_mc)
            self.phi, parts = op(self.phi, self.u0, self.c1, self.c2, self.p,
                                 size, unroll=un, fuse=self.fuse,
                                 lambda1=self.lambda1, lambda2=self.lambda2)
            sum_uh = parts[:self.nchan]
        else:
            op = (packed_kernel.packed_banded_chunk if self.packed
                  else banded_kernel.banded_chunk)
            self.phi, parts = op(self.phi, self.u0, self.c1, self.c2, self.p,
                                 size, unroll=un, fuse=self.fuse)
            sum_uh = parts[0]
        with spans.span("cv.drv.means"):
            self.c1, self.c2 = means_from_sums(
                sum_uh, parts[self.offset + 1], self.sum_u, self.n_pix)
        return parts

    def image(self):
        return (packed_kernel.unpack_planes(self.phi) if self.packed
                else self.phi)


def _route(u0, p: CVParams, k, unroll, packed, fuse, lambda1, lambda2):
    """Resolve the configuration and the lambdas as the reference does:
    (k, unroll, packed, fuse, p, lambda1, lambda2, on the banded route)."""
    p, lambda1, lambda2 = _lambdas(u0, p, lambda1, lambda2)
    if u0.ndim == 3:
        k, unroll, packed, fuse = auto_config_mc(*u0.shape, k, unroll,
                                                 packed, fuse)
        ok = _supported_mc(u0, p, k)
    else:
        k, unroll, packed, fuse = auto_config(*u0.shape, k, unroll, packed,
                                              fuse)
        ok = _supported(u0, p, k)
    return k, unroll, packed, fuse, p, lambda1, lambda2, ok


def segment_banded_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                         k: Optional[int] = None,
                         phi0: Optional[torch.Tensor] = None,
                         lambda1=None, lambda2=None,
                         unroll: Optional[int] = None,
                         packed: Optional[bool] = None,
                         fuse: Optional[bool] = None):
    """Fixed-iteration banded run: full k-chunks plus one remainder chunk.
    Returns (phi, mask). (H, W, C) images run the multichannel kernels
    with per-channel lambda tuples. Off the banded envelope it runs
    :func:`.fused.segment_fused_fixed`."""
    with spans.span("cv.drv.setup"):
        k, unroll, packed, fuse, p, lambda1, lambda2, ok = _route(
            u0, p, k, unroll, packed, fuse, lambda1, lambda2)
        ch = (_Chunker(u0, p, _phi0(u0, p, phi0), k, unroll, packed, fuse,
                       lambda1, lambda2) if ok and iters >= 1 else None)
    if ch is None:
        from .fused import segment_fused_fixed
        return segment_fused_fixed(u0, p, iters, phi0, lambda1=lambda1,
                                   lambda2=lambda2)
    sizes = [k] * (iters // k) + ([iters % k] if iters % k else [])
    for size in sizes:
        with spans.span("cv.drv.step"):
            ch.run(size)
    with spans.span("cv.drv.finish"):
        phi = ch.image()
        return phi, phi >= 0


def segment_banded(u0, p: CVParams = CVParams(),
                   phi0: Optional[torch.Tensor] = None,
                   k: Optional[int] = None,
                   lambda1=None, lambda2=None,
                   unroll: Optional[int] = None,
                   packed: Optional[bool] = None,
                   fuse: Optional[bool] = None) -> SegResult:
    """Tolerance-mode banded segmentation (chunk-granular convergence).
    (H, W, C) images run the multichannel kernels with per-channel lambda
    tuples. Off the banded envelope it runs :func:`.fused.segment_fused`."""
    with spans.span("cv.drv.setup"):
        k, unroll, packed, fuse, p, lambda1, lambda2, ok = _route(
            u0, p, k, unroll, packed, fuse, lambda1, lambda2)
        if ok:
            # validate conv_norm before any work (same contract as the
            # reference)
            _delta_from_partials(torch.zeros(16, dtype=u0.dtype), 1.0, p)
            ch = _Chunker(u0, p, _phi0(u0, p, phi0), k, unroll, packed,
                          fuse, lambda1, lambda2)
            with spans.span("cv.sync.inf"):
                delta = torch.tensor(math.inf, dtype=u0.dtype,
                                     device=u0.device)
    if not ok:
        from .fused import segment_fused
        return segment_fused(u0, p, phi0, lambda1=lambda1, lambda2=lambda2)
    def done(n, streak):
        return streak >= p.patience and n >= p.min_iter

    # the schedule, known without a read: full k-chunks, then one
    # remainder chunk, so the max_iter cap is exact
    sizes = [] if done(0, 0) else (
        [k] * (p.max_iter // k) + ([p.max_iter % k] if p.max_iter % k
                                   else []))
    # the stop metric is compared in its own dtype, as ``delta < tol`` on
    # the device rounds tol to it
    tol = torch.tensor(p.tol, dtype=delta.dtype).item()
    cuda = delta.device.type == "cuda"
    if cuda:
        # two slots: chunk n + 1's copy is queued before chunk n's is read
        slots = torch.empty(2, dtype=delta.dtype, pin_memory=True)
        ready = (torch.cuda.Event(), torch.cuda.Event())
        stream = torch.cuda.current_stream(delta.device)

    def queue(i):
        """Queue chunk i of the schedule and the copy of its stop metric to
        the host: (phi, c1, c2, delta, the host's copy, its event)."""
        parts = ch.run(sizes[i])
        d = _delta_from_partials(parts, ch.n_pix, p, ch.offset)
        if not cuda:
            return ch.phi, ch.c1, ch.c2, d, d, None
        slots[i % 2].copy_(d, non_blocking=True)
        ready[i % 2].record(stream)
        return ch.phi, ch.c1, ch.c2, d, slots[i % 2], ready[i % 2]

    n, streak, ahead = 0, 0, None
    for i, size in enumerate(sizes):
        with spans.span("cv.drv.step"):
            phi, c1, c2, d, host, event = ahead or queue(i)
            ahead = None
            if i + 1 < len(sizes):
                with spans.span("cv.drv.ahead"):
                    ahead = queue(i + 1)
                _counts.ahead += 1
            with spans.span("cv.drv.stop"):
                with spans.span("cv.sync.stop"):
                    if event is not None:
                        event.synchronize()
                    value = float(host)
                # a below-tol chunk credits its full size: patience stays
                # iteration-denominated across drivers
                streak = streak + size if value < tol else 0
                n, delta = n + size, d
                if done(n, streak) or not math.isfinite(value):
                    if ahead is not None:
                        with spans.span("cv.drv.discard"):
                            ch.phi, ch.c1, ch.c2 = phi, c1, c2
                        _counts.discarded += 1
                    break
    with spans.span("cv.drv.finish"):
        phi = ch.image()
        return SegResult(phi, phi >= 0, n, delta, ch.c1, ch.c2)


# chunks queued before the previous chunk's verdict, and those of them
# thrown away at a stop; counted on the function as defined here (under a
# name of its own, since a caller may put a wrapper in its place)
segment_banded.ahead = 0
segment_banded.discarded = 0
_counts = segment_banded
