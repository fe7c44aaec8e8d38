"""Exact-means resident drivers for small and medium images: K7 (flat) and
K8 (parity planes), on grayscale images, RGB images and frame stacks.

Counterpart of ``chan_vese_tpu/models/resident.py``. One kernel launch
runs a whole block of iterations with the means recomputed from the
current phi at every iteration, so the trajectory is the per-iteration
route's (``models/fused.py``), with no host round trip per iteration.

Routing is the reference's: (H, W, C) images take the packed mc kernel
where ``supports_packed_resident_mc`` holds (unroll 2 for an even
iteration count), else the flat mc kernel; grayscale images the packed
kernel where ``supports_packed_resident`` holds (``_auto_unroll`` at up to
256^2, else 1), else the flat one. Off the resident envelope, for another
sweep order, or with a reinit cadence (it runs between launches), the
drivers run ``segment_fused(_fixed)`` (the stack driver
``models/batched.py``).

Tolerance mode runs chunks of ``chunk`` iterations per launch and reads
each chunk's per-iteration convergence rows back once: the streak runs
over every row, a non-finite row stops the run, and the reported
``iters`` is the chunk boundary where the run stopped. The max_iter cap is
exact: full chunks, then one remainder chunk.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import spans
from ..ops import packed_kernel, resident_kernel
from ..ops.reductions import region_means
from ..params import CVParams
from .batched import _stack_phi0
from .fused import _delta_from_partials, _fold_scalar_lambdas
from .scalar import SegResult, _phi0


def _auto_unroll(iters: int, cap: int = 4) -> int:
    """Largest power of two <= cap dividing iters (the reference's fixed-
    mode choice; it changes only which partials rows are written)."""
    u = 1
    while u * 2 <= cap and iters % (u * 2) == 0:
        u *= 2
    return u


def segment_resident_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                           phi0: Optional[torch.Tensor] = None,
                           lambda1=None, lambda2=None):
    """Fixed-iteration resident run in one launch. Returns (phi, mask).
    (H, W, C) images run the mc kernels with per-channel lambda tuples."""
    if u0.ndim == 3:
        H, W, C = u0.shape
        if (not resident_kernel.supports_resident_mc(H, W, C)
                or p.order != "redblack" or p.reinit_every):
            from .fused import segment_fused_fixed
            return segment_fused_fixed(u0, p, iters, phi0, lambda1=lambda1,
                                       lambda2=lambda2)
        phi0 = _phi0(u0, p, phi0)
        ucf = u0.permute(2, 0, 1).contiguous()
        if packed_kernel.supports_packed_resident_mc(H, W, C):
            un = 2 if iters % 2 == 0 else 1
            phi, _ = packed_kernel.packed_resident_iterations_mc(
                phi0, ucf, p, iters, lambda1, lambda2, unroll=un)
        else:
            phi, _ = resident_kernel.resident_iterations_mc(
                phi0, ucf, p, iters, lambda1, lambda2)
        return phi, phi >= 0
    p = _fold_scalar_lambdas(p, lambda1, lambda2)
    H, W = u0.shape
    if (not resident_kernel.supports_resident(H, W)
            or p.order != "redblack" or p.reinit_every):
        from .fused import segment_fused_fixed
        return segment_fused_fixed(u0, p, iters, phi0)
    phi0 = _phi0(u0, p, phi0)
    if packed_kernel.supports_packed_resident(H, W):
        un = _auto_unroll(iters) if H * W <= 256 * 256 else 1
        phi, _ = packed_kernel.packed_resident_iterations(phi0, u0, p, iters,
                                                          unroll=un)
    else:
        phi, _ = resident_kernel.resident_iterations(
            phi0, u0, p, iters, unroll=_auto_unroll(iters))
    return phi, phi >= 0


def segment_resident(u0, p: CVParams = CVParams(),
                     phi0: Optional[torch.Tensor] = None, chunk: int = 16,
                     lambda1=None, lambda2=None) -> SegResult:
    """Tolerance-mode resident segmentation, ``chunk`` iterations per
    launch. (H, W, C) images run :func:`.fused.segment_fused`, as in the
    reference (its mc kernel has no per-iteration convergence rows)."""
    if u0.ndim == 3:
        from .fused import segment_fused
        return segment_fused(u0, p, phi0, lambda1=lambda1, lambda2=lambda2)
    p = _fold_scalar_lambdas(p, lambda1, lambda2)
    H, W = u0.shape
    if (not resident_kernel.supports_resident(H, W)
            or p.order != "redblack" or p.reinit_every):
        from .fused import segment_fused
        return segment_fused(u0, p, phi0)
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    # validate conv_norm before any work (same contract as the reference)
    _delta_from_partials(torch.zeros(8, dtype=u0.dtype), 1.0, p)
    op = (packed_kernel.packed_resident_iterations
          if packed_kernel.supports_packed_resident(H, W)
          else resident_kernel.resident_iterations)
    phi = _phi0(u0, p, phi0)
    n_pix = float(H * W)
    n, streak, diverged = 0, 0, False
    delta = torch.tensor(math.inf, dtype=u0.dtype, device=u0.device)

    def not_stopped():
        done = streak >= p.patience and n >= p.min_iter
        return not (done or diverged)

    def run_chunk(size):
        nonlocal phi, n, delta, streak, diverged
        # unroll stays 1: the rows are the per-iteration convergence surface
        phi, parts = op(phi, u0, p, size)
        # one metric per row: the columns of the (rows, 8) partials
        deltas = _delta_from_partials(parts.T, n_pix, p)
        # one device-to-host read per chunk: the rows and their tol test,
        # compared in the rows' dtype as the reference's scan does
        rows = torch.stack((deltas, (deltas < p.tol).to(deltas.dtype)))
        rows = rows.cpu()
        for below in rows[1].tolist():
            streak = streak + 1 if below else 0
        diverged = not bool(torch.isfinite(rows[0]).all())
        delta = deltas[-1]
        n += size

    full = (p.max_iter // chunk) * chunk
    while n < full and not_stopped():
        run_chunk(chunk)
    rem = p.max_iter - full
    if rem and n < p.max_iter and not_stopped():
        run_chunk(rem)
    c1, c2 = region_means(u0, phi, p.eps)
    return SegResult(phi, phi >= 0, n, delta, c1, c2)


def segment_stack_resident_fixed(u0, p: CVParams = CVParams(),
                                 iters: int = 100,
                                 phi0: Optional[torch.Tensor] = None,
                                 lambda1=None, lambda2=None):
    """Fixed-iteration segmentation of an (N, H, W) grayscale stack, every
    frame in one launch. Off the resident envelope it runs
    :func:`.batched.segment_stack_fused_fixed`. Returns (phi, mask)."""
    with spans.span("cv.drv.setup"):
        p = _fold_scalar_lambdas(p, lambda1, lambda2)
        N, H, W = u0.shape
        ok = (resident_kernel.supports_resident(H, W)
              and p.order == "redblack" and not p.reinit_every)
        if ok:
            phi0 = _stack_phi0(u0, p, phi0)
            packed = packed_kernel.supports_packed_resident(H, W)
    if not ok:
        from .batched import segment_stack_fused_fixed
        return segment_stack_fused_fixed(u0, p, iters, phi0)
    if packed:
        phis, _ = packed_kernel.packed_resident_iterations_batch(
            phi0, u0, p, iters, unroll=2 if iters % 2 == 0 else 1)
    else:
        phis, _ = resident_kernel.resident_iterations_batch(phi0, u0, p,
                                                            iters)
    with spans.span("cv.drv.finish"):
        return phis, phis >= 0
