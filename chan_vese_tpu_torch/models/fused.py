"""Per-iteration fused-kernel drivers: K1 on grayscale images, K4 on
vector-valued (H, W, C) ones.

Counterpart of ``chan_vese_tpu/models/fused.py``. Each iteration is one
:func:`..ops.fused_kernel.fused_iteration` (or, for C channels,
:func:`..ops.fused_kernel_mc.fused_iteration_mc` on the channels-first
image); the next iteration's means come from its partials, so the
trajectory is exactly the plain red-black path's. Shapes outside the
reference's fused envelopes (``supports``, ``supports_mc``) and orders
other than red-black run :mod:`.scalar` (:mod:`.vector` for C channels,
with the per-channel lambda tuples), as in the reference. With
``p.reinit_every > 0`` every reinit_every-th iteration ends with the
cadence's redistance (R1 on the card) and means taken anew from the
redistanced level set; on the other iterations the kernel's partials give
the means, as without a cadence (the reference's
``_reinit_and_refresh_means`` takes them anew on every iteration, its
sharded route only after a redistance, as here). The convergence metric
stays the kernel's, from before the redistance.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops import fused_kernel, fused_kernel_mc
from ..ops.reductions import loop_continue, means_from_sums, region_means
from ..ops.reinit import maybe_reinit, reinit_fires
from ..params import CVParams
from .scalar import (SegResult, _phi0, segment as _segment_plain,
                     segment_fixed, step as _step_plain)


def _delta_from_partials(parts, n_pixels, p: CVParams, offset: int = 0):
    """Decode the convergence metric from kernel partials
    [s_uH x C, s_H, s_dphi2, flips, s_absdphi] (``offset`` = C - 1)."""
    if p.conv_norm == "flips":
        # 0 * s_dphi2 NaN-poisons the metric when phi went non-finite
        return parts[offset + 3] / n_pixels + 0.0 * parts[offset + 2]
    if p.conv_norm == "rms":
        return torch.sqrt(parts[offset + 2] / n_pixels)
    if p.conv_norm == "mean_abs":
        return parts[offset + 4] / n_pixels
    raise ValueError(f"unknown conv_norm {p.conv_norm!r}")


def _fold_scalar_lambdas(p: CVParams, lambda1, lambda2) -> CVParams:
    """Grayscale path: lambda overrides fold into the params the kernel
    takes; per-channel tuples are a vector-image concept."""
    kw = {}
    if lambda1 is not None:
        if np.ndim(lambda1) > 0 and len(np.atleast_1d(lambda1)) > 1:
            raise ValueError("per-channel lambda1 needs an (H, W, C) image")
        kw["lambda1"] = float(np.atleast_1d(lambda1)[0])
    if lambda2 is not None:
        if np.ndim(lambda2) > 0 and len(np.atleast_1d(lambda2)) > 1:
            raise ValueError("per-channel lambda2 needs an (H, W, C) image")
        kw["lambda2"] = float(np.atleast_1d(lambda2)[0])
    return p.replace(**kw) if kw else p


def _kernel_image(u0):
    """(image as the kernels take it, the sums behind the means, C):
    channels-first (C, H, W) with per-channel sums for an (H, W, C) image,
    the image itself and C = 0 for a grayscale one."""
    if u0.ndim == 3:
        img = u0.permute(2, 0, 1).contiguous()
        return img, torch.sum(img, dim=(1, 2)), u0.shape[2]
    return u0, torch.sum(u0), 0


class _Iteration:
    """The kernel route of one image: its channels-first copy, the sums
    behind the means, and one kernel iteration with the means refresh
    (and the reinit cadence)."""

    def __init__(self, u0, p: CVParams, phi0, lambda1, lambda2):
        self.p, self.lambda1, self.lambda2 = p, lambda1, lambda2
        self.image, self.n = u0, 0
        self.phi = _phi0(u0, p, phi0)
        self.n_pix = torch.tensor(self.phi.numel(), dtype=u0.dtype,
                                  device=u0.device)
        self.c1, self.c2 = region_means(u0, self.phi, p.eps)
        self.u0, self.sum_u, self.nchan = _kernel_image(u0)
        self.offset = max(self.nchan, 1) - 1

    def run(self):
        """One iteration; returns its partials."""
        if self.nchan:
            self.phi, parts = fused_kernel_mc.fused_iteration_mc(
                self.phi, self.u0, self.c1, self.c2, self.p, self.lambda1,
                self.lambda2)
            sum_uh = parts[:self.nchan]
        else:
            self.phi, parts = fused_kernel.fused_iteration(
                self.phi, self.u0, self.c1, self.c2, self.p)
            sum_uh = parts[0]
        self.c1, self.c2 = means_from_sums(sum_uh, parts[self.offset + 1],
                                           self.sum_u, self.n_pix)
        if reinit_fires(self.n, self.p):
            # a redistance rescales |phi| and so H_eps everywhere: the
            # partials' means are stale after it, and only after it
            self.phi = maybe_reinit(self.phi, self.n, self.p)
            self.c1, self.c2 = region_means(self.image, self.phi, self.p.eps)
        self.n += 1
        return parts


def _routed(u0, p: CVParams) -> bool:
    if p.order != "redblack":
        return False
    if u0.ndim == 3:
        return fused_kernel_mc.supports_mc(*u0.shape)
    return fused_kernel.supports(*u0.shape)


def _lambdas(u0, p: CVParams, lambda1, lambda2):
    """(p, lambda1, lambda2) for the route: grayscale folds the overrides
    into p, a C-channel image keeps them for the kernel."""
    if u0.ndim == 3:
        return p, lambda1, lambda2
    return _fold_scalar_lambdas(p, lambda1, lambda2), None, None


def segment_fused(u0, p: CVParams = CVParams(),
                  phi0: Optional[torch.Tensor] = None,
                  lambda1=None, lambda2=None, fixed: bool = False,
                  max_iter: Optional[int] = None) -> SegResult:
    """Tolerance-mode segmentation on the fused kernel; ``fixed=True`` runs
    exactly ``max_iter`` (or p.max_iter) iterations. (H, W, C) images run
    the multichannel kernel with per-channel lambda tuples."""
    cap = p.max_iter if max_iter is None else max_iter
    p, lambda1, lambda2 = _lambdas(u0, p, lambda1, lambda2)
    if not _routed(u0, p):
        # a negative tol can never be reached, so the loop runs to cap
        pf = p.replace(max_iter=cap, tol=-1.0) if fixed \
            else p.replace(max_iter=cap)
        if u0.ndim == 3:
            from .vector import segment_vector
            return segment_vector(u0, pf, phi0, *p.channel_lambdas(
                u0.shape[2], lambda1, lambda2))
        return _segment_plain(u0, pf, phi0)

    it = _Iteration(u0, p, phi0, lambda1, lambda2)
    n, streak = 0, 0
    delta = torch.tensor(math.inf, dtype=u0.dtype, device=u0.device)
    delta_f = math.inf
    while (n < cap) if fixed else loop_continue(n, delta_f, streak, p, cap):
        parts = it.run()
        delta = _delta_from_partials(parts, it.n_pix, p, it.offset)
        if not fixed:
            delta_f = float(delta)
            streak = streak + 1 if bool(delta < p.tol) else 0
        n += 1
    return SegResult(it.phi, it.phi >= 0, n, delta, it.c1, it.c2)


def segment_fused_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                        phi0: Optional[torch.Tensor] = None,
                        lambda1=None, lambda2=None):
    """Fixed-iteration fused run. Returns (phi, mask)."""
    p, lambda1, lambda2 = _lambdas(u0, p, lambda1, lambda2)
    if not _routed(u0, p):
        if u0.ndim == 3:
            l1, l2 = p.channel_lambdas(u0.shape[2], lambda1, lambda2)
            tr = segment_fixed(u0, p, iters=iters, phi0=phi0, lambda1=l1,
                               lambda2=l2)
            return tr.phi, tr.mask
        phi = _phi0(u0, p, phi0)
        for n in range(iters):
            phi = maybe_reinit(_step_plain(phi, u0, p)[0], n, p)
        return phi, phi >= 0
    it = _Iteration(u0, p, phi0, lambda1, lambda2)
    for _ in range(iters):
        it.run()
    return it.phi, it.phi >= 0
