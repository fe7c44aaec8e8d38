"""Per-iteration fused-kernel drivers (K1), scalar images.

Counterpart of ``chan_vese_tpu/models/fused.py``. Each iteration is one
:func:`..ops.fused_kernel.fused_iteration`; the next iteration's means come
from its partials, so the trajectory is exactly the plain red-black
path's. Shapes outside the reference's fused envelope (``supports``) and
orders other than red-black run :mod:`.scalar`, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops import fused_kernel
from ..ops.reductions import loop_continue, means_from_sums, region_means
from ..params import CVParams
from .scalar import (SegResult, _check_ported, _phi0,
                     segment as _segment_plain, step as _step_plain)


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


def _routed(u0, p: CVParams) -> bool:
    return fused_kernel.supports(*u0.shape) and p.order == "redblack"


def _setup(u0, p: CVParams, phi0):
    phi0 = _phi0(u0, p, phi0)
    n_pix = torch.tensor(u0.numel(), dtype=u0.dtype, device=u0.device)
    c1, c2 = region_means(u0, phi0, p.eps)
    return phi0, n_pix, torch.sum(u0), c1, c2


def segment_fused(u0, p: CVParams = CVParams(),
                  phi0: Optional[torch.Tensor] = None,
                  lambda1=None, lambda2=None, fixed: bool = False,
                  max_iter: Optional[int] = None) -> SegResult:
    """Tolerance-mode segmentation on the fused kernel; ``fixed=True`` runs
    exactly ``max_iter`` (or p.max_iter) iterations."""
    _check_ported(u0, p)
    cap = p.max_iter if max_iter is None else max_iter
    p = _fold_scalar_lambdas(p, lambda1, lambda2)
    if not _routed(u0, p):
        # a negative tol can never be reached, so the loop runs to cap
        pf = p.replace(max_iter=cap, tol=-1.0) if fixed \
            else p.replace(max_iter=cap)
        return _segment_plain(u0, pf, phi0)

    phi, n_pix, sum_u, c1, c2 = _setup(u0, p, phi0)
    n, streak = 0, 0
    delta = torch.tensor(math.inf, dtype=u0.dtype, device=u0.device)
    delta_f = math.inf
    while (n < cap) if fixed else loop_continue(n, delta_f, streak, p, cap):
        phi, parts = fused_kernel.fused_iteration(phi, u0, c1, c2, p)
        c1, c2 = means_from_sums(parts[0], parts[1], sum_u, n_pix)
        delta = _delta_from_partials(parts, n_pix, p)
        if not fixed:
            delta_f = float(delta)
            streak = streak + 1 if bool(delta < p.tol) else 0
        n += 1
    return SegResult(phi, phi >= 0, n, delta, c1, c2)


def segment_fused_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                        phi0: Optional[torch.Tensor] = None,
                        lambda1=None, lambda2=None):
    """Fixed-iteration fused run. Returns (phi, mask)."""
    _check_ported(u0, p)
    p = _fold_scalar_lambdas(p, lambda1, lambda2)
    if not _routed(u0, p):
        phi = _phi0(u0, p, phi0)
        for _ in range(iters):
            phi = _step_plain(phi, u0, p)[0]
        return phi, phi >= 0
    phi, n_pix, sum_u, c1, c2 = _setup(u0, p, phi0)
    for _ in range(iters):
        phi, parts = fused_kernel.fused_iteration(phi, u0, c1, c2, p)
        c1, c2 = means_from_sums(parts[0], parts[1], sum_u, n_pix)
    return phi, phi >= 0
