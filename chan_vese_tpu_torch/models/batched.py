"""Segmentation of frame stacks (N, H, W[, C]): video and microscopy time
series, every frame its own image.

Counterpart of ``chan_vese_tpu/models/batched.py``. The reference
vectorizes the frames (``vmap``); frames are independent, so here:

- :func:`segment_batch` (tolerance mode) runs :func:`.scalar.segment` on
  each frame and stacks the results, per-frame ``iters``, ``delta``,
  ``c1``, ``c2``. Under ``vmap`` the reference's while loop keeps a
  finished frame's carry, so its per-frame results are the per-frame
  runs' too (``tests/test_torch_batched.py``).
- :func:`segment_stack_fixed` runs the plain step on each frame.
- :func:`segment_stack_fused_fixed` runs K1's batch mode: one
  :func:`..ops.fused_kernel.fused_iteration_batch` per iteration over every
  frame, the next means per frame from its partials on the device, no
  device-to-host read in the loop. It is what the resident stack driver
  runs off its envelope.

With ``p.reinit_every > 0`` each frame is redistanced on its own cadence
(one R1 chain for the stack on the card), and the batch route takes every
frame's means anew after a redistance, from the partials otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import fused_kernel
from ..ops.reductions import means_from_sums, region_means
from ..ops.reinit import maybe_reinit, reinit_fires
from ..params import CVParams
from .scalar import SegResult, _phi0, segment, step


def _stack_phi0(u0, p: CVParams, phi0):
    if phi0 is None:
        # contiguous: each frame goes to the kernels as it is
        return _phi0(u0[0], p, None).expand(u0.shape[:3]).contiguous()
    return phi0


def _frame_means(u0, phis, eps: float):
    """(c1, c2) of every frame, stacked: the smooth-Heaviside region
    means of each frame's level set."""
    return (torch.stack(c) for c in zip(*(
        region_means(u, phi, eps) for u, phi in zip(u0, phis))))


def segment_batch(u0, p: CVParams = CVParams(),
                  phi0: Optional[torch.Tensor] = None,
                  lambda1=None, lambda2=None) -> SegResult:
    """Tolerance-mode segmentation of every frame of an (N, H, W[, C])
    stack. Returns a SegResult with a leading frame axis on every field:
    ``iters`` is an (N,) int64 tensor of per-frame iteration counts."""
    runs = [segment(u, p, phi, lambda1=lambda1, lambda2=lambda2)
            for u, phi in zip(u0, _stack_phi0(u0, p, phi0))]
    phi = torch.stack([r.phi for r in runs])
    return SegResult(
        phi, phi >= 0,
        torch.tensor([r.iters for r in runs], dtype=torch.int64,
                     device=u0.device),
        torch.stack([r.delta for r in runs]),
        torch.stack([r.c1 for r in runs]), torch.stack([r.c2 for r in runs]))


def segment_stack_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                        phi0: Optional[torch.Tensor] = None,
                        lambda1=None, lambda2=None):
    """Fixed-iteration plain segmentation of every frame of an
    (N, H, W[, C]) stack. Returns (phi, mask)."""
    phis = []
    for u, phi in zip(u0, _stack_phi0(u0, p, phi0)):
        for n in range(iters):
            phi = maybe_reinit(step(phi, u, p, lambda1, lambda2)[0], n, p)
        phis.append(phi)
    phis = torch.stack(phis)
    return phis, phis >= 0


def segment_stack_fused_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                              phi0: Optional[torch.Tensor] = None):
    """Fixed-iteration segmentation of an (N, H, W) stack through K1's
    batch mode, one launch per iteration for all frames; shapes off the
    fused envelope and other sweep orders run :func:`segment_stack_fixed`.
    Returns (phi, mask)."""
    N, H, W = u0.shape
    if not fused_kernel.supports(H, W) or p.order != "redblack":
        return segment_stack_fixed(u0, p, iters, phi0)
    phis = _stack_phi0(u0, p, phi0)
    n_pix = torch.tensor(H * W, dtype=u0.dtype, device=u0.device)
    sum_u = torch.sum(u0, dim=(1, 2))
    c1, c2 = _frame_means(u0, phis, p.eps)
    for n in range(iters):
        phis, parts = fused_kernel.fused_iteration_batch(phis, u0, c1, c2, p)
        c1, c2 = means_from_sums(parts[:, 0], parts[:, 1], sum_u, n_pix)
        if reinit_fires(n, p):
            # every frame redistanced on its own (one R1 chain for the
            # stack), the means of every frame taken anew
            phis = maybe_reinit(phis, n, p)
            c1, c2 = _frame_means(u0, phis, p.eps)
    return phis, phis >= 0
