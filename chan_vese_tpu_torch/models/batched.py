"""Fixed-iteration segmentation of (N, H, W) grayscale stacks: what the
resident stack driver runs off its envelope.

Counterpart of ``chan_vese_tpu/models/batched.py`` (``segment_stack_fixed``
and ``segment_stack_fused_fixed``). The reference vectorizes the frames
(``vmap``, or K1's batch grid axis); frames are independent, so here each
frame runs on its own and the values per frame are the same. K1's batch
mode, which replaces the per-frame loop of the fused driver, is ROADMAP
M8.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import fused_kernel
from ..params import CVParams
from .scalar import _check_ported, _phi0, step


def _stack_phi0(u0, p: CVParams, phi0):
    if phi0 is None:
        # contiguous: each frame goes to the kernels as it is
        return _phi0(u0[0], p, None).expand(u0.shape[:3]).contiguous()
    return phi0


def segment_stack_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                        phi0: Optional[torch.Tensor] = None,
                        lambda1=None, lambda2=None):
    """Fixed-iteration plain segmentation of every frame of an
    (N, H, W[, C]) stack. Returns (phi, mask)."""
    _check_ported(u0, p)
    phis = []
    for u, phi in zip(u0, _stack_phi0(u0, p, phi0)):
        for _ in range(iters):
            phi = step(phi, u, p, lambda1, lambda2)[0]
        phis.append(phi)
    phis = torch.stack(phis)
    return phis, phis >= 0


def segment_stack_fused_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                              phi0: Optional[torch.Tensor] = None):
    """Fixed-iteration segmentation of an (N, H, W) stack through the
    fused kernel (K1), frame by frame; shapes off the fused envelope and
    other sweep orders run :func:`segment_stack_fixed`. Returns
    (phi, mask)."""
    from .fused import segment_fused_fixed

    _check_ported(u0, p)
    N, H, W = u0.shape
    if not fused_kernel.supports(H, W) or p.order != "redblack":
        return segment_stack_fixed(u0, p, iters, phi0)
    phis = torch.stack([
        segment_fused_fixed(u, p, iters, phi)[0]
        for u, phi in zip(u0, _stack_phi0(u0, p, phi0))])
    return phis, phis >= 0
