"""Vector-valued (multichannel / RGB) Chan-Vese.

Counterpart of ``chan_vese_tpu/models/vector.py`` (Chan, Sandberg & Vese
2000): one shared level set phi, per-channel means c1[c], c2[c], and
per-channel weights lambda1[c], lambda2[c]; the fitting force averages
over channels:

    f = -nu - (1/C) sum_c l1[c] (u0[c]-c1[c])^2
            + (1/C) sum_c l2[c] (u0[c]-c2[c])^2

The plain drivers of :mod:`.scalar` already take (H, W, C) images; this
module is the documented vector-valued API with the per-channel weight
plumbing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..params import CVParams
from .scalar import SegResult, SegTrace, segment, segment_fixed


def _norm_lambdas(u0, lambda1, lambda2, p: CVParams
                  ) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    if u0.ndim != 3:
        raise ValueError(f"vector-valued input must be (H, W, C), got "
                         f"{tuple(u0.shape)}")
    return p.channel_lambdas(u0.shape[-1], lambda1, lambda2)


def segment_vector(u0, p: CVParams = CVParams(),
                   phi0: Optional[torch.Tensor] = None,
                   lambda1: Optional[Sequence[float]] = None,
                   lambda2: Optional[Sequence[float]] = None) -> SegResult:
    """Segment an (H, W, C) image with per-channel lambda weights."""
    l1, l2 = _norm_lambdas(u0, lambda1, lambda2, p)
    return segment(u0, p, phi0, lambda1=l1, lambda2=l2)


def segment_vector_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                         phi0: Optional[torch.Tensor] = None,
                         lambda1: Optional[Sequence[float]] = None,
                         lambda2: Optional[Sequence[float]] = None,
                         start_iter=0) -> SegTrace:
    """Fixed-iteration vector-valued segmentation with energy trace."""
    l1, l2 = _norm_lambdas(u0, lambda1, lambda2, p)
    return segment_fixed(u0, p, iters, phi0, lambda1=l1, lambda2=l2,
                         start_iter=start_iter)
