"""Chan-Vese drivers in plain PyTorch, for grayscale (H, W) and
vector-valued (H, W, C) images alike.

Counterpart of ``chan_vese_tpu/models/scalar.py``. The outer iteration is a
host loop whose body launches device work. Per iteration:

    c1, c2 = region_means(u0, phi)
    f      = data_term(u0, c1, c2, ...)
    phi    = semi_implicit_step(phi, f)
    delta  = ||phi' - phi|| per pixel
    phi    = maybe_reinit(phi, n)          # every p.reinit_every iterations

The tolerance loop reads delta back once per iteration to decide whether
to stop.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops.reductions import (data_term, delta_norm, energy, loop_continue,
                              region_means)
from ..ops.reinit import maybe_reinit
from ..ops.sweep import semi_implicit_step
from ..params import CVParams
from ..utils.init_phi import init_phi


class SegResult(NamedTuple):
    phi: torch.Tensor     # final level set (H, W)
    mask: torch.Tensor    # phi >= 0 (bool)
    iters: int            # iterations actually run
    delta: torch.Tensor   # final per-pixel update norm
    c1: torch.Tensor      # inside mean(s)
    c2: torch.Tensor      # outside mean(s)


class SegTrace(NamedTuple):
    phi: torch.Tensor
    mask: torch.Tensor
    energy: torch.Tensor  # (iters,) energy after each iteration
    delta: torch.Tensor   # (iters,) update norm of each iteration
    c1: torch.Tensor      # (iters,) means used by each iteration
    c2: torch.Tensor


def step(phi, u0, p: CVParams, lambda1=None, lambda2=None, parity: int = 0):
    """One full Chan-Vese iteration; returns (phi_new, c1, c2, delta).
    lambda1/lambda2 may be per-channel tuples for an (H, W, C) image."""
    c1, c2 = region_means(u0, phi, p.eps)
    l1 = p.lambda1 if lambda1 is None else torch.as_tensor(
        lambda1, dtype=phi.dtype, device=phi.device)
    l2 = p.lambda2 if lambda2 is None else torch.as_tensor(
        lambda2, dtype=phi.dtype, device=phi.device)
    f = data_term(u0, c1, c2, p.nu, l1, l2)
    phi_new = semi_implicit_step(phi, f, p, parity)
    return phi_new, c1, c2, delta_norm(phi_new, phi, p.conv_norm)


def _phi0(u0, p: CVParams, phi0):
    if phi0 is None:
        return init_phi(u0.shape[:2], p.init, u0.dtype, device=u0.device)
    return phi0


def segment(u0, p: CVParams = CVParams(), phi0: Optional[torch.Tensor] = None,
            lambda1=None, lambda2=None) -> SegResult:
    """Segment to convergence (per-pixel tol) or max_iter."""
    phi = _phi0(u0, p, phi0)
    n, streak = 0, 0
    delta = torch.tensor(math.inf, dtype=u0.dtype, device=u0.device)
    delta_f = math.inf
    while loop_continue(n, delta_f, streak, p):
        phi, _, _, delta = step(phi, u0, p, lambda1, lambda2)
        phi = maybe_reinit(phi, n, p)
        delta_f = float(delta)
        # compared in delta's dtype, as the reference's device loop does
        streak = streak + 1 if bool(delta < p.tol) else 0
        n += 1
    c1, c2 = region_means(u0, phi, p.eps)
    return SegResult(phi, phi >= 0, n, delta, c1, c2)


def segment_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                  phi0: Optional[torch.Tensor] = None,
                  lambda1=None, lambda2=None, start_iter=0) -> SegTrace:
    """Fixed-iteration run returning the per-iteration energy trace
    (energy after each sweep, with means recomputed from the post-sweep
    phi, before the redistance). ``start_iter`` is the index of the first
    iteration, which shifts the reinit cadence."""
    phi = _phi0(u0, p, phi0)
    es, ds, c1s, c2s = [], [], [], []
    for n in range(start_iter, start_iter + iters):
        phi, c1, c2, delta = step(phi, u0, p, lambda1, lambda2)
        c1n, c2n = region_means(u0, phi, p.eps)
        es.append(energy(u0, phi, c1n, c2n, p, lambda1, lambda2))
        phi = maybe_reinit(phi, n, p)
        ds.append(delta)
        c1s.append(c1)
        c2s.append(c2)
    stack = (lambda xs: torch.stack(xs) if xs
             else torch.empty(0, dtype=u0.dtype, device=u0.device))
    return SegTrace(phi, phi >= 0, stack(es), stack(ds), stack(c1s),
                    stack(c2s))
