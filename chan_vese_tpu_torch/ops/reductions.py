"""Global reductions: region means, energy, convergence norms.

Plain PyTorch counterparts of ``chan_vese_tpu/ops/reductions.py``, for
scalar (H, W) and vector-valued (H, W, C) images, and the multiphase
phase weights and means of ``chan_vese_tpu/models/multiphase.py``.
"""

from __future__ import annotations

import math

import torch

from .. import spans
from .numerics import dirac, grad_forward, heaviside


def region_sums(u0, phi, eps: float):
    """(sum_uH, sum_H, sum_u, n) with H = H_eps(phi).

    c1 = sum_uH / sum_H ; c2 = (sum_u - sum_uH) / (n - sum_H). For
    (H, W, C) u0 the per-channel sums have shape (C,).
    """
    h = heaviside(phi, eps)
    if u0.ndim == phi.ndim + 1:
        dims = tuple(range(phi.ndim))
        sum_uh = torch.sum(u0 * h[..., None], dim=dims)
        sum_u = torch.sum(u0, dim=dims)
    else:
        sum_uh = torch.sum(u0 * h)
        sum_u = torch.sum(u0)
    sum_h = torch.sum(h)
    with spans.span("cv.sync.region_n"):
        n = torch.tensor(phi.numel(), dtype=phi.dtype, device=phi.device)
    return sum_uh, sum_h, sum_u, n


def means_from_sums(sum_uh, sum_h, sum_u, n):
    """c1, c2 from region sums (safe against empty regions)."""
    c1 = sum_uh / torch.clamp_min(sum_h, 1e-30)
    c2 = (sum_u - sum_uh) / torch.clamp_min(n - sum_h, 1e-30)
    return c1, c2


def phase_weights(phis, eps: float):
    """The 2^M soft phase indicators w_s of M level sets (a stacked
    (M, H, W) tensor or a sequence of (H, W)), ordered by bitmask s (bit m
    set: inside phi_m, the H factor; else 1 - H). A list of (H, W)."""
    m_sets = len(phis)
    hs = [heaviside(phis[m], eps) for m in range(m_sets)]
    ws = []
    for s in range(2 ** m_sets):
        w = None
        for m in range(m_sets):
            factor = hs[m] if (s >> m) & 1 else (1.0 - hs[m])
            w = factor if w is None else w * factor
        ws.append(w)
    return ws


def phase_means(u0, phis, eps: float):
    """Means c_s of u0 over each soft phase (per channel for RGB), safe
    against empty phases. A list of 2^M."""
    cs = []
    for w in phase_weights(phis, eps):
        den = torch.clamp(torch.sum(w), min=1e-30)
        if u0.ndim == 3:
            num = torch.sum(u0 * w[..., None], dim=(0, 1))
        else:
            num = torch.sum(u0 * w)
        cs.append(num / den)
    return cs


def region_means(u0, phi, eps: float):
    """Region averages c1 (inside, phi >= 0 side) and c2 (outside)."""
    return means_from_sums(*region_sums(u0, phi, eps))


def _channel_weights(lam, u0):
    """Per-channel lambda (scalar or length-C sequence) as a (C,) tensor
    of u0's dtype."""
    lam = torch.as_tensor(lam, dtype=u0.dtype, device=u0.device)
    return lam.broadcast_to((u0.shape[-1],))


def data_term(u0, c1, c2, nu: float, lambda1, lambda2):
    """Pointwise data-fitting force.

    Scalar: f = -nu - lambda1 (u0 - c1)^2 + lambda2 (u0 - c2)^2.
    Vector-valued (u0 (H, W, C), c and lambda (C,)), Chan-Sandberg-Vese:
    f = -nu - mean_c l1[c] (u0-c1)[c]^2 + mean_c l2[c] (u0-c2)[c]^2.
    """
    if u0.ndim == 3:
        d1 = torch.mean(_channel_weights(lambda1, u0) * (u0 - c1) ** 2,
                        dim=-1)
        d2 = torch.mean(_channel_weights(lambda2, u0) * (u0 - c2) ** 2,
                        dim=-1)
        return -nu - d1 + d2
    return -nu - lambda1 * (u0 - c1) ** 2 + lambda2 * (u0 - c2) ** 2


def energy(u0, phi, c1, c2, p, lambda1=None, lambda2=None):
    """Chan-Vese energy F = mu sum delta|grad phi| + nu sum H
    + lambda1 sum (u0-c1)^2 H + lambda2 sum (u0-c2)^2 (1-H); for an
    (H, W, C) image the fitting terms average the per-channel weighted
    squared distances, as :func:`data_term` does."""
    l1 = p.lambda1 if lambda1 is None else lambda1
    l2 = p.lambda2 if lambda2 is None else lambda2
    h = heaviside(phi, p.eps)
    gx, gy = grad_forward(phi)
    length = torch.sum(dirac(phi, p.eps) * torch.sqrt(gx * gx + gy * gy))
    area = torch.sum(h)
    if u0.ndim == 3:
        l1, l2 = _channel_weights(l1, u0), _channel_weights(l2, u0)
        fit1 = torch.sum(torch.mean(l1 * (u0 - c1) ** 2, dim=-1) * h)
        fit2 = torch.sum(torch.mean(l2 * (u0 - c2) ** 2, dim=-1) * (1.0 - h))
        return p.mu * length + p.nu * area + fit1 + fit2
    fit1 = torch.sum((u0 - c1) ** 2 * h)
    fit2 = torch.sum((u0 - c2) ** 2 * (1.0 - h))
    return p.mu * length + p.nu * area + l1 * fit1 + l2 * fit2


def delta_norm(phi_new, phi_old, kind: str = "flips"):
    """Per-pixel convergence metric of the update.

    'flips' is the fraction of pixels whose mask sign changed. It is
    NaN-poisoned: comparisons against a NaN phi are all False, so
    0 * sum(d) turns the metric NaN when phi went non-finite, which
    :func:`loop_continue` treats as divergence.
    """
    d = phi_new - phi_old
    if kind == "flips":
        flipped = (phi_new >= 0) != (phi_old >= 0)
        return torch.mean(flipped.to(phi_new.dtype)) + 0.0 * torch.sum(d)
    if kind == "rms":
        return torch.sqrt(torch.mean(d * d))
    if kind == "mean_abs":
        return torch.mean(torch.abs(d))
    raise ValueError(f"unknown conv_norm {kind!r}")


def loop_continue(n: int, delta: float, streak: int, p,
                  max_iter=None) -> bool:
    """Shared tolerance-loop predicate of the drivers (host values).

    Continue while under the cap, not converged (``streak`` >=
    ``p.patience`` below-tol iterations and ``n`` >= ``p.min_iter``) and
    not diverged (a non-finite delta after iteration 0; the initial delta
    is +inf by convention).
    """
    cap = p.max_iter if max_iter is None else max_iter
    done = streak >= p.patience and n >= p.min_iter
    diverged = n > 0 and not math.isfinite(delta)
    return n < cap and not (done or diverged)
