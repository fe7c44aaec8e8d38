"""Semi-implicit level-set sweeps (plain PyTorch).

Counterparts of ``chan_vese_tpu/ops/sweep.py``: one update expression,
three schedules (jacobi, red-black, wavefront = exact raster Gauss-Seidel).

    phi'[i,j] = ( phi + dt d ( A phi[i+1,j] + A- phi[i-1,j]
                + B phi[i,j+1] + B- phi[i,j-1] + f ) )
              / ( 1 + dt d (A + A- + B + B-) ),   d = delta_eps(phi[i,j])
"""

from __future__ import annotations

import torch

from .numerics import (dirac, face_coeffs_all, shift_down, shift_left,
                       shift_right, shift_up)


def _update_all(phi, f, mu, dt, eps, eta2):
    """The semi-implicit update evaluated at every cell from ``phi``."""
    A, B, Am, Bm = face_coeffs_all(phi, mu, eta2)
    d = dirac(phi, eps)
    num = phi + dt * d * (A * shift_down(phi) + Am * shift_up(phi)
                          + B * shift_right(phi) + Bm * shift_left(phi) + f)
    den = 1.0 + dt * d * (A + Am + B + Bm)
    return num / den


def color_masks(shape, parity: int = 0, dtype=torch.bool, device=None):
    """Red mask ((i + j + parity) % 2 == 0) in global coordinates."""
    i = torch.arange(shape[0], device=device)[:, None]
    j = torch.arange(shape[1], device=device)[None, :]
    return (((i + j + parity) % 2) == 0).to(dtype)


def jacobi_step(phi, f, p):
    """Fully parallel semi-implicit update (all neighbors old)."""
    return _update_all(phi, f, p.mu, p.dt, p.eps, p.eta2)


def redblack_step(phi, f, p, parity: int = 0):
    """Red half-sweep from old values, then black from red-new values."""
    red = color_masks(phi.shape, parity, device=phi.device)
    phi = torch.where(red, _update_all(phi, f, p.mu, p.dt, p.eps, p.eta2),
                      phi)
    return torch.where(red, phi,
                       _update_all(phi, f, p.mu, p.dt, p.eps, p.eta2))


def wavefront_step(phi, f, p):
    """Exact sequential raster Gauss-Seidel via skewed diagonals
    d = 2i + j. O((2H + W) * H * W) work: parity tests and small grids."""
    h, w = phi.shape
    i = torch.arange(h, device=phi.device)[:, None]
    j = torch.arange(w, device=phi.device)[None, :]
    diag = 2 * i + j
    for d in range(2 * (h - 1) + (w - 1) + 1):
        upd = _update_all(phi, f, p.mu, p.dt, p.eps, p.eta2)
        phi = torch.where(diag == d, upd, phi)
    return phi


def semi_implicit_step(phi, f, p, parity: int = 0):
    """Dispatch on p.order ('redblack' | 'jacobi' | 'wavefront')."""
    if p.order == "redblack":
        return redblack_step(phi, f, p, parity)
    if p.order == "jacobi":
        return jacobi_step(phi, f, p)
    if p.order == "wavefront":
        return wavefront_step(phi, f, p)
    raise ValueError(f"unknown sweep order {p.order!r}")
