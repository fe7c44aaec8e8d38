"""Numerics primitives: regularized Heaviside/Dirac, stencils, curvature.

Plain PyTorch counterparts of ``chan_vese_tpu/ops/numerics.py``, on (H, W)
tensors of any float dtype and device. Neumann boundary conditions are
clamped-index (edge-replicate) reads; the backward face coefficients follow
the replica-eval convention: every out-of-range VALUE read clamps to the
edge, so out-of-range differences vanish.
"""

from __future__ import annotations

import math

import torch


def heaviside(z, eps: float):
    """Regularized Heaviside H_eps(z) = 1/2 (1 + (2/pi) atan(z/eps))."""
    return 0.5 * (1.0 + (2.0 / math.pi) * torch.atan(z / eps))


def dirac(z, eps: float):
    """Regularized Dirac delta_eps(z) = (1/pi) eps / (eps^2 + z^2)."""
    return (eps / math.pi) / (eps * eps + z * z)


# shift_*(x)[i, j] == x[clamp(i +/- 1), clamp(j +/- 1)]: the value of the
# neighbor in that direction under clamped indexing.

def shift_up(x):
    """y[i, j] = x[max(i - 1, 0), j]  (north neighbor)."""
    return torch.cat([x[:1], x[:-1]], dim=0)


def shift_down(x):
    """y[i, j] = x[min(i + 1, H - 1), j]  (south neighbor)."""
    return torch.cat([x[1:], x[-1:]], dim=0)


def shift_left(x):
    """y[i, j] = x[i, max(j - 1, 0)]  (west neighbor)."""
    return torch.cat([x[:, :1], x[:, :-1]], dim=1)


def shift_right(x):
    """y[i, j] = x[i, min(j + 1, W - 1)]  (east neighbor)."""
    return torch.cat([x[:, 1:], x[:, -1:]], dim=1)


def neumann_pad(x, depth: int = 1):
    """Edge-replicate pad by ``depth`` on both spatial axes."""
    h, w = x.shape
    ri = torch.arange(-depth, h + depth, device=x.device).clamp(0, h - 1)
    ci = torch.arange(-depth, w + depth, device=x.device).clamp(0, w - 1)
    return x[ri][:, ci]


def grad_forward(phi):
    """Forward differences (D+x, D+y) with clamped last row/col (=> 0)."""
    return shift_down(phi) - phi, shift_right(phi) - phi


def grad_central(phi):
    """Central differences with clamped-index boundary handling."""
    gx = 0.5 * (shift_down(phi) - shift_up(phi))
    gy = 0.5 * (shift_right(phi) - shift_left(phi))
    return gx, gy


def curvature(phi, eta2: float):
    """Curvature kappa = div(grad phi / |grad phi|) in the linearized
    neighbor-coefficient form the semi-implicit sweep uses."""
    A, B, Am, Bm = face_coeffs_all(phi, 1.0, eta2)
    return (A * (shift_down(phi) - phi)
            + Am * (shift_up(phi) - phi)
            + B * (shift_right(phi) - phi)
            + Bm * (shift_left(phi) - phi))


def face_coeffs(phi, mu: float, eta2: float):
    """Forward half-point coefficients A (face (i+1/2, j)) and B
    (face (i, j+1/2)) of the scheme."""
    A, B, _, _ = face_coeffs_all(phi, mu, eta2)
    return A, B


def face_coeffs_backward(phi, mu: float, eta2: float):
    """Backward coefficients A- (= A at (i-1/2, j)) and B-, replica-eval:
    at i = 0 the forward difference vanishes and the central term is row
    0's."""
    _, _, Am, Bm = face_coeffs_all(phi, mu, eta2)
    return Am, Bm


def face_coeffs_all(phi, mu: float, eta2: float):
    """All four face coefficients; A-/B- are shifts of A/B with the
    replica-eval first row/col."""
    dxp = shift_down(phi) - phi
    dyp = shift_right(phi) - phi
    dx0 = 0.5 * (shift_down(phi) - shift_up(phi))
    dy0 = 0.5 * (shift_right(phi) - shift_left(phi))
    A = mu / torch.sqrt(eta2 + dxp * dxp + dy0 * dy0)
    B = mu / torch.sqrt(eta2 + dx0 * dx0 + dyp * dyp)
    am0 = mu / torch.sqrt(eta2 + dy0[:1] * dy0[:1])
    Am = torch.cat([am0, A[:-1]], dim=0)
    bm0 = mu / torch.sqrt(eta2 + dx0[:, :1] * dx0[:, :1])
    Bm = torch.cat([bm0, B[:, :-1]], dim=1)
    return A, B, Am, Bm
