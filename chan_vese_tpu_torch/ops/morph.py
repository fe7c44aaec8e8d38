"""Morphological Chan-Vese (MorphACWE) and geodesic active contour
(MorphGAC) operators in plain PyTorch.

Counterparts of ``chan_vese_tpu/ops/morph.py``, on (H, W) tensors of any
float dtype and device (the level set is a float plane of {0.0, 1.0}).
Edge convention: replica-eval Neumann (``ops/numerics.py`` ``shift_*``),
not ``scipy.ndimage``'s ``border_value=0``. The four length-3 line
structuring elements give ``sup_inf`` (max of the line erosions) and
``inf_sup`` (min of the line dilations); ``cycle_op`` alternates
SIoIS / ISoSI on the parity of a Python int call counter.

Every operator is a shift, min/max, compare or select, so on a binary
state the values equal the reference's bit for bit in any dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .numerics import (grad_central, shift_down, shift_left, shift_right,
                       shift_up)


def _neighbors8(u):
    """The 8 replica-clamped neighbor planes of u (diagonals compose two
    axis shifts)."""
    up, dn = shift_up(u), shift_down(u)
    lf, rt = shift_left(u), shift_right(u)
    ul, ur = shift_left(up), shift_right(up)
    dl, dr = shift_left(dn), shift_right(dn)
    return up, dn, lf, rt, ul, ur, dl, dr


def sup_inf(u):
    """max over the 4 line SEs of the erosion (min) along that line."""
    up, dn, lf, rt, ul, ur, dl, dr = _neighbors8(u)
    m = torch.minimum
    e_h = m(m(lf, rt), u)
    e_v = m(m(up, dn), u)
    e_d = m(m(ul, dr), u)   # main diagonal
    e_a = m(m(ur, dl), u)   # anti-diagonal
    return torch.maximum(torch.maximum(e_h, e_v), torch.maximum(e_d, e_a))


def inf_sup(u):
    """min over the 4 line SEs of the dilation (max) along that line."""
    up, dn, lf, rt, ul, ur, dl, dr = _neighbors8(u)
    m = torch.maximum
    d_h = m(m(lf, rt), u)
    d_v = m(m(up, dn), u)
    d_d = m(m(ul, dr), u)
    d_a = m(m(ur, dl), u)
    return torch.minimum(torch.minimum(d_h, d_v), torch.minimum(d_d, d_a))


def cycle_op(u, k: int):
    """One smoothing call: SIoIS when the call counter k is even, ISoSI
    when odd (the scheme's global operator cycling)."""
    if k % 2 == 0:
        return sup_inf(inf_sup(u))
    return inf_sup(sup_inf(u))


def smooth(u, k: int, smoothing: int):
    """``smoothing`` consecutive cycle_op calls, the counter advancing by
    one per call (iteration n with smoothing s starts at k = n * s)."""
    for i in range(smoothing):
        u = cycle_op(u, k + i)
    return u


def binary_means(img, u, tiny: float = 1e-8):
    """Region means of ``img`` inside (u == 1) and outside (u == 0).

    img: (H, W) or (H, W, C); returns 0-d tensors or (C,) vectors. The
    ``tiny`` guard keeps an empty region's mean finite (0)."""
    w = u[..., None] if img.ndim == 3 else u
    n_in = torch.sum(u)
    n_out = torch.sum(1.0 - u)
    c_in = torch.sum(img * w, dim=(0, 1)) / (n_in + tiny)
    c_out = torch.sum(img * (1.0 - w), dim=(0, 1)) / (n_out + tiny)
    return c_in, c_out


def acwe_force(img, c_in, c_out, lambda1, lambda2):
    """f = lambda1 (img - c_in)^2 - lambda2 (img - c_out)^2, summed over
    channels for an (H, W, C) image: the ACWE data force."""
    f = lambda1 * (img - c_in) ** 2 - lambda2 * (img - c_out) ** 2
    return torch.sum(f, dim=-1) if img.ndim == 3 else f


def acwe_force_step(u, f):
    """Move the pixels where the level set has a nonzero discrete gradient
    by the sign of the force f: f < 0 -> 1, f > 0 -> 0, else keep (a NaN
    force keeps the pixel). Central differences with replica edges; only
    zero against nonzero matters."""
    gx = shift_down(u) - shift_up(u)
    gy = shift_right(u) - shift_left(u)
    aux = (torch.abs(gx) + torch.abs(gy)) * f
    one = torch.ones((), dtype=u.dtype, device=u.device)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    return torch.where(aux < 0, one, torch.where(aux > 0, zero, u))


def acwe_step(u, img, c_in, c_out, lambda1, lambda2):
    """The discrete ACWE data-force step with the means c_in, c_out."""
    return acwe_force_step(u, acwe_force(img, c_in, c_out, lambda1, lambda2))


def acwe_energy(img, u, c_in, c_out, lambda1, lambda2):
    """Piecewise-constant ACWE data energy (no length term)."""
    e = lambda1 * (img - c_in) ** 2 * (u[..., None] if img.ndim == 3
                                       else u)
    e2 = lambda2 * (img - c_out) ** 2 * ((1.0 - u)[..., None]
                                         if img.ndim == 3 else (1.0 - u))
    return torch.sum(e) + torch.sum(e2)


# ---------------------------------------------------------------------------
# MorphGAC operators
# ---------------------------------------------------------------------------

def _edge_rows(x, r: int):
    """x edge-padded by r rows on both sides."""
    idx = torch.arange(-r, x.shape[0] + r, device=x.device)
    return x[idx.clamp(0, x.shape[0] - 1)]


def gaussian_blur(img, sigma: float, truncate: float = 4.0):
    """Separable Gaussian blur with replica (edge) boundaries: the
    discretised Gaussian of scipy.ndimage (exp(-x^2 / (2 sigma^2)) over
    x in [-r, r], r = int(truncate sigma + 0.5), normalised to sum 1, the
    weights built in numpy float64), summed per axis in the reference's
    order. (H, W) planes."""
    sigma = float(sigma)
    if sigma <= 0:
        return img
    r = int(truncate * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    w = (w / w.sum()).astype(np.float64)
    wt = [torch.tensor(v, dtype=img.dtype, device=img.device) for v in w]
    H, W = img.shape
    pad = _edge_rows(img, r)
    out = sum(wt[d + r] * pad[d + r:d + r + H] for d in range(-r, r + 1))
    pad = _edge_rows(out.T, r).T
    return sum(wt[d + r] * pad[:, d + r:d + r + W] for d in range(-r, r + 1))


def inverse_gaussian_gradient(img, alpha: float = 100.0,
                              sigma: float = 5.0):
    """Edge-stopping map g = 1 / sqrt(1 + alpha |grad(G_sigma * img)|):
    central differences of the blurred plane with replica edges; an
    (H, W, C) image takes the per-channel gradients' root sum of
    squares."""
    if img.ndim == 3:
        mag2 = 0.0
        for c in range(img.shape[-1]):
            gx, gy = grad_central(gaussian_blur(img[..., c], sigma))
            mag2 = mag2 + gx * gx + gy * gy
    else:
        gx, gy = grad_central(gaussian_blur(img, sigma))
        mag2 = gx * gx + gy * gy
    return 1.0 / torch.sqrt(1.0 + alpha * torch.sqrt(mag2))


def dilate8(u):
    """Binary dilation by the full 3x3 structuring element."""
    up, dn, lf, rt, ul, ur, dl, dr = _neighbors8(u)
    m = torch.maximum
    return m(m(m(up, dn), m(lf, rt)), m(m(ul, ur), m(m(dl, dr), u)))


def erode8(u):
    """Binary erosion by the full 3x3 structuring element."""
    up, dn, lf, rt, ul, ur, dl, dr = _neighbors8(u)
    m = torch.minimum
    return m(m(m(up, dn), m(lf, rt)), m(m(ul, ur), m(m(dl, dr), u)))


def gac_step(u, dgx, dgy, balloon_mask, balloon: int):
    """One MorphGAC force iteration (balloon, then attraction), no
    smoothing. ``balloon``: +1 dilates, -1 erodes, 0 skips, applied where
    ``balloon_mask`` > 0; then aux = dg . du (central differences, replica
    edges): aux > 0 -> 1, aux < 0 -> 0, ties keep their value."""
    if balloon > 0:
        u = torch.where(balloon_mask > 0, dilate8(u), u)
    elif balloon < 0:
        u = torch.where(balloon_mask > 0, erode8(u), u)
    dux = 0.5 * (shift_down(u) - shift_up(u))
    duy = 0.5 * (shift_right(u) - shift_left(u))
    aux = dgx * dux + dgy * duy
    one = torch.ones((), dtype=u.dtype, device=u.device)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    return torch.where(aux > 0, one, torch.where(aux < 0, zero, u))


def padded_iteration(u, aux, j: int, kind: str, smoothing: int, parity0: int,
                     balloon: int = 0, rim=None):
    """Iteration j of a chunk on a shard's padded block, with ``rim`` (the
    global-edge replica refresh) applied before every elementary op: the
    force step for ``kind`` 'acwe' (aux the force f), or for 'gac' (aux
    the (dgx, dgy, balloon mask) stack) the balloon op where ``balloon``
    is set and the attraction; then ``smoothing`` cycles, cycle c SIoIS
    when (parity0 + j smoothing + c) is even. The counterpart of
    ``chan_vese_tpu/ops/pallas_morph.py::_iterate`` with its ``rim``
    callback and of the jnp chunk body of
    ``chan_vese_tpu/parallel/sharded_morph.py``."""
    r = rim if rim is not None else (lambda x: x)
    if kind == "acwe":
        u = acwe_force_step(r(u), aux)
    else:
        dgx, dgy, mask = aux[0], aux[1], aux[2]
        if balloon:
            u = r(u)
            u = torch.where(mask > 0, dilate8(u) if balloon > 0
                            else erode8(u), u)
        u = gac_step(r(u), dgx, dgy, mask, 0)  # the attraction alone
    for c in range(smoothing):
        if (parity0 + j * smoothing + c) % 2 == 0:
            u = sup_inf(r(inf_sup(r(u))))
        else:
            u = inf_sup(r(sup_inf(r(u))))
    return u
