"""The Chan-Vese scheme in plain PyTorch, written from the JAX package's
jnp path (``ops/numerics.py``, ``ops/sweep.py``, ``ops/reductions.py``,
``utils/init_phi.py``) as a pattern: read, not imported. It imports
nothing of the program under test.

Every function takes (..., H, W) tensors: a leading axis of frames is
carried through, and the sums behind the region means are taken per
frame. Neumann boundaries are clamped-index reads. Every operation runs
in the dtype of its inputs (the sums behind the means accumulate in
float64), so the same code is the float32 reference and, on bfloat16
inputs, the control.
"""

from __future__ import annotations

import math

import torch


def heaviside(z, eps: float):
    """H_eps(z) = 1/2 (1 + (2/pi) atan(z / eps))."""
    return 0.5 * (1.0 + (2.0 / math.pi) * torch.atan(z / eps))


def dirac(z, eps: float):
    """delta_eps(z) = (eps / pi) / (eps^2 + z^2)."""
    return (eps / math.pi) / (eps * eps + z * z)


def _north(x):
    return torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)


def _south(x):
    return torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)


def _west(x):
    return torch.cat([x[..., :, :1], x[..., :, :-1]], dim=-1)


def _east(x):
    return torch.cat([x[..., :, 1:], x[..., :, -1:]], dim=-1)


def update(phi, f, p):
    """The semi-implicit update of every cell from ``phi``:

        phi' = (phi + dt d (A phi_S + A- phi_N + B phi_E + B- phi_W + f))
               / (1 + dt d (A + A- + B + B-)),   d = delta_eps(phi),

    A, B the forward face coefficients mu / sqrt(eta2 + ...) and A-, B-
    the same faces seen from the next cell, with the first row's (column's)
    A- (B-) taken from its own central difference alone."""
    s, n, e, w = _south(phi), _north(phi), _east(phi), _west(phi)
    dxp, dyp = s - phi, e - phi
    dx0, dy0 = 0.5 * (s - n), 0.5 * (e - w)
    mu, eta2 = p["mu"], p["eta2"]
    a = mu / torch.sqrt(eta2 + dxp * dxp + dy0 * dy0)
    b = mu / torch.sqrt(eta2 + dx0 * dx0 + dyp * dyp)
    a_first = mu / torch.sqrt(eta2 + dy0[..., :1, :] * dy0[..., :1, :])
    am = torch.cat([a_first, a[..., :-1, :]], dim=-2)
    b_first = mu / torch.sqrt(eta2 + dx0[..., :, :1] * dx0[..., :, :1])
    bm = torch.cat([b_first, b[..., :, :-1]], dim=-1)
    d = p["dt"] * dirac(phi, p["eps"])
    num = phi + d * (a * s + am * n + b * e + bm * w + f)
    return num / (1.0 + d * (a + am + b + bm))


def red_cells(h: int, w: int, device):
    """True where (i + j) is even: the half updated first."""
    i = torch.arange(h, device=device)[:, None]
    j = torch.arange(w, device=device)[None, :]
    return (i + j) % 2 == 0


def redblack(phi, f, p, red):
    """One iteration: the red half from the old values, then the black
    half from the red half's new ones."""
    phi = torch.where(red, update(phi, f, p), phi)
    return torch.where(red, phi, update(phi, f, p))


def initial_phi(shape, init: str, dtype, device):
    """The level set a run starts from, on an (H, W) grid: the
    checkerboard sin(pi i / 5) sin(pi j / 5), or the signed distance to the
    centred circle of radius min(H, W) / 4, positive inside."""
    h, w = shape
    i = torch.arange(h, device=device).to(dtype)[:, None]
    j = torch.arange(w, device=device).to(dtype)[None, :]
    if init == "checkerboard":
        return torch.sin(i * (math.pi / 5.0)) * torch.sin(j * (math.pi / 5.0))
    if init in ("circle", "disk"):
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        return min(h, w) / 4.0 - torch.sqrt((i - cy) ** 2 + (j - cx) ** 2)
    raise ValueError(f"the reference knows no init {init!r}")


def region_means(u, phi, eps: float):
    """(c1, c2): the smooth-Heaviside means inside (phi >= 0 side) and
    outside, per frame and per channel. ``u`` is (..., H, W) for a gray
    image and (..., C, H, W) channels-first for a C-channel one; the means
    have u's shape without its last two axes. The sums accumulate in
    float64 and the means return in phi's dtype."""
    h = heaviside(phi, eps)
    wide = torch.float64
    sum_h = torch.sum(h, dim=(-2, -1), dtype=wide)
    if u.dim() > phi.dim():
        h = h.unsqueeze(-3)
        sum_h = sum_h.unsqueeze(-1)
    sum_uh = torch.sum(u * h, dim=(-2, -1), dtype=wide)
    sum_u = torch.sum(u, dim=(-2, -1), dtype=wide)
    n = phi.shape[-2] * phi.shape[-1]
    c1 = sum_uh / torch.clamp_min(sum_h, 1e-30)
    c2 = (sum_u - sum_uh) / torch.clamp_min(n - sum_h, 1e-30)
    return c1.to(phi.dtype), c2.to(phi.dtype)


def force(u, c1, c2, p, lambda1, lambda2):
    """The data term f = -nu - l1 (u - c1)^2 + l2 (u - c2)^2 for a gray
    image (float weights; a mean per frame); for a channels-first image
    (weights as sequences of C) the channel mean of the weighted squares
    (Chan-Sandberg-Vese)."""
    c1, c2 = c1[..., None, None], c2[..., None, None]
    if not isinstance(lambda1, (list, tuple)):
        return (-p["nu"] - lambda1 * (u - c1) ** 2
                + lambda2 * (u - c2) ** 2)
    shape = (-1, 1, 1)
    l1 = torch.tensor(lambda1, dtype=u.dtype, device=u.device).reshape(shape)
    l2 = torch.tensor(lambda2, dtype=u.dtype, device=u.device).reshape(shape)
    d1 = torch.mean(l1 * (u - c1) ** 2, dim=-3)
    d2 = torch.mean(l2 * (u - c2) ** 2, dim=-3)
    return -p["nu"] - d1 + d2


def channels_first(u):
    """A gray (H, W) image as it is; an (H, W, C) one as (C, H, W)."""
    return u.permute(2, 0, 1).contiguous() if u.dim() == 3 else u


def weights(p, nchan):
    """(lambda1, lambda2): floats for a gray image, tuples of C for a
    C-channel one (a scalar broadcast to every channel)."""
    def per_channel(lam):
        if isinstance(lam, (list, tuple)):
            if len(lam) != nchan:
                raise ValueError(f"{len(lam)} weights for {nchan} channels")
            return tuple(float(v) for v in lam)
        return (float(lam),) * nchan
    if nchan == 0:
        if isinstance(p["lambda1"], (list, tuple)) or isinstance(
                p["lambda2"], (list, tuple)):
            raise ValueError("per-channel weights need a C-channel image")
        return float(p["lambda1"]), float(p["lambda2"])
    return per_channel(p["lambda1"]), per_channel(p["lambda2"])


def check_scheme(p):
    """These functions compute the red-black scheme without a redistance
    cadence, and the stop on the share of flipped signs: a configuration
    that asks for more raises."""
    if (p.get("order", "redblack") != "redblack" or p.get("reinit_every")
            or p.get("conv_norm", "flips") != "flips"):
        raise ValueError("the reference runs order 'redblack', no "
                         "reinit_every and conv_norm 'flips' only")
