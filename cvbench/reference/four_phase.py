"""The four-phase trajectory class (Vese-Chan 2002, two coupled level
sets), in plain PyTorch on :mod:`.numerics`.

Every iteration takes the four phase means anew from the current level
sets, c_s over the soft phase w_s (s = bit 0 inside phi0 + 2 x bit 1 inside
phi1; inside is H, outside 1 - H), with d_s = (u0 - c_s)^2:

    f0   = -nu + (1 - H(phi1)) (d0 - d1) + H(phi1) (d2 - d3)
    phi0 <- red-black sweep on f0
    f1   = -nu + (1 - H(phi0 new)) (d0 - d2) + H(phi0 new) (d1 - d3)
    phi1 <- red-black sweep on f1

The start is the multiphase checkerboard: sin(pi i / 5) sin(pi j / 5) for
phi0, and for level set m >= 1 the same rolled by (5 m) // 2 + 1 columns.
One departure from the program: the sines are taken in float64 and
rounded to the run's dtype, where the program takes float32 sines of a
float32 argument from the C library; the argument's rounding grows with
the index, so the two starts differ by up to 2.3e-5 at 512x512, which the
coupled iteration then carries.

The comparison holds the labels and the energy. Where a phase is about to
vanish, float32 trajectories part by up to a quarter of the labels (the
reference in float64 against itself in float32 does too): the vanishing
level set lies near 0 over a region, and rounding decides its sign there.
They part along directions in which the energy hardly changes, so the
energy holds such a scene as tightly as any other; a run that computes the
scheme wrongly, or in too low a precision, ends at another energy. The
energy does not see the phases' names (swapping the level sets keeps it),
which the labels do.
"""

from __future__ import annotations

import math

import torch

from .. import check, work
from . import numerics

# operations per pixel, frozen from the repository's chip_smoke.py:
# a coupled iteration (two cell updates, the four squared distances as a
# subtract and a square each, two Heavisides of atan, divide, multiply and
# add, and f0, f1 of 1 - H, two differences, two products and two adds
# each); the phase sums behind the means (two Heavisides, the four weights
# of two complements and four products, u w_s and w_s summed, three
# operations each); a partials row (the 2-bit labels and their flip count,
# six; s_dphi2, two differences, two squares, two adds)
OPS_MP2_ITER = 2 * work.OPS_UPDATE + 8 + 8 + 14
OPS_MP2_SUMS, OPS_MP2_ROW = 26, 12
# the final labels: two compares and their 2-bit sum
OPS_LABELS = 3


def run(u0, params, cell, dtype):
    """The :class:`Answer` (phis (2, H, W), labels (H, W), iterations)
    of the reference on image ``u0``."""
    return four_phase(u0, params, cell["iters"], dtype)


def call_work(shape, iters: int, cell):
    """(ops, bytes, pixel-iterations) of one call on an (H, W) image: per
    pixel and iteration a coupled iteration and the phase sums, then one
    partials row, the final means and the labels once; the image read
    once, both level sets written once in float32 and the label map in one
    byte."""
    h, w = shape
    pixels = h * w
    per_pixel = (iters * (OPS_MP2_ITER + OPS_MP2_SUMS) + OPS_MP2_ROW
                 + OPS_MP2_SUMS + OPS_LABELS)
    nbytes = 4 * pixels + 2 * 4 * pixels + pixels
    return pixels * per_pixel, nbytes, pixels * iters


class Answer(tuple):
    """The reference's (phis, labels, iterations), with the image it ran
    on (``u0``) and its parameters (``params``) beside them, which the
    energy of another answer needs."""

    def __new__(cls, phis, labels, iters, u0, params):
        answer = super().__new__(cls, (phis, labels, iters))
        answer.u0, answer.params = u0, params
        return answer


def energy(u, phis, p):
    """The four-phase energy of level sets ``phis`` (2, H, W) on image
    ``u``, in float64: sum_s sum (u - c_s)^2 w_s, c_s the means over the
    soft phases, plus mu sum_m sum delta_eps(phi_m) |grad phi_m| (forward
    differences, none across the far edge) and nu sum_m sum H(phi_m)."""
    u, phis = u.double(), phis.double()
    eps = p["eps"]
    h0, h1 = (numerics.heaviside(phis[m], eps) for m in range(2))
    total = torch.zeros((), dtype=torch.float64, device=u.device)
    for s in range(4):
        w = (h0 if s & 1 else 1.0 - h0) * (h1 if s & 2 else 1.0 - h1)
        c = torch.sum(u * w) / torch.clamp_min(torch.sum(w), 1e-30)
        total = total + torch.sum((u - c) ** 2 * w)
    for phi in phis:
        gx = torch.zeros_like(phi)
        gy = torch.zeros_like(phi)
        gx[:-1] = phi[1:] - phi[:-1]
        gy[:, :-1] = phi[:, 1:] - phi[:, :-1]
        total = total + p["mu"] * torch.sum(numerics.dirac(phi, eps)
                                            * torch.sqrt(gx * gx + gy * gy))
        total = total + p["nu"] * torch.sum(numerics.heaviside(phi, eps))
    return float(total)


def compare(out, ref):
    """{number: worst value} of one call's (phis, labels, iters) against
    the reference's :class:`Answer`: ``mask_diff`` the share of pixels
    whose 4-phase label differs, ``phi_gap`` :func:`cvbench.check.
    compare`'s gap on each level set, the worse of the two,
    ``energy_gap`` the difference of the two answers' :func:`energy` on
    the reference's image over the reference's, ``iters_gap`` the
    difference of the iterations run."""
    phis, labels, n = out
    rphis, rlabels, rn = ref
    if (phis.shape != rphis.shape or phis.dim() != 3
            or labels.shape != rlabels.shape):
        return {"mask_diff": math.inf, "phi_gap": math.inf,
                "energy_gap": math.inf, "iters_gap": math.inf}
    gaps = [check.compare((phis[m], phis[m] >= 0, n),
                          (rphis[m], rphis[m] >= 0, rn))["phi_gap"]
            for m in range(phis.shape[0])]
    diff = (labels.long() != rlabels.long()).float().mean()
    e_ref = energy(ref.u0, rphis, ref.params)
    e_gap = abs(energy(ref.u0, phis, ref.params) - e_ref) / e_ref
    # a non-finite level set is as far off as it gets
    return {"mask_diff": float(diff), "phi_gap": max(gaps),
            "energy_gap": e_gap if math.isfinite(e_gap) else math.inf,
            "iters_gap": float(abs(int(n) - int(rn)))}


def initial_phis(shape, m_sets: int, dtype, device):
    """The multiphase checkerboard start (M, H, W): sines in float64,
    rounded to ``dtype``."""
    h, w = shape
    i = torch.arange(h, dtype=torch.float64, device=device)[:, None]
    j = torch.arange(w, dtype=torch.float64, device=device)[None, :]
    base = (torch.sin(i * (math.pi / 5.0))
            * torch.sin(j * (math.pi / 5.0))).to(dtype)
    return torch.stack([torch.roll(base, (5 * m) // 2 + 1, dims=1)
                        if m else base for m in range(m_sets)])


def phase_means(u, phi0, phi1, eps: float):
    """[c0, c1, c2, c3]: the mean of ``u`` over each soft phase, the sums
    in float64 (as :func:`.numerics.region_means`), in phi's dtype."""
    h0, h1 = numerics.heaviside(phi0, eps), numerics.heaviside(phi1, eps)
    wide = torch.float64
    means = []
    for s in range(4):
        w = ((h0 if s & 1 else 1.0 - h0) * (h1 if s & 2 else 1.0 - h1))
        num = torch.sum(u * w, dtype=wide)
        den = torch.clamp_min(torch.sum(w, dtype=wide), 1e-30)
        means.append((num / den).to(phi0.dtype))
    return means


def four_phase(u, p, iters: int, dtype=torch.float32):
    """``iters`` coupled iterations of the four-phase scheme on the (H, W)
    image ``u`` under the parameters ``p`` (a dict of the configuration's
    names). Returns the :class:`Answer` (phis, labels, iterations)."""
    numerics.check_scheme(p)
    if int(p.get("m_sets", 2)) != 2 or u.dim() != 2:
        raise ValueError("the four-phase reference runs two level sets on "
                         "a gray image")
    image, u = u, u.to(dtype)
    h, w = u.shape
    red = numerics.red_cells(h, w, u.device)
    phi0, phi1 = initial_phis((h, w), 2, dtype, u.device)
    eps, nu = p["eps"], p["nu"]
    for _ in range(iters):
        d0, d1, d2, d3 = ((u - c) ** 2
                          for c in phase_means(u, phi0, phi1, eps))
        h1 = numerics.heaviside(phi1, eps)
        f0 = -nu + (1.0 - h1) * (d0 - d1) + h1 * (d2 - d3)
        phi0 = numerics.redblack(phi0, f0, p, red)
        h0 = numerics.heaviside(phi0, eps)
        f1 = -nu + (1.0 - h0) * (d0 - d2) + h0 * (d1 - d3)
        phi1 = numerics.redblack(phi1, f1, p, red)
    labels = (phi0 >= 0).to(torch.int32) + 2 * (phi1 >= 0).to(torch.int32)
    return Answer(torch.stack([phi0, phi1]), labels, iters, image, p)
