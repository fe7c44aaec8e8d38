"""Level-set reinitialization: Sussman-Smereka-Osher PDE redistancing.

Counterpart of ``chan_vese_tpu/ops/reinit.py``. Evolve

    d psi / d tau = S(phi0) (1 - |grad psi|),   psi(0) = phi0

for ``steps`` steps with the Godunov upwind scheme and Peng's smoothed sign
S = phi0 / sqrt(phi0^2 + |grad phi0|^2 h^2); cells whose 4-neighbourhood
crosses the zero level of phi0 relax toward the subcell distance estimate
h phi0 / |grad phi0|, clipped to +-1.5 h, instead (Russo-Smereka), so the
zero crossing stays in place. Boundaries are clamped, as the shifts of
``numerics``.

:func:`reinit` takes an (H, W) level set or a (B, H, W) stack, each frame
redistanced on its own. CPU tensors run :func:`reinit_reference`, the
plain version; CUDA tensors launch R1 (``csrc/reinit.cu``: passes of up
to k steps on deep-halo shared-memory tiles, one launch a pass) or raise.
"""

from __future__ import annotations

import torch

from ..params import CVParams
from . import _cuda


def _up(x):
    """x[..., max(i - 1, 0), :]: the north neighbour, clamped."""
    return torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)


def _down(x):
    return torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)


def _left(x):
    return torch.cat([x[..., :1], x[..., :-1]], dim=-1)


def _right(x):
    return torch.cat([x[..., 1:], x[..., -1:]], dim=-1)


def _godunov_grad(psi, sgn):
    """Godunov upwind |grad psi| for the redistancing PDE, the branch
    chosen by the sign of ``sgn``."""
    a = psi - _up(psi)      # D-x (backward in i)
    b = _down(psi) - psi    # D+x (forward in i)
    c = psi - _left(psi)    # D-y
    d = _right(psi) - psi   # D+y
    ap, an = torch.clamp(a, min=0.0), torch.clamp(a, max=0.0)
    bp, bn = torch.clamp(b, min=0.0), torch.clamp(b, max=0.0)
    cp, cn = torch.clamp(c, min=0.0), torch.clamp(c, max=0.0)
    dp, dn = torch.clamp(d, min=0.0), torch.clamp(d, max=0.0)
    g_pos = torch.sqrt(torch.maximum(ap * ap, bn * bn)
                       + torch.maximum(cp * cp, dn * dn))
    g_neg = torch.sqrt(torch.maximum(an * an, bp * bp)
                       + torch.maximum(cn * cn, dp * dp))
    return torch.where(sgn > 0, g_pos, g_neg)


def crossings(phi):
    """The cells whose 4-neighbourhood crosses the zero level of ``phi``:
    they take the subcell update instead of the PDE."""
    return ((phi * _up(phi) < 0) | (phi * _down(phi) < 0)
            | (phi * _left(phi) < 0) | (phi * _right(phi) < 0))


def reinit_reference(phi, steps: int = 20, dtau: float = 0.5,
                     h: float = 1.0):
    """Plain PyTorch version of :func:`reinit`, on (..., H, W)."""
    gx = 0.5 * (_down(phi) - _up(phi))
    gy = 0.5 * (_right(phi) - _left(phi))
    gn2 = gx * gx + gy * gy
    sgn = phi / torch.sqrt(phi * phi + gn2 * (h * h) + 1e-30)
    crosses = crossings(phi)
    dist0 = torch.clamp(h * phi / torch.clamp(torch.sqrt(gn2), min=1e-12),
                        -1.5 * h, 1.5 * h)
    psi = phi
    for _ in range(steps):
        g = _godunov_grad(psi, phi)
        pde = psi - dtau * sgn * (g - 1.0)
        sub = psi - (dtau / h) * (torch.sign(phi) * torch.abs(psi) - dist0)
        psi = torch.where(crosses, sub, pde)
    return psi


def reinit(phi, steps: int = 20, dtau: float = 0.5, h: float = 1.0):
    """Redistance ``phi`` ((H, W) or a (B, H, W) stack, each frame on its
    own) toward a signed distance function with the same zero contour.

    ``steps * dtau`` is the distance band (in pixels) that becomes exact.
    CPU tensors run the plain version; CUDA tensors (float32 or float64)
    launch R1, bitwise the plain version on the card, or raise.
    ``reinit.launches`` counts R1's launches on the card: ceil(steps / k)
    a redistance, k the pass depth ``_cuda.reinit_geometry`` picks."""
    if phi.ndim not in (2, 3):
        raise ValueError(f"reinit takes (H, W) or (B, H, W), got "
                         f"{tuple(phi.shape)}")
    if phi.device.type == "cpu":
        return reinit_reference(phi, steps, dtau, h)
    if steps < 1:
        return phi
    out = _cuda.launch_reinit(phi, steps, dtau, h)
    b, hh, w = (1, *out.shape) if out.ndim == 2 else out.shape
    k = _cuda.reinit_geometry(b, hh, w, steps, out.element_size())[0]
    reinit.launches += len(_cuda.reinit_passes(steps, k))
    return out


reinit.launches = 0


def reinit_fires(n, p: CVParams) -> bool:
    """The drivers' redistancing cadence: whether the iteration of index
    ``n``, just run, ends with a redistance ((n + 1) % p.reinit_every ==
    0; never when reinit_every is 0)."""
    return bool(p.reinit_every) and (n + 1) % p.reinit_every == 0


def maybe_reinit(x, n, p: CVParams):
    """Redistance an (H, W) level set or an (M, H, W) stack where the
    cadence fires after iteration ``n``."""
    return reinit(x, p.reinit_steps) if reinit_fires(n, p) else x
