"""Perona-Malik anisotropic diffusion, the optional pre-smoothing.

Counterpart of ``chan_vese_tpu/ops/diffusion.py``:

    du/dt = div( g(|grad u|) grad u ),
    g(s) = exp(-(s/K)^2)        ('exp')
    g(s) = 1 / (1 + (s/K)^2)    ('frac')

Explicit scheme on the 4-neighbour fluxes, clamped Neumann boundaries,
stable for dt <= 0.25. Plain PyTorch: it runs once, before a solve.
"""

from __future__ import annotations

import torch

from .numerics import shift_down, shift_left, shift_right, shift_up


def _g(s2, kappa: float, kind: str):
    k2 = kappa * kappa
    if kind == "exp":
        return torch.exp(-s2 / k2)
    return 1.0 / (1.0 + s2 / k2)


def perona_malik(u, steps: int = 10, kappa: float = 10.0, dt: float = 0.2,
                 conductance: str = "exp"):
    """Diffuse ``u`` (H, W) or (H, W, C), channel by channel, for ``steps``
    explicit steps."""
    if u.ndim == 3:
        return torch.stack([perona_malik(u[..., c], steps, kappa, dt,
                                         conductance)
                            for c in range(u.shape[-1])], dim=-1)
    if conductance not in ("exp", "frac"):
        raise ValueError(f"unknown conductance {conductance!r}")
    x = u
    for _ in range(steps):
        dn = shift_down(x) - x
        ds = shift_up(x) - x
        de = shift_right(x) - x
        dw = shift_left(x) - x
        flux = (_g(dn * dn, kappa, conductance) * dn
                + _g(ds * ds, kappa, conductance) * ds
                + _g(de * de, kappa, conductance) * de
                + _g(dw * dw, kappa, conductance) * dw)
        x = x + dt * flux
    return x
