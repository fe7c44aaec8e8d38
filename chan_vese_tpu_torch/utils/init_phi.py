"""Level-set initialization (plain PyTorch).

Counterparts of ``chan_vese_tpu/utils/init_phi.py``: checkerboard
(phi0 = sin(pi i / 5) sin(pi j / 5)), circle/disk and rect signed distances.
"""

from __future__ import annotations

import math

import torch


def _grid(shape, dtype, device):
    i = torch.arange(shape[0], device=device).to(dtype)[:, None]
    j = torch.arange(shape[1], device=device).to(dtype)[None, :]
    return i, j


def checkerboard(shape, dtype=torch.float32, period: float = 5.0,
                 device=None):
    """phi0[i, j] = sin(pi i / period) * sin(pi j / period)."""
    i, j = _grid(shape, dtype, device)
    return torch.sin(i * (math.pi / period)) * torch.sin(j * (math.pi / period))


def circle(shape, dtype=torch.float32, center=None, radius=None,
           device=None):
    """Signed distance to a circle: positive inside."""
    h, w = shape
    cy, cx = center if center is not None else ((h - 1) / 2.0, (w - 1) / 2.0)
    r = radius if radius is not None else min(h, w) / 4.0
    i, j = _grid(shape, dtype, device)
    return r - torch.sqrt((i - cy) ** 2 + (j - cx) ** 2)


def rect(shape, dtype=torch.float32, margin: float = None, device=None):
    """Signed distance to an axis-aligned rectangle inset by ``margin``."""
    h, w = shape
    m = margin if margin is not None else min(h, w) / 8.0
    i, j = _grid(shape, dtype, device)
    return torch.minimum(torch.minimum(i - m, (h - 1 - m) - i),
                         torch.minimum(j - m, (w - 1 - m) - j))


def init_phi(shape, kind: str = "checkerboard", dtype=torch.float32,
             device=None, **kw):
    if kind == "checkerboard":
        return checkerboard(shape, dtype, device=device, **kw)
    if kind in ("circle", "disk"):
        return circle(shape, dtype, device=device, **kw)
    if kind in ("small disk", "small-disk"):
        kw.setdefault("radius", min(shape) / 8.0)
        return circle(shape, dtype, device=device, **kw)
    if kind == "rect":
        return rect(shape, dtype, device=device, **kw)
    raise ValueError(f"unknown init {kind!r}")
