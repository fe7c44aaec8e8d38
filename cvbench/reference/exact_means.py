"""The resident stack driver's trajectory class, in plain PyTorch on
:mod:`.numerics`: every frame of an (N, H, W) stack takes its means from
its own current level set at every iteration, for the cell's ``iters``
iterations. The reference works out its own start and means from the
frames and the configuration's parameters."""

from __future__ import annotations

import torch

from .. import work
from . import numerics


def run(u0, params, cell, dtype):
    """(phi, mask, iterations) of the reference on stack ``u0``."""
    return exact_means(u0, params, cell["iters"], dtype)


def call_work(shape, iters: int, cell):
    """(ops, bytes, pixel-iterations) of one call on an (N, H, W) stack:
    :func:`cvbench.work.launch_work`'s operations with the data term, the
    means and a partials row at every iteration; the frames read once,
    their level sets and masks written once."""
    frames, h, w = shape
    ops = work.launch_work(h, w, iters, 0, frames, rows=iters)[0]
    pixels = frames * h * w
    return ops, work.io_bytes(pixels, pixels), pixels * iters


def exact_means(u, p, iters: int, dtype=torch.float32, block: int = 32):
    """An exact-means run of every frame of the (N, H, W) stack ``u``,
    ``block`` frames at a time. Returns (phi, mask, iterations)."""
    numerics.check_scheme(p)
    n_frames, h, w = u.shape
    lambda1, lambda2 = numerics.weights(p, 0)
    red = numerics.red_cells(h, w, u.device)
    phi0 = numerics.initial_phi((h, w), p["init"], dtype, u.device)
    out = torch.empty((n_frames, h, w), dtype=dtype, device=u.device)
    for lo in range(0, n_frames, block):
        ub = u[lo:lo + block].to(dtype)
        phi = phi0.expand(ub.shape).contiguous()
        for _ in range(iters):
            c1, c2 = numerics.region_means(ub, phi, p["eps"])
            f = numerics.force(ub, c1, c2, p, lambda1, lambda2)
            phi = numerics.redblack(phi, f, p, red)
        out[lo:lo + block] = phi
    return out, out >= 0, iters
