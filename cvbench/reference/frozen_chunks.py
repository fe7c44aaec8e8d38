"""The banded drivers' trajectory class, in plain PyTorch on
:mod:`.numerics`.

A run is a sequence of chunks of the cell's ``k`` red-black iterations
(then one remainder chunk); the means are frozen within a chunk and taken
anew from the level set at its end. In tolerance mode (the cell's
``iters`` null) the run stops at a chunk boundary once the share of
pixels whose sign flipped in the chunk's last iteration has stayed below
``tol`` for ``patience`` iterations (a chunk below it credits its whole
size) and ``min_iter`` iterations have run, or when that share is not
finite; ``max_iter`` caps it. The reference works out its own start,
chunking and means from the image and the configuration's parameters.
"""

from __future__ import annotations

import math

import torch

from .. import work
from . import numerics


def run(u0, params, cell, dtype):
    """(phi, mask, iterations) of the reference on image ``u0``."""
    return frozen_chunks(u0, params, cell["k"], cell["iters"], dtype)


def call_work(shape, iters: int, cell):
    """(ops, bytes, pixel-iterations) of one call on an (H, W) or
    (H, W, C) image: the sum over its chunks of
    :func:`cvbench.work.launch_work`'s operations (the data term and the
    partials once a chunk); the image read once, the level set and mask
    written once."""
    h, w = shape[:2]
    c = shape[2] if len(shape) == 3 else 0
    ops = sum(work.launch_work(h, w, size, c)[0]
              for size in work.chunks(iters, cell["k"]))
    return ops, work.io_bytes(h * w * max(c, 1), h * w), h * w * iters


def frozen_chunks(u, p, k: int, iters=None, dtype=torch.float32):
    """A banded run of image ``u`` ((H, W) gray or (H, W, C)) under the
    parameters ``p`` (a dict of the configuration's names): ``iters``
    iterations, or to the stop rule where ``iters`` is None. Returns
    (phi, mask, iterations)."""
    numerics.check_scheme(p)
    u = numerics.channels_first(u).to(dtype)
    nchan = u.shape[0] if u.dim() == 3 else 0
    lambda1, lambda2 = numerics.weights(p, nchan)
    h, w = u.shape[-2:]
    red = numerics.red_cells(h, w, u.device)
    phi = numerics.initial_phi((h, w), p["init"], dtype, u.device)
    c1, c2 = numerics.region_means(u, phi, p["eps"])
    n, streak, delta = 0, 0, math.inf

    def chunk(phi, c1, c2, size):
        f = numerics.force(u, c1, c2, p, lambda1, lambda2)
        prev = phi
        for _ in range(size):
            prev, phi = phi, numerics.redblack(phi, f, p, red)
        c1, c2 = numerics.region_means(u, phi, p["eps"])
        flips = torch.sum((phi >= 0) != (prev >= 0), dtype=torch.float64)
        # 0 x the squared update: a level set gone non-finite stops the run
        poison = 0.0 * torch.sum((phi - prev).double() ** 2)
        return phi, c1, c2, float(flips / (h * w) + poison)

    if iters is not None:
        for size in work.chunks(iters, k):
            phi, c1, c2, _ = chunk(phi, c1, c2, size)
        return phi, phi >= 0, iters

    def stopped():
        done = streak >= p["patience"] and n >= p["min_iter"]
        return done or (n > 0 and not math.isfinite(delta))

    full = (p["max_iter"] // k) * k
    while n < p["max_iter"] and not stopped():
        size = k if n < full else p["max_iter"] - full
        phi, c1, c2, delta = chunk(phi, c1, c2, size)
        streak = streak + size if delta < p["tol"] else 0
        n += size
    return phi, phi >= 0, n
