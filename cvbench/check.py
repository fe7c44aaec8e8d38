"""The comparison that decides ``correct``: what the timed calls returned
against the plain reference on the same inputs.

For every sampled call, and for every frame of a stack, three numbers:

- ``mask_diff``: the share of pixels whose mask differs from the
  reference's;
- ``phi_gap``: the mean absolute difference of the level sets over the
  reference's mean absolute level;
- ``iters_gap``: the difference of the iterations run (tolerance mode
  stops where it finds the run converged).

A run reports the worst of each over its sample; the cell's ``limits``
say which numbers are held and to what. :func:`compare` is the default
of every trajectory class of the reference; a class whose answers have
another shape gives its own (``cvbench/reference``).
"""

from __future__ import annotations

import math

import torch


def compare(out, ref):
    """{number: worst value} of one call's (phi, mask, iters) against the
    reference's."""
    phi, mask, n = out
    rphi, rmask, rn = ref
    phi, rphi = phi.float(), rphi.float()
    if phi.shape != rphi.shape or mask.shape != rmask.shape:
        return {"mask_diff": math.inf, "phi_gap": math.inf,
                "iters_gap": math.inf}
    frames = phi.reshape(-1, *phi.shape[-2:]) if phi.dim() == 3 else phi[None]
    rframes = rphi.reshape(frames.shape)
    masks = mask.reshape(frames.shape)
    rmasks = rmask.reshape(frames.shape)
    mask_diff = (masks != rmasks).float().mean(dim=(-2, -1)).max()
    gap = (frames - rframes).abs().mean(dim=(-2, -1))
    level = rframes.abs().mean(dim=(-2, -1))
    phi_gap = (gap / level).max()
    # a non-finite level set is as far off as it gets
    phi_gap = torch.nan_to_num(phi_gap, nan=math.inf)
    return {"mask_diff": float(mask_diff), "phi_gap": float(phi_gap),
            "iters_gap": float(abs(int(n) - int(rn)))}


def worst(results):
    """The worst of each number over several calls' :func:`compare`."""
    out = {}
    for res in results:
        for key, value in res.items():
            out[key] = max(out.get(key, value), value)
    return out


def judge(numbers, limits):
    """(correct, {name: {"value", "limit"}}) of the cell's held numbers."""
    held = {name: {"value": numbers.get(name, math.inf), "limit": limit}
            for name, limit in limits.items()}
    ok = all(h["value"] <= h["limit"] for h in held.values())
    return ok, held
