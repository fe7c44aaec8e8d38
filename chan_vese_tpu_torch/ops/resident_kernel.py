"""K7: exact-means resident iterations, ``iters`` full Chan-Vese
iterations in one launch, on a scalar image, a stack of frames, or a
C-channel image.

Counterpart of ``chan_vese_tpu/ops/pallas_resident.py``. Every iteration
recomputes c1/c2 from the current phi (no frozen-means chunk, no lag),
builds the data term and runs one red-black iteration. On a CUDA tensor
the wrappers launch ``csrc/resident.cu`` (scalar and batch) or
``csrc/resident_mc.cu``, one cooperative launch that holds the whole loop;
on a CPU tensor they run their ``_reference`` plain versions.

Partials rows: [s_uH, s_H, s_dphi2, flips, s_absdphi, 0, 0, 0] for a
scalar image, [s_uH per channel..., s_H, s_dphi2, flips, s_absdphi] for C
channels. s_uH and s_H are the sums behind the means the iteration used
(of the phi it started from); the rest describe its update. A single image
gets one row per ``unroll`` iterations (the last of each group), shape
(iters // unroll, 8); the reference declares (iters, 8) and writes only
those rows. A stack gets each frame's last-iteration row, (N, 8).
``unroll`` changes only which rows are written: the means stay exact at
every iteration.

``supports_resident(_mc)`` are the reference's routing predicates; their
VMEM and alignment terms keep a call on the reference's route and are not
limits of the Hopper kernel, which takes any even H and W.
"""

from __future__ import annotations

import torch

from .. import spans
from ..params import CVParams
from . import _cuda
from .fused_kernel import _VMEM_LIMIT
from .fused_kernel_mc import data_term_mc
from .numerics import heaviside
from .reductions import data_term, means_from_sums
from .sweep import redblack_step

# routing constant of chan_vese_tpu/ops/pallas_resident.py
_ARRAYS = 18


def supports_resident(h: int, w: int) -> bool:
    """Whether the reference routes (h, w) to its resident kernel."""
    return (w % 128 == 0 and h % 8 == 0 and h >= 8
            and h * w * 4 * _ARRAYS <= _VMEM_LIMIT)


def supports_resident_mc(h: int, w: int, c: int) -> bool:
    """Whether the reference routes (h, w, c) to its resident mc kernel."""
    return (w % 128 == 0 and h % 8 == 0 and h >= 8 and 1 <= c <= 8
            and h * w * 4 * (_ARRAYS + 2 * c) <= _VMEM_LIMIT)


def check_iters(iters: int, unroll: int):
    if iters < 1:
        raise ValueError("iters must be >= 1")
    if unroll < 1 or iters % unroll:
        raise ValueError(f"unroll must divide iters (got iters={iters}, "
                         f"unroll={unroll})")


def exact_iterations(phi, channels, force, p: CVParams, iters: int,
                     unroll: int, nout: int):
    """``iters`` exact-means red-black iterations: the plain version of
    every resident kernel. ``channels`` are the (H, W) image channels,
    ``force(c1, c2)`` the data term from (C,) means. Returns (phi, rows
    (iters // unroll, nout))."""
    n = torch.tensor(phi.numel(), dtype=phi.dtype, device=phi.device)
    sum_u = torch.stack([torch.sum(u) for u in channels])
    zero = torch.zeros((), dtype=phi.dtype, device=phi.device)
    rows = []
    for it in range(iters):
        h = heaviside(phi, p.eps)
        s_uh = [torch.sum(u * h) for u in channels]
        s_h = torch.sum(h)
        c1, c2 = means_from_sums(torch.stack(s_uh), s_h, sum_u, n)
        new = redblack_step(phi, force(c1, c2), p)
        if it % unroll == unroll - 1:
            d = new - phi
            sums = s_uh + [s_h, torch.sum(d * d),
                           torch.sum(((new >= 0) != (phi >= 0))
                                     .to(phi.dtype)),
                           torch.sum(torch.abs(d))]
            rows.append(torch.stack(sums + [zero] * (nout - len(sums))))
        phi = new
    return phi, torch.stack(rows)


def resident_iterations_reference(phi, u0, p: CVParams, iters: int,
                                  unroll: int = 1):
    """Plain PyTorch version of :func:`resident_iterations`."""
    return exact_iterations(
        phi, (u0,), lambda c1, c2: data_term(u0, c1[0], c2[0], p.nu,
                                             p.lambda1, p.lambda2),
        p, iters, unroll, 8)


def resident_iterations(phi, u0, p: CVParams, iters: int, unroll: int = 1):
    """``iters`` exact-means iterations on an (H, W) image; returns
    (phi_new, partials (iters // unroll, 8)).

    CPU tensors run the plain version; CUDA tensors (float32, contiguous,
    even H and W) launch ``csrc/resident.cu`` or raise.
    """
    with spans.span("cv.launch.resident_iterations"):
        check_iters(iters, unroll)
        if phi.ndim != 2 or u0.shape != phi.shape:
            raise ValueError(f"phi {tuple(phi.shape)} and u0 "
                             f"{tuple(u0.shape)} must be one (H, W) shape")
        if phi.device.type == "cpu":
            return resident_iterations_reference(phi, u0, p, iters, unroll)
        out = _cuda.launch_resident("cv_resident_iterations", phi, u0, p,
                                    iters, unroll, *phi.shape)
        resident_iterations.launches += 1
        return out


resident_iterations.launches = 0


def resident_iterations_batch_reference(phis, u0s, p: CVParams, iters: int,
                                        unroll: int = 1):
    """Plain PyTorch version of :func:`resident_iterations_batch`."""
    outs = [resident_iterations_reference(phi, u0, p, iters, unroll)
            for phi, u0 in zip(phis, u0s)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1][-1] for o in outs]))


def check_stack(phis, u0s):
    if phis.ndim != 3 or u0s.shape != phis.shape:
        raise ValueError(f"u0s {tuple(u0s.shape)} vs phis "
                         f"{tuple(phis.shape)}: expected one (N, H, W)")


def resident_iterations_batch(phis, u0s, p: CVParams, iters: int,
                              unroll: int = 1):
    """``iters`` exact-means iterations on every frame of an (N, H, W)
    stack, all frames in one launch; returns (phis_new, partials (N, 8)),
    each frame's row from its last iteration."""
    with spans.span("cv.launch.resident_iterations_batch"):
        check_iters(iters, unroll)
        check_stack(phis, u0s)
        if phis.device.type == "cpu":
            return resident_iterations_batch_reference(phis, u0s, p, iters,
                                                       unroll)
        n, h, w = phis.shape
        out = _cuda.launch_resident("cv_resident_iterations", phis, u0s, p,
                                    iters, unroll, h, w, frames=n, batch=True)
        resident_iterations_batch.launches += 1
        return out


resident_iterations_batch.launches = 0


def resident_iterations_mc_reference(phi, u0_cfirst, p: CVParams,
                                     iters: int, lambda1=None, lambda2=None,
                                     unroll: int = 1):
    """Plain PyTorch version of :func:`resident_iterations_mc`."""
    C = u0_cfirst.shape[0]
    l1, l2 = p.channel_lambdas(C, lambda1, lambda2)
    return exact_iterations(
        phi, tuple(u0_cfirst),
        lambda c1, c2: data_term_mc(u0_cfirst, c1, c2, p, l1, l2),
        p, iters, unroll, C + 4)


def resident_iterations_mc(phi, u0_cfirst, p: CVParams, iters: int,
                           lambda1=None, lambda2=None, unroll: int = 1):
    """``iters`` exact-means iterations on a (C, H, W) channels-first image
    with per-channel lambda tuples; returns (phi_new, partials
    (iters // unroll, C + 4)).

    CPU tensors run the plain version; CUDA tensors (float32, contiguous,
    even H and W, 1 <= C <= 8) launch ``csrc/resident_mc.cu`` or raise.
    """
    with spans.span("cv.launch.resident_iterations_mc"):
        check_iters(iters, unroll)
        C = _cuda.mc_channels(phi, u0_cfirst)
        if phi.device.type == "cpu":
            return resident_iterations_mc_reference(phi, u0_cfirst, p, iters,
                                                    lambda1, lambda2, unroll)
        l1, l2 = p.channel_lambdas(C, lambda1, lambda2)
        out = _cuda.launch_resident("cv_resident_iterations_mc", phi,
                                    u0_cfirst, p, iters, unroll, *phi.shape,
                                    l1=l1, l2=l2)
        resident_iterations_mc.launches += 1
        return out


resident_iterations_mc.launches = 0
