"""K1: one fused red-black iteration plus next-iteration partials.

Counterpart of ``chan_vese_tpu/ops/pallas_sweep.py`` (``_fused_band_kernel``
on a whole image and, with ``parity``/``crop``/``edges``, on a shard canvas
of the sharded solver). On a CUDA tensor :func:`fused_iteration` launches
the hand-written kernel ``csrc/fused.cu`` (the single-sweep body of
``csrc/sweep.cuh``); on a CPU tensor it runs
:func:`fused_iteration_reference`, the plain PyTorch version.
:func:`chunk_shard_reference` is the plain version of every shard-canvas
kernel (K1, K2, K3, K5 shard). The force
mode :func:`fused_sweep` (the reference's ``data_is_f``) takes a
precomputed force instead of the image, and optionally the lattice
``parity``, and launches ``csrc/fused_sweep.cu``.
The batch mode :func:`fused_iteration_batch` runs one iteration of every
frame of an (N, H, W) stack with per-frame means in one launch of
``csrc/fused.cu``'s ``cv_fused_iteration_batch``.

Partials layout (8,): [s_uH, s_H, s_dphi2, flips, s_absdphi, 0, 0, 0],
taken over the transition phi -> phi_new (in the force mode the first two
are f H and H, which carry no meaning).

``supports`` and ``band_rows`` are the reference's routing predicates, kept
as pure integer functions of the shape so that a call takes the same
route (and trajectory class) as in ``chan_vese_tpu``. The VMEM and
alignment terms inside them are the reference's routing, not limits of the
Hopper kernel, which takes any even H and W.
"""

from __future__ import annotations

import torch

from ..params import CVParams
from . import _cuda
from .numerics import heaviside
from .reductions import data_term
from .sweep import _update_all, color_masks, redblack_step

# routing constants of chan_vese_tpu/ops/pallas_sweep.py
_VMEM_LIMIT = 96 * 1024 * 1024
_TILES = 24
_HALO = 16


def band_rows(h: int, w: int) -> int:
    """The reference's band height (routing predicate only)."""
    per_row = w * 4 * _TILES
    b = max(8, (_VMEM_LIMIT // per_row) // 8 * 8)
    return min(b, max(8, ((h - _HALO) // 8) * 8))


def supports(h: int, w: int) -> bool:
    """Whether the reference routes (h, w) to its fused kernel."""
    return (w % 128 == 0 and h % 8 == 0 and h >= 24
            and band_rows(h, w) + _HALO <= h)


def iterate(phi, f, p: CVParams, k: int):
    """k red-black iterations on the frozen force f; returns (phi, prev),
    prev being phi before the last iteration."""
    for _ in range(k - 1):
        phi = redblack_step(phi, f, p)
    return redblack_step(phi, f, p), phi


def partials(phi, prev, channels, p: CVParams, nout: int):
    """[sum(u H) for u in channels, s_H, s_dphi2, flips, s_absdphi, 0...]
    of the transition prev -> phi, padded to ``nout`` slots."""
    h = heaviside(phi, p.eps)
    d = phi - prev
    zero = torch.zeros((), dtype=phi.dtype, device=phi.device)
    sums = [torch.sum(u * h) for u in channels] + [
        torch.sum(h), torch.sum(d * d),
        torch.sum(((phi >= 0) != (prev >= 0)).to(phi.dtype)),
        torch.sum(torch.abs(d))]
    return torch.stack(sums + [zero] * (nout - len(sums)))


def chunk_reference(phi, u0, c1, c2, p: CVParams, k: int):
    """k red-black iterations with frozen means, then the partials of the
    last iteration: the plain version of every scalar red-black kernel."""
    f = data_term(u0, c1, c2, p.nu, p.lambda1, p.lambda2)
    phi, prev = iterate(phi, f, p, k)
    return phi, partials(phi, prev, (u0,), p, 8)


def resync_rim(x, crop, edges):
    """The depth-2 replica rim of a shard canvas refreshed from its edge
    cells on the flagged sides, rows first and then columns (so the
    corners take the corner cell): the plain version of the shard kernels'
    refresh, ``chan_vese_tpu/ops/pallas_sweep.py::_resync_rim``."""
    r0, r1, c0, c1 = crop
    top, bottom, left, right = edges
    x = x.clone()
    if top:
        x[r0 - 2:r0] = x[r0]
    if bottom:
        x[r1:r1 + 2] = x[r1 - 1]
    if left:
        x[:, c0 - 2:c0] = x[:, c0:c0 + 1]
    if right:
        x[:, c1:c1 + 2] = x[:, c1 - 1:c1]
    return x


def chunk_shard_reference(phi, f, channels, p: CVParams, k: int, shard,
                          nout: int):
    """k red-black iterations on a shard canvas with the frozen force f:
    the plain version of every shard-canvas kernel. ``shard`` is
    :func:`._cuda.shard_args`' nine ints; ``channels`` the image planes
    behind the s_uH partials. The lattice is offset by the parity, the
    depth-2 rim is refreshed after each half-sweep, the partials of the
    last iteration count the crop only, and the canvas outside the crop is
    returned as it came in."""
    parity, r0, r1, c0, c1, *edges = shard
    crop = (r0, r1, c0, c1)
    red = color_masks(phi.shape, parity, device=phi.device)
    prev = cur = phi
    for _ in range(k):
        prev = cur
        cur = torch.where(red, _update_all(cur, f, p.mu, p.dt, p.eps,
                                           p.eta2), cur)
        cur = resync_rim(cur, crop, edges)
        cur = torch.where(red, cur, _update_all(cur, f, p.mu, p.dt, p.eps,
                                                p.eta2))
        cur = resync_rim(cur, crop, edges)
    win = (slice(r0, r1), slice(c0, c1))
    out = phi.clone()
    out[win] = cur[win]
    return out, partials(cur[win], prev[win], [u[win] for u in channels], p,
                         nout)


def fused_iteration_reference(phi, u0, c1, c2, p: CVParams, parity=None,
                              crop=None, edges=None):
    """Plain PyTorch version of :func:`fused_iteration`."""
    if parity is None and crop is None and edges is None:
        return chunk_reference(phi, u0, c1, c2, p, 1)
    shard = _cuda.shard_args(*phi.shape, 1, parity or 0, crop, edges)
    f = data_term(u0, c1, c2, p.nu, p.lambda1, p.lambda2)
    return chunk_shard_reference(phi, f, (u0,), p, 1, shard, 8)


def fused_iteration(phi, u0, c1, c2, p: CVParams, parity=None, crop=None,
                    edges=None):
    """One red-black iteration; returns (phi_new, partials (8,)).

    Shard-canvas mode (the reference's arguments, given by the sharded
    solver, ``parallel/sharded.py``): ``parity`` offsets the red-black
    lattice, ``crop`` = (r0, r1, c0, c1) is the shard's own window, to
    which the sweep's tiles and the partials are restricted (the canvas
    outside it is returned as it came in), and ``edges`` = [top, bottom,
    left, right] flags the canvas sides that are global image edges, whose
    replica rim is refreshed after each half-sweep. Any crop whose
    surroundings hold the iteration's reach is taken
    (:func:`._cuda.shard_args`), not only the reference's 4-deep geometry.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous,
    even H and W) launch ``csrc/fused.cu`` (``cv_fused_iteration``, or
    ``cv_fused_iteration_shard`` in the shard-canvas mode, counted in
    ``fused_iteration.shard_launches``) or raise.
    """
    h, w = phi.shape
    if parity is None and crop is None and edges is None:
        if phi.device.type == "cpu":
            return fused_iteration_reference(phi, u0, c1, c2, p)
        out = _cuda.launch_fused("cv_fused_iteration", phi, u0, c1, c2, p)
        fused_iteration.launches += 1
        return out
    shard = _cuda.shard_args(h, w, 1, parity or 0, crop, edges)
    if phi.device.type == "cpu":
        return fused_iteration_reference(phi, u0, c1, c2, p, parity, crop,
                                         edges)
    out = _cuda.launch_fused("cv_fused_iteration_shard", phi, u0, c1, c2, p,
                             shard=shard)
    fused_iteration.shard_launches += 1
    return out


fused_iteration.launches = 0
fused_iteration.shard_launches = 0


def fused_sweep_reference(phi, f, p: CVParams, parity=None):
    """Plain PyTorch version of :func:`fused_sweep`."""
    par = 0 if parity is None else int(parity) % 2
    new = redblack_step(phi, f, p, par)
    return new, partials(new, phi, (f,), p, 8)


def fused_sweep(phi, f, p: CVParams, parity=None):
    """One red-black sweep on the precomputed force ``f`` (H, W); returns
    (phi_new, partials (8,)). ``parity`` offsets the lattice: cell (i, j)
    is red iff (i + j + parity) is even (None: 0). Shapes the reference's
    fused kernel does not take (``supports``) raise, as there.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    launch ``csrc/fused_sweep.cu`` (``cv_fused_sweep``, or
    ``cv_fused_sweep_shard`` with a parity, counted in
    ``fused_sweep.parity_launches``) or raise.
    """
    if phi.ndim != 2 or f.shape != phi.shape:
        raise ValueError(f"phi {tuple(phi.shape)} and f {tuple(f.shape)} "
                         f"must be one (H, W) shape")
    h, w = phi.shape
    if not supports(h, w):
        raise ValueError(f"fused sweep unsupported for shape {(h, w)}")
    if phi.device.type == "cpu":
        return fused_sweep_reference(phi, f, p, parity)
    if parity is None:
        out = _cuda.launch_fused("cv_fused_sweep", phi, f, 0.0, 0.0, p)
        fused_sweep.launches += 1
        return out
    # the parity only: the whole image is the crop, no rim
    out = _cuda.launch_fused("cv_fused_sweep_shard", phi, f, 0.0, 0.0, p,
                             shard=_cuda.shard_args(h, w, 1, parity, None,
                                                    None))
    fused_sweep.parity_launches += 1
    return out


fused_sweep.launches = 0
fused_sweep.parity_launches = 0


def fused_iteration_batch_reference(phis, u0s, c1s, c2s, p: CVParams):
    """Plain PyTorch version of :func:`fused_iteration_batch`:
    :func:`fused_iteration_reference` on each frame, stacked."""
    outs = [fused_iteration_reference(phi, u0, c1, c2, p)
            for phi, u0, c1, c2 in zip(phis, u0s, c1s, c2s)]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def fused_iteration_batch(phis, u0s, c1s, c2s, p: CVParams):
    """One red-black iteration of each frame of an (N, H, W) stack with
    per-frame means c1s, c2s (N,); returns (phi_new (N, H, W), partials
    (N, 8)), row n that of frame n. Shapes the reference's fused kernel
    does not take (``supports``) raise, as there.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    launch ``cv_fused_iteration_batch`` (all frames, one launch) or raise.
    """
    if phis.ndim != 3 or u0s.shape != phis.shape:
        raise ValueError(f"phis {tuple(phis.shape)} and u0s "
                         f"{tuple(u0s.shape)} must be one (N, H, W) shape")
    n, h, w = phis.shape
    if not supports(h, w):
        raise ValueError(f"fused batch unsupported for shape {(h, w)}")
    if tuple(c1s.shape) != (n,) or tuple(c2s.shape) != (n,):
        raise ValueError(f"c1s {tuple(c1s.shape)} and c2s "
                         f"{tuple(c2s.shape)} must be ({n},)")
    if phis.device.type == "cpu":
        return fused_iteration_batch_reference(phis, u0s, c1s, c2s, p)
    out = _cuda.launch_fused_batch(phis, u0s, c1s, c2s, p)
    fused_iteration_batch.launches += 1
    return out


fused_iteration_batch.launches = 0
