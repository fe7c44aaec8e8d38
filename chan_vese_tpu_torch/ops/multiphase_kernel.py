"""K9: the fully fused 4-phase (two level sets) iteration, banded and
resident.

Counterpart of ``chan_vese_tpu/ops/pallas_multiphase.py`` (whole-image
and shard-canvas modes). One coupled iteration (``_coupled_iteration``
there): with the
phase means c = [c00, c10, c01, c11] indexed by s = (phi0 >= 0) +
2 (phi1 >= 0) and d_s = (u0 - c_s)^2,

    f0   = -nu + (1 - H(phi1)) (d0 - d1) + H(phi1) (d2 - d3)
    phi0 <- red-black sweep on f0
    f1   = -nu + (1 - H(phi0 new)) (d0 - d2) + H(phi0 new) (d1 - d3)
    phi1 <- red-black sweep on f1

:func:`mp2_iteration` runs one iteration with given means and returns the
16 partials [s_uw_0..3, s_w_0..3, label_flips, s_dphi2, 0 x 6] of the new
level sets (the next means are s_uw_s / s_w_s); on a CUDA tensor it
launches ``csrc/mp2_band.cu``. :func:`mp2_resident_iterations` runs
``iters`` iterations with the means recomputed at every one and returns
one row [label_flips, s_dphi2, 0 x 6] per ``unroll`` iterations; on a CUDA
tensor it launches ``csrc/mp2_resident.cu``, one cooperative launch for
the whole loop. :func:`mp2_iteration_sharded` is K9's shard-canvas mode,
one iteration on a shard's halo-padded canvas for the sharded solver
(``parallel/sharded.py``). On a CPU tensor each runs its ``_reference``
plain version. Label flips count cells whose 2-bit label changed.

``band_rows_mp2``, ``supports_mp2`` and ``supports_mp2_resident`` are the
reference's routing predicates; their VMEM and alignment terms keep a call
on the reference's route and are not limits of the Hopper kernels, which
take any even H and W.
"""

from __future__ import annotations

import torch

from .. import spans
from ..params import CVParams
from . import _cuda
from .fused_kernel import _HALO, _VMEM_LIMIT, resync_rim
from .numerics import heaviside
from .reductions import phase_means, phase_weights
from .resident_kernel import check_iters
from .sweep import _update_all, color_masks, redblack_step

# routing constants of chan_vese_tpu/ops/pallas_multiphase.py
_TILES = 40
_ARRAYS_RESIDENT = 24


def band_rows_mp2(h: int, w: int) -> int:
    """The reference's band height (routing predicate only)."""
    per_row = w * 4 * _TILES
    b = max(8, (_VMEM_LIMIT // per_row) // 8 * 8)
    return min(b, max(8, ((h - _HALO) // 8) * 8))


def supports_mp2(h: int, w: int) -> bool:
    """Whether the reference routes (h, w) to its banded 4-phase kernel."""
    return (w % 128 == 0 and h % 8 == 0 and h >= 24
            and band_rows_mp2(h, w) + _HALO <= h)


def supports_mp2_resident(h: int, w: int) -> bool:
    """Whether the reference routes (h, w) to its resident 4-phase
    kernel."""
    return (w % 128 == 0 and h % 8 == 0 and h >= 8
            and h * w * 4 * _ARRAYS_RESIDENT <= _VMEM_LIMIT)


def check_mp2(phis, u0, supports, what: str):
    """The reference's argument checks of the 4-phase kernels; ``supports``
    is the routing predicate of (H, W)."""
    if phis.ndim != 3 or phis.shape[0] != 2:
        raise ValueError("mp2 kernel is specialized to M = 2 level sets")
    if tuple(u0.shape) != tuple(phis.shape[1:]):
        raise ValueError(f"u0 {tuple(u0.shape)} vs phis "
                         f"{tuple(phis.shape[1:])} (grayscale only)")
    if not supports(*u0.shape):
        raise ValueError(f"{what} unsupported for {tuple(u0.shape)}")


def coupled_iteration(phi0, phi1, u0, cs, p: CVParams, parity: int = 0,
                      resync=None):
    """One coupled 4-phase iteration on (H, W) level sets with the means
    ``cs``; returns (new0, new1). The plain version of every K9/K10 mode.
    On a shard canvas ``parity`` offsets the lattice and ``resync`` (the
    replica-rim refresh) runs after each of the four half-sweeps, so
    phi1's force reads the refreshed new phi0."""
    d0, d1, d2, d3 = [(u0 - cs[s]) ** 2 for s in range(4)]
    h1 = heaviside(phi1, p.eps)
    f0 = -p.nu + (1.0 - h1) * (d0 - d1) + h1 * (d2 - d3)
    if resync is None:
        new0 = redblack_step(phi0, f0, p, parity)
    else:
        new0 = _resynced_sweep(phi0, f0, p, parity, resync)
    h0n = heaviside(new0, p.eps)
    f1 = -p.nu + (1.0 - h0n) * (d0 - d2) + h0n * (d1 - d3)
    if resync is None:
        return new0, redblack_step(phi1, f1, p, parity)
    return new0, _resynced_sweep(phi1, f1, p, parity, resync)


def _resynced_sweep(phi, f, p: CVParams, parity: int, resync):
    """A red-black sweep with ``resync`` applied after each half-sweep."""
    red = color_masks(phi.shape, parity, device=phi.device)
    phi = resync(torch.where(
        red, _update_all(phi, f, p.mu, p.dt, p.eps, p.eta2), phi))
    return resync(torch.where(
        red, phi, _update_all(phi, f, p.mu, p.dt, p.eps, p.eta2)))


def label_flips(new0, new1, old0, old1):
    """Cells whose 2-bit label (phi0 >= 0) + 2 (phi1 >= 0) changed."""
    lab_new = (new0 >= 0).to(torch.int32) + 2 * (new1 >= 0).to(torch.int32)
    lab_old = (old0 >= 0).to(torch.int32) + 2 * (old1 >= 0).to(torch.int32)
    return torch.sum((lab_new != lab_old).to(new0.dtype))


def _mp2_partials(new0, new1, old0, old1, u0, eps: float):
    """[s_uw_0..3, s_w_0..3, label_flips, s_dphi2, 0 x 6] of the
    transition (old0, old1) -> (new0, new1)."""
    ws = phase_weights((new0, new1), eps)
    d0, d1 = new0 - old0, new1 - old1
    zero = torch.zeros((), dtype=u0.dtype, device=u0.device)
    return torch.stack(
        [torch.sum(u0 * w) for w in ws] + [torch.sum(w) for w in ws]
        + [label_flips(new0, new1, old0, old1),
           torch.sum(d0 * d0 + d1 * d1)] + [zero] * 6)


def mp2_iteration_reference(phis, u0, cs, p: CVParams):
    """Plain PyTorch version of :func:`mp2_iteration`."""
    new0, new1 = coupled_iteration(phis[0], phis[1], u0, cs, p)
    return (torch.stack([new0, new1]),
            _mp2_partials(new0, new1, phis[0], phis[1], u0, p.eps))


def mp2_iteration(phis, u0, cs, p: CVParams):
    """One fused 4-phase iteration on (2, H, W) level sets with the means
    ``cs`` (4,); returns (phis_new (2, H, W), partials (16,)).

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    launch ``csrc/mp2_band.cu`` or raise.
    """
    with spans.span("cv.launch.mp2_iteration"):
        check_mp2(phis, u0, supports_mp2, "mp2 fast path")
        if phis.device.type == "cpu":
            return mp2_iteration_reference(phis, u0, cs, p)
        out = _cuda.launch_mp2(phis, u0, cs, p)
        mp2_iteration.launches += 1
        return out


mp2_iteration.launches = 0


def mp2_iteration_sharded_reference(phis_canvas, u0_canvas, cs, p: CVParams,
                                    parity, edges, crop):
    """Plain PyTorch version of :func:`mp2_iteration_sharded`: the
    coupled iteration on the whole canvas (reads clamped at its edge) with
    the lattice offset and the rim refreshed after each half-sweep, then
    the partials of the crop."""
    h, w = u0_canvas.shape
    par, r0, r1, c0, c1, *flags = _cuda.shard_args(h, w, 1, parity, crop,
                                                   edges)
    win = (slice(r0, r1), slice(c0, c1))

    def resync(x):
        return resync_rim(x, (r0, r1, c0, c1), flags)

    old0, old1 = phis_canvas[0], phis_canvas[1]
    new0, new1 = coupled_iteration(old0, old1, u0_canvas, cs, p, par, resync)
    return (torch.stack([new0, new1]),
            _mp2_partials(new0[win], new1[win], old0[win], old1[win],
                          u0_canvas[win], p.eps))


def mp2_iteration_sharded(phis_canvas, u0_canvas, cs, p: CVParams, parity,
                          edges, crop):
    """One fused 4-phase iteration on a shard's halo-padded canvases:
    ``phis_canvas`` (2, Hc, Wc) holds both level sets' padded blocks,
    ``u0_canvas`` (Hc, Wc) the image's. ``parity`` offsets the lattice,
    ``crop`` = (r0, r1, c0, c1) is the shard's own window and ``edges`` =
    [top, bottom, left, right] flags the global-edge sides, whose depth-2
    replica rim is refreshed after each of the four half-sweeps. The whole
    canvas is swept and returned (the comm_k route chains launches on one
    canvas); the partials (16,) count the crop. Returns (canvas_new,
    partials).

    The canvas must hold the iteration's reach around the crop (4 rows and
    columns, two replica rows or columns on a flagged side). The
    reference's lane-padded canvases and the driver's narrow ones (even
    Hc and Wc) are both taken; the reference's ``supports_mp2`` on the
    canvas is not required (the driver routes by it on the reference's
    lane-padded geometry).

    CPU tensors run the plain version; CUDA tensors (float32, contiguous,
    even Hc and Wc) launch ``csrc/mp2_band.cu``'s
    ``cv_mp2_iteration_shard`` or raise.
    """
    with spans.span("cv.launch.mp2_iteration_sharded"):
        if phis_canvas.ndim != 3 or phis_canvas.shape[0] != 2:
            raise ValueError("mp2 kernel is specialized to M = 2 level sets")
        if tuple(u0_canvas.shape) != tuple(phis_canvas.shape[1:]):
            raise ValueError(f"u0 {tuple(u0_canvas.shape)} vs phis "
                             f"{tuple(phis_canvas.shape[1:])}")
        h, w = u0_canvas.shape
        shard = _cuda.shard_args(h, w, 1, parity, crop, edges)
        if phis_canvas.device.type == "cpu":
            return mp2_iteration_sharded_reference(
                phis_canvas, u0_canvas, cs, p, parity, edges, crop)
        out = _cuda.launch_mp2(phis_canvas, u0_canvas, cs, p, shard=shard)
        mp2_iteration_sharded.launches += 1
        return out


mp2_iteration_sharded.launches = 0


def mp2_resident_iterations_reference(phis, u0, p: CVParams, iters: int,
                                      unroll: int = 1):
    """Plain PyTorch version of :func:`mp2_resident_iterations` (and of
    the packed K10, whose plane layout moves values without changing
    them)."""
    phi0, phi1 = phis[0], phis[1]
    zero = torch.zeros((), dtype=u0.dtype, device=u0.device)
    rows = []
    for it in range(iters):
        cs = torch.stack(phase_means(u0, (phi0, phi1), p.eps))
        new0, new1 = coupled_iteration(phi0, phi1, u0, cs, p)
        if it % unroll == unroll - 1:
            d0, d1 = new0 - phi0, new1 - phi1
            rows.append(torch.stack(
                [label_flips(new0, new1, phi0, phi1),
                 torch.sum(d0 * d0 + d1 * d1)] + [zero] * 6))
        phi0, phi1 = new0, new1
    return torch.stack([phi0, phi1]), torch.stack(rows)


def mp2_resident_iterations(phis, u0, p: CVParams, iters: int,
                            unroll: int = 1):
    """``iters`` 4-phase iterations with exact means on (2, H, W) level
    sets; returns (phis_new, partials (iters // unroll, 8)), each row the
    last iteration of its group of ``unroll``.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    launch ``csrc/mp2_resident.cu`` or raise.
    """
    with spans.span("cv.launch.mp2_resident_iterations"):
        check_mp2(phis, u0, supports_mp2_resident, "mp2 resident")
        check_iters(iters, unroll)
        if phis.device.type == "cpu":
            return mp2_resident_iterations_reference(phis, u0, p, iters,
                                                     unroll)
        h, w = u0.shape
        out = _cuda.launch_mp2_resident("cv_mp2_resident_iterations", phis,
                                        u0, p, iters, unroll, h, w)
        mp2_resident_iterations.launches += 1
        return out


mp2_resident_iterations.launches = 0
