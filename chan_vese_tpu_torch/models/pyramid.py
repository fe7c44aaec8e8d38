"""Coarse-to-fine (multiscale pyramid) drivers.

Counterpart of ``chan_vese_tpu/models/pyramid.py``: segment a 2x-decimated
copy of the image first, upsample the converged level set, and start the
next finer level from it, so that the full-resolution level only refines
the contour locally. Each level is one tolerance-mode run of a driver
(``segment_banded`` and its kernel routing for the two-phase PDE,
``segment_multiphase``, ``segment_sharded``, ``segment_morph``,
``segment_gac``); between levels the image is mean-pooled exactly and a
PDE level set is upsampled bilinearly with its values doubled, then
redistanced (``ops.reinit.reinit``: R1 on the card), since a converged
coarse level set has grown steep near its interface. A binary
morphological level set is blown up nearest-neighbour, no redistance.

Level planning: ``levels=None`` decimates while both dimensions stay even
and min(H, W) stays >= ``min_dim``; an explicit count is clipped to that
limit. ``level_iters`` are the per-level iteration counts, coarse to fine.
"""

from __future__ import annotations

from importlib import import_module
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..params import CVParams
from .banded import segment_banded

# ops.reinit the module (the ops package exports the function under its
# name), so that R1 is reached through one attribute by every caller
_reinit = import_module("..ops.reinit", __package__)


class PyramidResult(NamedTuple):
    phi: torch.Tensor     # final full-resolution level set (H, W)
    mask: torch.Tensor    # phi >= 0 (bool)
    iters: int            # iterations run at the finest level
    delta: torch.Tensor   # finest level's final update norm
    c1: torch.Tensor      # final inside mean(s)
    c2: torch.Tensor      # final outside mean(s)
    level_iters: Tuple[int, ...]  # per-level iterations, coarse -> fine


class MultiphasePyramidResult(NamedTuple):
    phis: torch.Tensor    # (M, H, W) final full-resolution level sets
    labels: torch.Tensor  # (H, W) int32 phase labels
    iters: int            # iterations run at the finest level
    delta: torch.Tensor   # finest level's final label-flip fraction
    cs: torch.Tensor      # (2^M, ...) phase means
    level_iters: Tuple[int, ...]


class MorphPyramidResult(NamedTuple):
    ls: torch.Tensor      # final full-resolution binary level set
    mask: torch.Tensor    # ls >= 0.5 (bool)
    iters: int            # iterations run at the finest level
    delta: torch.Tensor   # finest level's final flip fraction
    level_iters: Tuple[int, ...]


def plan_levels(H: int, W: int, levels: Optional[int] = None,
                min_dim: int = 128) -> int:
    """Number of 2x decimations (0 = no pyramid): while both dimensions
    stay even and min(H, W) stays >= min_dim; an explicit ``levels`` is
    clipped to that limit."""
    max_div = 0
    h, w = H, W
    while h % 2 == 0 and w % 2 == 0 and min(h, w) >= 2 * min_dim:
        h, w = h // 2, w // 2
        max_div += 1
    if levels is None:
        return max_div
    return max(0, min(levels, max_div))


def downsample2x(u0):
    """Exact 2x2 mean pooling of (H, W) or (H, W, C), H and W even: the
    four cells summed row by row, then divided by 4."""
    H, W = u0.shape[:2]
    if H % 2 or W % 2:
        raise ValueError(f"downsample2x needs even dims, got "
                         f"{tuple(u0.shape)}")
    x = u0.reshape((H // 2, 2, W // 2, 2) + tuple(u0.shape[2:]))
    return (((x[:, 0, :, 0] + x[:, 0, :, 1]) + x[:, 1, :, 0])
            + x[:, 1, :, 1]) / 4.0


def upsample_phi2x(phi):
    """Bilinear 2x upsample of an (H, W) level set, values doubled (an
    SDF's distances double in the finer grid's pixels). Half-pixel
    centres; the border rows and columns take the edge cell's value."""
    H, W = phi.shape
    up = F.interpolate(phi[None, None], size=(2 * H, 2 * W),
                       mode="bilinear", align_corners=False)[0, 0]
    return up * 2.0


def upsample_ls2x(ls):
    """Nearest-neighbour 2x upsample of a binary level set (each coarse
    cell becomes a 2x2 block)."""
    return ls.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def _images(u0, L: int):
    """The image pyramid, fine -> coarse."""
    images = [u0]
    for _ in range(L):
        images.append(downsample2x(images[-1]))
    return images


def _coarse_to_fine(u0, L: int, start, solve, lift):
    """``solve(image, start)`` at each level of the image pyramid, coarse
    to fine, each finer level starting from ``lift(result)``: (the finest
    level's result, level_iters)."""
    res, level_iters = None, []
    for lvl, u in enumerate(reversed(_images(u0, L))):
        res = solve(u, start)
        level_iters.append(int(res.iters))
        if lvl < L:
            start = lift(res)
    return res, tuple(level_iters)


def _pool_phi(phi, L: int):
    """A full-resolution start pooled to the coarsest level (distances
    halve at each level)."""
    for _ in range(L):
        phi = downsample2x(phi) * 0.5
    return phi


def segment_pyramid(u0, p: CVParams = CVParams(),
                    levels: Optional[int] = None,
                    phi0: Optional[torch.Tensor] = None,
                    lambda1: Optional[Sequence[float]] = None,
                    lambda2: Optional[Sequence[float]] = None,
                    min_dim: int = 128) -> PyramidResult:
    """Coarse-to-fine segmentation to convergence, each level a
    ``segment_banded`` run (the banded, fused or plain route its routing
    gives the level's shape). ``phi0`` (optional) seeds the coarsest
    level, mean-pooled down. Per-channel lambda tuples for (H, W, C)."""
    if u0.ndim == 3:
        lambda1, lambda2 = p.channel_lambdas(u0.shape[-1], lambda1, lambda2)
    L = plan_levels(*u0.shape[:2], levels=levels, min_dim=min_dim)
    res, level_iters = _coarse_to_fine(
        u0, L, None if phi0 is None else _pool_phi(phi0, L),
        lambda u, phi: segment_banded(u, p, phi0=phi, lambda1=lambda1,
                                      lambda2=lambda2),
        lambda r: _reinit.reinit(upsample_phi2x(r.phi), p.reinit_steps))
    return PyramidResult(res.phi, res.mask, res.iters, res.delta, res.c1,
                         res.c2, level_iters)


def segment_pyramid_multiphase(u0, p: CVParams = CVParams(),
                               m_sets: int = 2,
                               levels: Optional[int] = None,
                               phis0: Optional[torch.Tensor] = None,
                               min_dim: int = 128
                               ) -> MultiphasePyramidResult:
    """Coarse-to-fine multiphase segmentation, each level a
    ``segment_multiphase`` run on its auto route; across levels every
    level set is upsampled and redistanced on its own (one R1 chain for
    the stack). ``phis0`` (optional, (M, H, W)) seeds the coarsest
    level."""
    from .multiphase import segment_multiphase

    L = plan_levels(*u0.shape[:2], levels=levels, min_dim=min_dim)
    res, level_iters = _coarse_to_fine(
        u0, L, (None if phis0 is None
                else torch.stack([_pool_phi(ph, L) for ph in phis0])),
        lambda u, phis: segment_multiphase(u, p, m_sets=m_sets, phis0=phis),
        lambda r: _reinit.reinit(
            torch.stack([upsample_phi2x(ph) for ph in r.phis]),
            p.reinit_steps))
    return MultiphasePyramidResult(res.phis, res.labels, res.iters,
                                   res.delta, res.cs, level_iters)


def plan_levels_sharded(H: int, W: int, nx: int, ny: int,
                        levels: Optional[int] = None, min_dim: int = 128,
                        comm_k: int = 1, halo: str = "ppermute") -> int:
    """:func:`plan_levels` walked down until the coarsest level keeps the
    sharded drivers' constraints: divisible by the mesh, shards deep
    enough for comm_k's 4k halos, at least 16x16 under 'overlap' (each
    finer level keeps them too)."""
    L = plan_levels(H, W, levels=levels, min_dim=min_dim)

    def ok(h, w):
        if h % nx or w % ny:
            return False
        sh, sw = h // nx, w // ny
        if comm_k > 1 and 4 * comm_k > min(sh, sw):
            return False
        if halo == "overlap" and min(sh, sw) < 16:
            return False
        return True

    while L > 0 and not ok(H >> L, W >> L):
        L -= 1
    return L


def segment_pyramid_sharded(u0, p: CVParams = CVParams(), mesh=None,
                            levels: Optional[int] = None,
                            phi0: Optional[torch.Tensor] = None,
                            lambda1: Optional[Sequence[float]] = None,
                            lambda2: Optional[Sequence[float]] = None,
                            min_dim: int = 128,
                            use_pallas: Optional[bool] = None,
                            halo: str = "ppermute",
                            comm_k: int = 1) -> PyramidResult:
    """Coarse-to-fine segmentation over a grid mesh, each level a
    ``parallel.segment_sharded`` tolerance run on the same mesh; between
    levels the gathered level set is upsampled and redistanced on the
    mesh's first device. Levels are planned by
    :func:`plan_levels_sharded`."""
    from ..parallel.sharded import segment_sharded

    if mesh is None:
        raise ValueError("segment_pyramid_sharded needs a mesh "
                         "(parallel.mesh.make_grid_mesh)")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    L = plan_levels_sharded(*u0.shape[:2], nx, ny, levels=levels,
                            min_dim=min_dim, comm_k=comm_k, halo=halo)
    if u0.ndim == 3:
        lambda1, lambda2 = p.channel_lambdas(u0.shape[-1], lambda1, lambda2)
    res, level_iters = _coarse_to_fine(
        u0, L, None if phi0 is None else _pool_phi(phi0, L),
        lambda u, phi: segment_sharded(
            u, p, mesh, phi0=phi, lambda1=lambda1, lambda2=lambda2,
            use_pallas=use_pallas, halo=halo, comm_k=comm_k),
        lambda r: _reinit.reinit(upsample_phi2x(r.phi), p.reinit_steps))
    return PyramidResult(res.phi, res.mask, res.iters, res.delta, res.c1,
                         res.c2, level_iters)


def _binary_start(ls0, u0, L: int):
    """A binary start (bool, or >= 0.5) in the image's dtype, pooled to the
    coarsest level by the >= 0.5 vote of each 2x2 block."""
    if ls0 is None:
        return None
    ls = (ls0 if ls0.dtype == torch.bool else ls0 >= 0.5).to(u0.dtype)
    for _ in range(L):
        ls = (downsample2x(ls) >= 0.5).to(u0.dtype)
    return ls


def segment_pyramid_morph(u0, p: CVParams = CVParams(),
                          levels: Optional[int] = None,
                          ls0: Optional[torch.Tensor] = None,
                          smoothing: int = 1,
                          lambda1=None, lambda2=None,
                          min_dim: int = 128) -> MorphPyramidResult:
    """Coarse-to-fine MorphACWE to convergence, each level a
    ``segment_morph`` run (K11 on the card where its envelope holds);
    ``ls0`` (optional) seeds the coarsest level."""
    from .morph import segment_morph

    L = plan_levels(*u0.shape[:2], levels=levels, min_dim=min_dim)
    res, level_iters = _coarse_to_fine(
        u0, L, _binary_start(ls0, u0, L),
        lambda u, ls: segment_morph(u, p, ls0=ls, smoothing=smoothing,
                                    lambda1=lambda1, lambda2=lambda2),
        lambda r: upsample_ls2x(r.ls))
    return MorphPyramidResult(res.ls, res.mask, res.iters, res.delta,
                              level_iters)


def segment_pyramid_gac(u0, p: CVParams = CVParams(),
                        levels: Optional[int] = None,
                        ls0: Optional[torch.Tensor] = None,
                        smoothing: int = 1,
                        balloon: int = 0,
                        threshold: float = 0.5,
                        gac_alpha: float = 5.0,
                        gac_sigma: float = 3.0,
                        min_dim: int = 128) -> MorphPyramidResult:
    """Coarse-to-fine MorphGAC on the RAW image: each level's edge map is
    ``inverse_gaussian_gradient`` of that level's pooled image with the
    same alpha and sigma, then a ``segment_gac`` run. ``threshold`` is the
    float threshold of every level."""
    from ..ops.morph import inverse_gaussian_gradient
    from .morph_gac import segment_gac

    L = plan_levels(*u0.shape[:2], levels=levels, min_dim=min_dim)
    res, level_iters = _coarse_to_fine(
        u0, L, _binary_start(ls0, u0, L),
        lambda u, ls: segment_gac(
            inverse_gaussian_gradient(u, gac_alpha, gac_sigma), p, ls0=ls,
            smoothing=smoothing, balloon=balloon, threshold=threshold),
        lambda r: upsample_ls2x(r.ls))
    return MorphPyramidResult(res.ls, res.mask, res.iters, res.delta,
                              level_iters)
