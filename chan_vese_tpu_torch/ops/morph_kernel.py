"""K11 and K12: k morphological iterations per pass over device memory on
a binary level set.

Counterpart of ``chan_vese_tpu/ops/pallas_morph.py`` (kinds ``acwe``,
``gac``, ``gac_pre`` of ``_morph_banded_kernel`` on a whole image, its
shard kinds ``acwe_sh`` and ``gac_pre_sh`` on a shard's padded block, and
``_morph_fused_kernel``). On a CUDA tensor :func:`morph_chunk`,
:func:`gac_chunk`, :func:`morph_chunk_shard` and :func:`gac_chunk_shard`
launch ``csrc/morph_band.cu`` and :func:`morph_chunk_fused`
``csrc/morph_fused.cu``; on a CPU tensor each runs its ``_reference``
plain version.

Schedule (all three): iteration j of a chunk is the force step, then
``smoothing`` cycles, cycle c SIoIS when (parity0 + j s + c) is even and
ISoSI otherwise. ACWE holds the force f frozen over the chunk (k = 1 is the
per-iteration-means scheme); GAC has no reduction in its loop, so its chunks
are the per-iteration trajectory for any k. The level set must hold only
0.0 and 1.0: the kernels keep it as bytes.

``_reach``, ``_halo_morph``, ``band_rows_morph`` and
``supports_morph_banded`` (with ``_TILES_BY_KIND``, ``_SCOPED_TILES`` and
``_VMEM_BUDGET``) are the reference's routing terms, pure integer
functions of the shape that the drivers use to pick the reference's route
and so its trajectory class. They are not limits of the Hopper kernels,
which take any shape, any k >= 1 and either parity0.
"""

from __future__ import annotations

import torch

from . import _cuda
from .fused_kernel import _VMEM_LIMIT
from .morph import (acwe_force, acwe_force_step, gac_step, padded_iteration,
                    smooth)
from .numerics import grad_central

# routing constants of chan_vese_tpu/ops/pallas_morph.py
_TILES_BY_KIND = {"acwe": 18, "gac": 24, "gac_pre": 28, "acwe_fused": 22,
                  "acwe_sh": 20, "gac_pre_sh": 30}
_SCOPED_TILES = {"acwe": 14, "gac": 16, "gac_pre": 20, "acwe_fused": 18,
                 "acwe_sh": 16, "gac_pre_sh": 22}
_VMEM_BUDGET = _VMEM_LIMIT


def _reach(kind: str, smoothing: int) -> int:
    """Neighbor reach of one full iteration."""
    return (1 if kind.startswith("acwe") else 2) + 2 * smoothing


def _halo_morph(k: int, smoothing: int, kind: str) -> int:
    """The reference's symmetric halo for k iterations, 8-row aligned."""
    return -(-_reach(kind, smoothing) * k // 8) * 8


def band_rows_morph(h: int, w: int, k: int, smoothing: int,
                    kind: str) -> int:
    """The reference's band height for k in-tile iterations."""
    hal = _halo_morph(k, smoothing, kind)
    per_row = w * 4 * _TILES_BY_KIND[kind]
    b_budget = max(8, (_VMEM_BUDGET // per_row) // 8 * 8)
    t_scoped = _VMEM_BUDGET // (w * 4 * _SCOPED_TILES[kind])
    b_scoped = (t_scoped - 2 * hal) // 8 * 8
    b = min(b_budget, max(8, b_scoped))
    return min(b, max(8, ((h - 2 * hal) // 8) * 8))


def supports_morph_banded(h: int, w: int, k: int, smoothing: int,
                          kind: str = "acwe") -> bool:
    """Whether the reference routes (h, w, k, smoothing, kind) to its
    banded kernel (the drivers also need (k smoothing) % 2 == 0)."""
    hal = _halo_morph(k, smoothing, kind)
    b = band_rows_morph(h, w, k, smoothing, kind)
    return (w % 128 == 0 and h % 8 == 0 and 1 <= k <= 64
            and b + 2 * hal <= h
            and (b + 2 * hal) * w * 4 * _SCOPED_TILES[kind] <= _VMEM_BUDGET)


def _check(ls, aux, aux_shape, k: int, smoothing: int, parity0: int):
    if ls.ndim != 2:
        raise ValueError(f"ls must be (H, W), got {tuple(ls.shape)}")
    if tuple(aux.shape) != tuple(aux_shape):
        raise ValueError(f"expected {tuple(aux_shape)} beside ls "
                         f"{tuple(ls.shape)}, got {tuple(aux.shape)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if smoothing < 0:
        raise ValueError(f"smoothing must be >= 0, got {smoothing}")
    if parity0 not in (0, 1):
        raise ValueError(f"parity0 must be 0 or 1, got {parity0}")


def morph_chunk_reference(ls, f, k: int = 8, smoothing: int = 1,
                          parity0: int = 0):
    """Plain PyTorch version of :func:`morph_chunk`."""
    for j in range(k):
        ls = smooth(acwe_force_step(ls, f), parity0 + j * smoothing,
                    smoothing)
    return ls


def morph_chunk(ls, f, k: int = 8, smoothing: int = 1, parity0: int = 0):
    """k MorphACWE iterations against the frozen data force ``f`` =
    lambda1 (img - c_in)^2 - lambda2 (img - c_out)^2 (summed over
    channels), computed by the driver per chunk. Returns the new level
    set."""
    _check(ls, f, ls.shape, k, smoothing, parity0)
    if ls.device.type == "cpu":
        return morph_chunk_reference(ls, f, k, smoothing, parity0)
    out = _cuda.launch_morph("acwe", ls, f, k, smoothing, parity0, 0, 0.0,
                             _reach("acwe", smoothing) * k)
    morph_chunk.launches += 1
    return out


morph_chunk.launches = 0


def _scalars(ls, *vals):
    return [torch.as_tensor(v, dtype=ls.dtype, device=ls.device)
            for v in vals]


def morph_chunk_fused_reference(ls, u0, c_in, c_out, l1, l2, k: int = 8,
                                smoothing: int = 1, parity0: int = 0):
    """Plain PyTorch version of :func:`morph_chunk_fused`: the force in
    ls's dtype op by op, k frozen-force iterations, then (sum ls,
    sum u0 ls) summed in float64 and returned in ls's dtype."""
    c_in, c_out, l1, l2 = _scalars(ls, c_in, c_out, l1, l2)
    ls = morph_chunk_reference(ls, acwe_force(u0, c_in, c_out, l1, l2), k,
                               smoothing, parity0)
    parts = torch.stack([ls.sum(dtype=torch.float64),
                         (u0 * ls).sum(dtype=torch.float64)])
    return ls, parts.to(ls.dtype)


def morph_chunk_fused(ls, u0, c_in, c_out, l1, l2, k: int = 8,
                      smoothing: int = 1, parity0: int = 0):
    """k MorphACWE iterations with the force f = l1 (u0 - c_in)^2 -
    l2 (u0 - c_out)^2 computed in the kernel from the raw gray image u0
    and the frozen means, and the next chunk's region partials returned:
    (ls_new, (n_in, sum_in)) in ls's dtype."""
    _check(ls, u0, ls.shape, k, smoothing, parity0)
    if ls.device.type == "cpu":
        return morph_chunk_fused_reference(ls, u0, c_in, c_out, l1, l2, k,
                                           smoothing, parity0)
    cc = torch.stack([t.reshape(()) for t in
                      _scalars(ls, c_in, c_out, l1, l2)])
    out = _cuda.launch_morph_fused(ls, u0, cc, k, smoothing, parity0,
                                   _reach("acwe_fused", smoothing) * k)
    morph_chunk_fused.launches += 1
    return out


morph_chunk_fused.launches = 0


def _thr_b(balloon, threshold) -> float:
    return threshold / abs(float(balloon)) if balloon else 0.0


def gac_aux_stack(g, balloon: int, threshold: float):
    """The (3, H, W) run-invariant stack (dgx, dgy, balloon mask) the
    ``pre_dg`` kernel streams; compute once per run."""
    dgx, dgy = grad_central(g)
    if balloon:
        thr = torch.tensor(_thr_b(balloon, threshold), dtype=g.dtype,
                           device=g.device)
        mask = (g > thr).to(g.dtype)
    else:
        mask = torch.zeros_like(g)
    return torch.stack([dgx, dgy, mask])


def gac_chunk_reference(ls, g, k: int = 8, smoothing: int = 1,
                        parity0: int = 0, balloon: int = 0,
                        threshold: float = 0.5, pre_dg: bool = False):
    """Plain PyTorch version of :func:`gac_chunk` (``g`` an (H, W) edge
    map, or with ``pre_dg`` its prebuilt (3, H, W) stack)."""
    aux = g if g.ndim == 3 else gac_aux_stack(g, balloon, threshold)
    dgx, dgy, mask = aux[0], aux[1], aux[2]
    for j in range(k):
        ls = smooth(gac_step(ls, dgx, dgy, mask, int(balloon)),
                    parity0 + j * smoothing, smoothing)
    return ls


def gac_chunk(ls, g, k: int = 8, smoothing: int = 1, parity0: int = 0,
              balloon: int = 0, threshold: float = 0.5,
              pre_dg: bool = False):
    """k MorphGAC iterations in one pass, the per-iteration trajectory for
    any k. ``pre_dg=False``: the kernel takes the edge map g and computes
    dgx, dgy and the balloon mask g > threshold / |balloon| once per launch
    (kind gac). ``pre_dg=True``: it streams the (3, H, W) stack of
    :func:`gac_aux_stack` (kind gac_pre); ``g`` may be that stack already,
    so that chunk loops build it once."""
    stacked = pre_dg and g.ndim == 3
    _check(ls, g, (3, *ls.shape) if stacked else ls.shape, k, smoothing,
           parity0)
    if ls.device.type == "cpu":
        return gac_chunk_reference(ls, g, k, smoothing, parity0, balloon,
                                   threshold, pre_dg)
    b = int(balloon)
    if pre_dg:
        aux = g if stacked else gac_aux_stack(g, b, threshold)
        kind = "gac_pre"
    else:
        aux, kind = g, "gac"
    out = _cuda.launch_morph(kind, ls, aux.contiguous(), k, smoothing,
                             parity0, b, _thr_b(b, threshold),
                             _reach(kind, smoothing) * k)
    gac_chunk.launches += 1
    gac_chunk.kind_launches[kind] += 1
    return out


# launches of both kinds, and of each
gac_chunk.launches = 0
gac_chunk.kind_launches = {"gac": 0, "gac_pre": 0}


# shard kinds: a shard's halo-padded block --------------------------------

def shard_ring(x, crop, flags):
    """The depth-1 replica ring of a shard block refreshed from its edge
    cells on the flagged sides, rows first and then columns (so a corner
    takes the corner cell): the plain version of the shard kinds' refresh,
    the ``rim`` callback of
    ``chan_vese_tpu/ops/pallas_morph.py::_morph_banded_kernel``."""
    r0, r1, c0, c1 = crop
    top, bottom, left, right = flags
    x = x.clone()
    if top:
        x[r0 - 1] = x[r0]
    if bottom:
        x[r1] = x[r1 - 1]
    if left:
        x[:, c0 - 1] = x[:, c0]
    if right:
        x[:, c1] = x[:, c1 - 1]
    return x


def _shard_block(ls, pads, flags):
    """(crop, flags as four ints) of a padded (H, W) block with ``pads`` =
    (pt, pb, pcl, pcr) and ``flags`` = [top, bottom, left, right] (any
    truthy values; the reference's (1, 4) float array too). A flagged side
    needs a pad to hold its replica ring."""
    h, w = ls.shape
    pt, pb, pcl, pcr = (int(v) for v in pads)
    vals = flags.reshape(-1).tolist() if hasattr(flags, "reshape") else flags
    fl = tuple(int(bool(v)) for v in vals)
    if len(fl) != 4:
        raise ValueError(f"flags must be [top, bottom, left, right], got "
                         f"{flags}")
    if min(pt, pb, pcl, pcr) < 0 or pt + pb >= h or pcl + pcr >= w:
        raise ValueError(f"pads {tuple(pads)} leave no cells of the "
                         f"{(h, w)} block")
    if any(f and d < 1 for f, d in zip(fl, (pt, pb, pcl, pcr))):
        raise ValueError(f"pads {tuple(pads)} hold no replica ring on a "
                         f"flagged side (flags {fl})")
    return (pt, h - pb, pcl, w - pcr), fl


def _shard_chunk_reference(ls, aux, crop, fl, kind, k, smoothing, parity0,
                           balloon):
    u = ls
    for j in range(k):
        u = padded_iteration(u, aux, j, kind, smoothing, parity0, balloon,
                             lambda x: shard_ring(x, crop, fl))
    r0, r1, c0, c1 = crop
    out = ls.clone()
    out[r0:r1, c0:c1] = u[r0:r1, c0:c1]
    return out


def morph_chunk_shard_reference(ls_pad, f_pad, flags, pads, k: int = 8,
                                smoothing: int = 1, parity0: int = 0):
    """Plain PyTorch version of :func:`morph_chunk_shard`: the iterations on
    the whole block (reads clamped at its edge) with the ring refreshed
    before every elementary op, then the block's own cells written into
    the input."""
    crop, fl = _shard_block(ls_pad, pads, flags)
    return _shard_chunk_reference(ls_pad, f_pad, crop, fl, "acwe", k,
                                  smoothing, parity0, 0)


def morph_chunk_shard(ls_pad, f_pad, flags, pads, k: int = 8,
                      smoothing: int = 1, parity0: int = 0):
    """k MorphACWE iterations against the frozen force ``f_pad`` on a
    shard's halo-padded block ``ls_pad`` (H, W). ``pads`` = (pt, pb, pcl,
    pcr) pad depths, so the shard's own cells are [pt, H - pb) x [pcl,
    W - pcr); ``flags`` = [top, bottom, left, right] marks the global-edge
    sides, whose depth-1 replica ring is refreshed before every elementary
    op. The own cells are exact where the unflagged pads are R k deep;
    cells outside them come back as they went in (the reference's kernel
    sweeps them and its driver crops them away). Returns the new block.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    launch ``csrc/morph_band.cu``'s ``cv_morph_chunk_shard`` (kind
    acwe_sh) or raise."""
    _check(ls_pad, f_pad, ls_pad.shape, k, smoothing, parity0)
    if ls_pad.device.type == "cpu":
        return morph_chunk_shard_reference(ls_pad, f_pad, flags, pads, k,
                                           smoothing, parity0)
    _, fl = _shard_block(ls_pad, pads, flags)
    out = _cuda.launch_morph("acwe_sh", ls_pad, f_pad, k, smoothing, parity0,
                             0, 0.0, _reach("acwe", smoothing) * k,
                             shard=(*(int(v) for v in pads), *fl))
    morph_chunk_shard.launches += 1
    return out


morph_chunk_shard.launches = 0


def gac_chunk_shard_reference(ls_pad, aux_pad, flags, pads, k: int = 4,
                              smoothing: int = 1, parity0: int = 0,
                              balloon: int = 0, threshold: float = 0.5):
    """Plain PyTorch version of :func:`gac_chunk_shard`."""
    crop, fl = _shard_block(ls_pad, pads, flags)
    return _shard_chunk_reference(ls_pad, aux_pad, crop, fl, "gac", k,
                                  smoothing, parity0, int(balloon))


def gac_chunk_shard(ls_pad, aux_pad, flags, pads, k: int = 4,
                    smoothing: int = 1, parity0: int = 0, balloon: int = 0,
                    threshold: float = 0.5):
    """k MorphGAC iterations on a shard's halo-padded block ``ls_pad`` (H,
    W) with ``aux_pad`` the (3, H, W) (dgx, dgy, balloon mask) stack of the
    padded edge map (:func:`gac_aux_stack`, a run invariant; ``threshold``
    is then only the reference's argument); ``flags``, ``pads`` and the
    result as :func:`morph_chunk_shard`, the per-iteration trajectory for
    any k.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    launch ``csrc/morph_band.cu``'s ``cv_morph_chunk_shard`` (kind
    gac_pre_sh) or raise."""
    _check(ls_pad, aux_pad, (3, *ls_pad.shape), k, smoothing, parity0)
    if ls_pad.device.type == "cpu":
        return gac_chunk_shard_reference(ls_pad, aux_pad, flags, pads, k,
                                         smoothing, parity0, balloon,
                                         threshold)
    _, fl = _shard_block(ls_pad, pads, flags)
    b = int(balloon)
    out = _cuda.launch_morph("gac_pre_sh", ls_pad, aux_pad.contiguous(), k,
                             smoothing, parity0, b, _thr_b(b, threshold),
                             _reach("gac_pre_sh", smoothing) * k,
                             shard=(*(int(v) for v in pads), *fl))
    gac_chunk_shard.launches += 1
    return out


gac_chunk_shard.launches = 0
