"""Morphological Chan-Vese (MorphACWE) segmentation driver.

Counterpart of ``chan_vese_tpu/models/morph.py``: the morphological
approximation of the Chan-Vese flow (Marquez-Neila et al., PAMI 2014; the
algorithm scikit-image ships as ``morphological_chan_vese``). Each
iteration is

    c_in, c_out = binary region means of the image
    ls          = discrete ACWE force step (sign of the data force at
                  contour pixels)
    ls          = ``smoothing`` alternating SIoIS / ISoSI cycles

on a binary {0, 1} level set, for grayscale (H, W) and vector-valued
(H, W, C) images with per-channel lambdas.

Routes (``morph_gac._route_kernel``, the reference's): on a CUDA tensor
with a geometry the reference sends to its banded kernel, the drivers run
K11 in k-iteration chunks (``ops/morph_kernel.morph_chunk``; auto k = 8)
with the region means, and so the force, frozen per chunk (the
frozen-means trajectory class of the banded PDE route; k = 1 is the
per-iteration scheme). ``segment_morph_iterations(fuse_force=True)`` runs
K12 instead, which computes the force in the kernel and returns the next
chunk's partials. Elsewhere the plain per-iteration path. Explicit
``use_pallas=True`` takes the chunked route on any device (a CPU tensor
runs the kernels' plain versions) or raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops import morph_kernel
from ..ops.morph import (acwe_energy, acwe_force, acwe_step, binary_means,
                         smooth)
from ..params import CVParams
from .morph_gac import (_init_ls, _route_kernel, _Tolerance, chunk_sizes,
                        flip_fraction, run_chunks)


class MorphResult(NamedTuple):
    ls: torch.Tensor     # final binary level set (H, W), values {0.0, 1.0}
    mask: torch.Tensor   # ls >= 0.5 (bool)
    iters: int           # iterations actually run
    delta: torch.Tensor  # final flip fraction (NaN where not tracked)
    c1: torch.Tensor     # inside mean(s)  (0-d or (C,))
    c2: torch.Tensor     # outside mean(s)


class MorphTrace(NamedTuple):
    ls: torch.Tensor
    mask: torch.Tensor
    energy: torch.Tensor  # (iters,) ACWE data energy after each iteration
    delta: torch.Tensor   # (iters,) flip fraction of each iteration
    c1: torch.Tensor      # (iters, ...) means used by each iteration
    c2: torch.Tensor


def _lambdas(u0, p: CVParams, lambda1, lambda2):
    """(lambda1, lambda2) as tensors of u0's dtype: (C,) per channel for an
    (H, W, C) image, 0-d for a gray one."""
    if u0.ndim == 3:
        l1, l2 = p.channel_lambdas(u0.shape[-1], lambda1, lambda2)
    else:
        l1 = p.lambda1 if lambda1 is None else float(lambda1)
        l2 = p.lambda2 if lambda2 is None else float(lambda2)
    return (torch.as_tensor(l1, dtype=u0.dtype, device=u0.device),
            torch.as_tensor(l2, dtype=u0.dtype, device=u0.device))


def morph_step(ls, u0, l1, l2, k: int, smoothing: int):
    """One full MorphACWE iteration; returns (ls_new, c_in, c_out, flips).
    ``k`` is the smoothing-call counter (iteration n starts at k = n s)."""
    c_in, c_out = binary_means(u0, ls)
    ls_new = smooth(acwe_step(ls, u0, c_in, c_out, l1, l2), k, smoothing)
    # NaN-poison: a non-finite image or mean must abort the loop instead of
    # freezing the binary state and reading 0 flips as convergence
    flips = (flip_fraction(ls_new, ls)
             + 0.0 * (torch.sum(c_in) + torch.sum(c_out)))
    return ls_new, c_in, c_out, flips


def _force_plane(u0, ls, l1, l2):
    """The frozen ACWE force from the current level set's means (summed
    over channels): the per-chunk input of K11's acwe kind."""
    c_in, c_out = binary_means(u0, ls)
    return acwe_force(u0, c_in, c_out, l1, l2)


def _segment_morph_chunked(u0, p: CVParams, ls_init, s: int, l1, l2,
                           kk: int) -> MorphResult:
    """Tolerance-mode MorphACWE through K11, k iterations per chunk."""
    st, ls = _Tolerance(p, u0), ls_init

    def run_chunk(size):
        nonlocal ls
        f = _force_plane(u0, ls, l1, l2)
        # parity0 = 0: every chunk starts at a multiple of k, and
        # (k s) % 2 == 0
        ls_new = morph_kernel.morph_chunk(ls, f, k=size, smoothing=s,
                                          parity0=0)
        # NaN-poison through the force plane
        flips = flip_fraction(ls_new, ls) + 0.0 * torch.sum(f)
        ls = ls_new
        return flips

    run_chunks(st, p.max_iter, kk, run_chunk)
    c1, c2 = binary_means(u0, ls)
    return MorphResult(ls, ls >= 0.5, st.n, st.delta, c1, c2)


def segment_morph(u0, p: CVParams = CVParams(),
                  ls0: Optional[torch.Tensor] = None,
                  smoothing: int = 1,
                  lambda1=None, lambda2=None,
                  use_pallas: Optional[bool] = None,
                  k: Optional[int] = None) -> MorphResult:
    """Segment to convergence (flip-fraction tol) or p.max_iter.

    The metric is always the mask-flip fraction (``p.conv_norm`` is
    ignored), the minimum of the flips against the previous state and
    against the state two iterations back: the alternating smoothing
    settles into period-2 limit cycles on a few boundary pixels, which is
    convergence. ``ls0`` (optional) seeds the level set by its >= 0.5
    threshold; otherwise ``p.init`` names the shape. On the kernel route
    the metric is the chunk flip fraction, a below-tol chunk credits its
    k iterations to the patience streak, and max_iter stays exact."""
    l1, l2 = _lambdas(u0, p, lambda1, lambda2)
    ls_init = _init_ls(u0, p, ls0)
    s = int(smoothing)
    use_k, kk = _route_kernel(u0.shape[:2], k, s, "acwe", use_pallas,
                              u0.is_cuda)
    if use_k:
        return _segment_morph_chunked(u0, p, ls_init, s, l1, l2, kk)
    st, ls, ls_prev = _Tolerance(p, u0), ls_init, ls_init
    while st.more():
        ls_new, _, _, flips = morph_step(ls, u0, l1, l2, st.n * s, s)
        delta = torch.minimum(flips, flip_fraction(ls_new, ls_prev))
        ls_prev, ls = ls, ls_new
        st.record(delta)
    c1, c2 = binary_means(u0, ls)
    return MorphResult(ls, ls >= 0.5, st.n, st.delta, c1, c2)


def segment_morph_sharded(u0, p: CVParams = CVParams(), mesh=None,
                          ls0: Optional[torch.Tensor] = None,
                          smoothing: int = 1,
                          lambda1=None, lambda2=None) -> MorphResult:
    """MorphACWE over a 2-D ('x', 'y') grid mesh, (H, W) or (H, W, C), H
    and W divisible by the mesh: :func:`segment_morph`'s per-iteration
    scheme and stopping rule (means every iteration, the 2-cycle
    detector), run shard by shard with one halo exchange of the
    iteration's reach each iteration and the region sums summed over the
    shards; the image is never gathered onto one device. The result (the
    level set gathered onto the mesh's first device, the iteration count
    and delta) is the reference's, which runs ``segment_morph`` on sharded
    arrays with ``use_pallas=False``; the means' sums may differ from the
    unsharded run in their last ulps (summed per shard)."""
    from ..parallel.sharded_morph import morph_sharded

    return morph_sharded(u0, p, mesh, ls0, smoothing, lambda1, lambda2)


def segment_morph_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                        ls0: Optional[torch.Tensor] = None,
                        smoothing: int = 1,
                        lambda1=None, lambda2=None,
                        start_iter: int = 0) -> MorphTrace:
    """Fixed-iteration MorphACWE with a per-iteration trace. ``start_iter``
    offsets the smoothing-call counter so chunked runs keep the exact
    SIoIS / ISoSI alternation of one long run."""
    l1, l2 = _lambdas(u0, p, lambda1, lambda2)
    ls = _init_ls(u0, p, ls0)
    s = int(smoothing)
    es, ds, c1s, c2s = [], [], [], []
    for n in range(start_iter, start_iter + iters):
        ls, c_in, c_out, flips = morph_step(ls, u0, l1, l2, n * s, s)
        c1n, c2n = binary_means(u0, ls)
        es.append(acwe_energy(u0, ls, c1n, c2n, l1, l2))
        ds.append(flips)
        c1s.append(c_in)
        c2s.append(c_out)
    if not es:
        shape = (0, *l1.shape)
        empty = torch.empty(0, dtype=u0.dtype, device=u0.device)
        means = torch.empty(shape, dtype=u0.dtype, device=u0.device)
        return MorphTrace(ls, ls >= 0.5, empty, empty, means, means)
    return MorphTrace(ls, ls >= 0.5, torch.stack(es), torch.stack(ds),
                      torch.stack(c1s), torch.stack(c2s))


def segment_morph_iterations(u0, p: CVParams = CVParams(),
                             iters: int = 100,
                             ls0: Optional[torch.Tensor] = None,
                             smoothing: int = 1,
                             lambda1=None, lambda2=None,
                             start_iter: int = 0,
                             use_pallas: Optional[bool] = None,
                             k: Optional[int] = None,
                             fuse_force: bool = False) -> MorphResult:
    """Lean fixed-iteration MorphACWE: no trace, no host read.

    On the kernel route the means (and the force) are frozen across each
    k-iteration chunk: full chunks, then one remainder. ``fuse_force``
    runs K12, which computes the force in the kernel from the image and
    the means and returns (n_in, sum_in) of its final state, from which
    the next chunk's means follow with no pass over the image; the first
    chunk's means come from ``binary_means``. It needs a gray image: an
    (H, W, C) one raises ValueError (the reference ignores the flag
    there)."""
    if fuse_force and u0.ndim == 3:
        raise ValueError("fuse_force needs a gray (H, W) image; the fused "
                         "kernel computes a single-channel force")
    l1, l2 = _lambdas(u0, p, lambda1, lambda2)
    ls = _init_ls(u0, p, ls0)
    s = int(smoothing)
    use_k, kk = _route_kernel(u0.shape[:2], k, s,
                              "acwe_fused" if fuse_force else "acwe",
                              use_pallas, u0.is_cuda)
    parity0 = (int(start_iter) * s) % 2
    sizes = chunk_sizes(int(iters), kk)
    if use_k and fuse_force:
        n_pix = torch.tensor(u0.numel(), dtype=u0.dtype, device=u0.device)
        sum_u = torch.sum(u0)
        ci, co = binary_means(u0, ls)
        for size in sizes:
            ls, parts = morph_kernel.morph_chunk_fused(
                ls, u0, ci, co, l1, l2, k=size, smoothing=s, parity0=parity0)
            n_in, s_in = parts[0], parts[1]
            ci = s_in / (n_in + 1e-8)
            co = (sum_u - s_in) / (n_pix - n_in + 1e-8)
    elif use_k:
        for size in sizes:
            ls = morph_kernel.morph_chunk(ls, _force_plane(u0, ls, l1, l2),
                                          k=size, smoothing=s,
                                          parity0=parity0)
    else:
        for n in range(start_iter, start_iter + iters):
            ls = morph_step(ls, u0, l1, l2, n * s, s)[0]
    c1, c2 = binary_means(u0, ls)
    nan = torch.tensor(math.nan, dtype=u0.dtype, device=u0.device)
    return MorphResult(ls, ls >= 0.5, int(iters), nan, c1, c2)
