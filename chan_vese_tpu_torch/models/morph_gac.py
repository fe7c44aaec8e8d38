"""Morphological geodesic active contours (MorphGAC) driver.

Counterpart of ``chan_vese_tpu/models/morph_gac.py``. GAC segments a
preprocessed edge map g (``ops.morph.inverse_gaussian_gradient``: about 1
in flat regions, about 0 on edges), not the raw image. Each iteration is

    balloon     dilate (grow) or erode (shrink) the binary region where
                g > threshold / |balloon| (far from any edge)
    attraction  move contour pixels along grad(g)
    smoothing   the shared alternating SIoIS / ISoSI cycles

with no reduction in the loop: the edge map's gradient and the balloon
mask are run invariants, computed once.

Routes (:func:`_route_kernel`, the reference's): on a CUDA tensor with a
geometry the reference sends to its banded kernel, the drivers run K11 in
k-iteration chunks (``ops/morph_kernel.gac_chunk``; auto k = 4), which is
the per-iteration trajectory for any k; elsewhere the plain per-iteration
path. Explicit ``use_pallas=True`` takes the chunked route on any device
(on a CPU tensor through the kernels' plain versions) or raises. The
tolerance loop reads the flip metric back once per iteration (plain) or
once per chunk (kernel route).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..ops import morph_kernel
from ..ops.morph import gac_step, smooth
from ..ops.morph_kernel import gac_aux_stack, supports_morph_banded
from ..ops.reductions import loop_continue
from ..params import CVParams
from ..utils.init_phi import init_phi


class GACResult(NamedTuple):
    ls: torch.Tensor     # final binary level set (H, W), values {0.0, 1.0}
    mask: torch.Tensor   # ls >= 0.5 (bool)
    iters: int           # iterations actually run
    delta: torch.Tensor  # final flip fraction (NaN where not tracked)


class GACTrace(NamedTuple):
    ls: torch.Tensor
    mask: torch.Tensor
    delta: torch.Tensor  # (iters,) flip fraction of each iteration


def _prep(g, balloon: int, threshold):
    """Loop invariants: the edge map's gradients and the balloon mask."""
    dgx, dgy, mask = gac_aux_stack(g, balloon, threshold)
    return dgx, dgy, mask


def _init_ls(like, p: CVParams, ls0):
    """The binary level set a run starts from, in ``like``'s dtype and on
    its device: ``ls0 >= 0.5`` (or a bool ``ls0`` as is), else the sign
    pattern of the named ``p.init`` (``init_phi(...) >= 0``). ``like`` is
    the edge map, or the image (H, W[, C])."""
    if ls0 is not None:
        ls0 = torch.as_tensor(ls0, device=like.device)
        return (ls0 if ls0.dtype == torch.bool else ls0 >= 0.5).to(
            like.dtype)
    phi = init_phi(like.shape[:2], p.init, like.dtype, device=like.device)
    return (phi >= 0).to(like.dtype)


def chunk_sizes(iters: int, k: int):
    """The fixed-mode chunk schedule: full k-chunks, then the remainder
    (which starts at a multiple of k, so with (k s) % 2 == 0 at the first
    chunk's parity)."""
    return [k] * (iters // k) + ([iters % k] if iters % k else [])


def gac_iteration(ls, dgx, dgy, mask, balloon: int, k: int,
                  smoothing: int):
    """One full MorphGAC iteration: balloon, attraction, smoothing; ``k``
    is the smoothing-call counter (iteration n starts at k = n s)."""
    return smooth(gac_step(ls, dgx, dgy, mask, balloon), k, smoothing)


def flip_fraction(a, b):
    """Fraction of cells where two binary level sets differ, in a's
    dtype."""
    return (a != b).to(a.dtype).mean()


def _route_kernel(shape, k, smoothing, kind, use_pallas, cuda: bool):
    """Resolve (use_kernel, k) for the morphological kernels.

    Auto (``use_pallas=None``): the kernels on a CUDA tensor (``cuda``)
    where the reference's banded kernel supports the geometry and
    (k smoothing) % 2 == 0, k defaulting to the reference's per-kind
    choice (ACWE 8, GAC 4). Explicit True needs only the geometry (a CPU
    tensor then runs the kernels' plain versions) and raises without it.
    """
    kk = (8 if kind.startswith("acwe") else 4) if k is None else int(k)
    ok = (supports_morph_banded(*shape, kk, smoothing, kind)
          and (kk * smoothing) % 2 == 0)
    if use_pallas is None:
        return ok and cuda, kk
    if use_pallas and not ok:
        raise ValueError(f"banded morph kernel unsupported for "
                         f"{tuple(shape)}, k={kk}, smoothing={smoothing}")
    return bool(use_pallas), kk


class _Tolerance:
    """The tolerance loop's state and stopping rule, shared by the
    per-iteration and chunked drivers (``loop_continue``'s patience,
    min_iter and divergence on host values; patience counts iterations,
    so a below-tol chunk credits its full size)."""

    def __init__(self, p: CVParams, like):
        self.p, self.n, self.streak = p, 0, 0
        self.delta = torch.tensor(math.inf, dtype=like.dtype,
                                  device=like.device)
        self.delta_f = math.inf

    def more(self, cap=None) -> bool:
        return loop_continue(self.n, self.delta_f, self.streak, self.p, cap)

    def record(self, delta, size: int = 1):
        """Take the step's metric: one device-to-host read."""
        self.delta, self.delta_f = delta, float(delta)
        # compared with tol rounded to delta's dtype, as the reference's
        # device loop compares (both sides are exact in a Python float)
        tol = float(torch.tensor(self.p.tol, dtype=delta.dtype))
        self.streak = self.streak + size if self.delta_f < tol else 0
        self.n += size


def run_chunks(state: _Tolerance, max_iter: int, kk: int, run_chunk):
    """The chunked tolerance schedule: full k-chunks while under
    ``max_iter`` and not stopped, then one remainder chunk, so the cap is
    exact. ``run_chunk(size)`` returns the chunk's flip metric."""
    full = (max_iter // kk) * kk
    while state.n < full and state.more():
        state.record(run_chunk(kk), kk)
    rem = max_iter - full
    if rem and state.more():
        state.record(run_chunk(rem), rem)


def segment_gac(g, p: CVParams = CVParams(),
                ls0: Optional[torch.Tensor] = None,
                smoothing: int = 1,
                balloon: int = 0,
                threshold: float = 0.5,
                use_pallas: Optional[bool] = None,
                k: Optional[int] = None) -> GACResult:
    """Segment the edge map g to convergence (flip tol) or p.max_iter.

    The metric is the minimum of the flip fraction against the previous
    state and against the state two iterations back (the alternating
    smoothing's period-2 limit cycles are convergence); a non-finite g
    aborts the loop. On the kernel route the metric is the chunk flip
    fraction (an even k reads a period-2 cycle as 0) and stopping is at
    most one chunk later than the per-iteration path."""
    ls_init = _init_ls(g, p, ls0)
    b, s = int(balloon), int(smoothing)
    use_k, kk = _route_kernel(g.shape, k, s, "gac_pre", use_pallas,
                              g.is_cuda)
    if use_k:
        return _segment_gac_chunked(g, p, ls_init, s, b, float(threshold),
                                    kk)
    dgx, dgy, mask = _prep(g, b, float(threshold))
    # NaN-poison: comparisons against NaN are False, so the flip metric
    # alone would read a non-finite edge map as converged
    poison = 0.0 * torch.sum(g)
    st, ls, ls_prev = _Tolerance(p, g), ls_init, ls_init
    while st.more():
        ls_new = gac_iteration(ls, dgx, dgy, mask, b, st.n * s, s)
        delta = torch.minimum(flip_fraction(ls_new, ls) + poison,
                              flip_fraction(ls_new, ls_prev))
        ls_prev, ls = ls, ls_new
        st.record(delta)
    return GACResult(ls, ls >= 0.5, st.n, st.delta)


def segment_gac_sharded(g, p: CVParams = CVParams(), mesh=None,
                        ls0: Optional[torch.Tensor] = None,
                        smoothing: int = 1,
                        balloon: int = 0,
                        threshold: float = 0.5) -> GACResult:
    """MorphGAC over a 2-D ('x', 'y') grid mesh: :func:`segment_gac`'s
    per-iteration scheme and stopping rule (the 2-cycle detector) run
    shard by shard, one halo exchange of the iteration's reach each
    iteration and no reduction in the loop. The level set (gathered onto
    the mesh's first device), the iteration count and delta are the
    reference's, which runs ``segment_gac`` on sharded arrays with
    ``use_pallas=False``."""
    from ..parallel.sharded_morph import gac_sharded

    return gac_sharded(g, p, mesh, ls0, smoothing, balloon, threshold)


def _segment_gac_chunked(g, p: CVParams, ls_init, s: int, b: int,
                         threshold: float, kk: int) -> GACResult:
    """Tolerance-mode MorphGAC through K11 (gac_pre), k iterations per
    chunk; the aux stack is built once."""
    poison = 0.0 * torch.sum(g)
    aux = gac_aux_stack(g, b, threshold)
    st, ls = _Tolerance(p, g), ls_init

    def run_chunk(size):
        nonlocal ls
        ls_new = morph_kernel.gac_chunk(ls, aux, k=size, smoothing=s,
                                        parity0=0, balloon=b,
                                        threshold=threshold, pre_dg=True)
        flips = flip_fraction(ls_new, ls) + poison
        ls = ls_new
        return flips

    run_chunks(st, p.max_iter, kk, run_chunk)
    return GACResult(ls, ls >= 0.5, st.n, st.delta)


def segment_gac_fixed(g, p: CVParams = CVParams(), iters: int = 100,
                      ls0: Optional[torch.Tensor] = None,
                      smoothing: int = 1,
                      balloon: int = 0,
                      threshold: float = 0.5,
                      start_iter: int = 0) -> GACTrace:
    """Fixed-iteration MorphGAC with a per-iteration flip trace
    (``start_iter`` offsets the smoothing-call counter, so chunked runs
    keep the alternation of one long run)."""
    ls = _init_ls(g, p, ls0)
    b, s = int(balloon), int(smoothing)
    dgx, dgy, mask = _prep(g, b, float(threshold))
    ds = []
    for n in range(start_iter, start_iter + iters):
        ls_new = gac_iteration(ls, dgx, dgy, mask, b, n * s, s)
        ds.append(flip_fraction(ls_new, ls))
        ls = ls_new
    delta = (torch.stack(ds) if ds
             else torch.empty(0, dtype=g.dtype, device=g.device))
    return GACTrace(ls, ls >= 0.5, delta)


def segment_gac_iterations(g, p: CVParams = CVParams(), iters: int = 100,
                           ls0: Optional[torch.Tensor] = None,
                           smoothing: int = 1,
                           balloon: int = 0,
                           threshold: float = 0.5,
                           start_iter: int = 0,
                           use_pallas: Optional[bool] = None,
                           k: Optional[int] = None,
                           pre_dg: bool = True) -> GACResult:
    """Lean fixed-iteration MorphGAC (no trace, no host read). On the
    kernel route: full k-chunks of K11, then one remainder chunk, with
    ``pre_dg`` (default) streaming the run-invariant (dgx, dgy, mask)
    stack built once (kind gac_pre), else the edge map (kind gac)."""
    ls = _init_ls(g, p, ls0)
    b, s = int(balloon), int(smoothing)
    use_k, kk = _route_kernel(g.shape, k, s, "gac_pre" if pre_dg else "gac",
                              use_pallas, g.is_cuda)
    if use_k:
        kw = dict(smoothing=s, parity0=(int(start_iter) * s) % 2,
                  balloon=b, threshold=float(threshold), pre_dg=pre_dg)
        aux = gac_aux_stack(g, b, float(threshold)) if pre_dg else g
        for size in chunk_sizes(int(iters), kk):
            ls = morph_kernel.gac_chunk(ls, aux, k=size, **kw)
    else:
        dgx, dgy, mask = _prep(g, b, float(threshold))
        for n in range(start_iter, start_iter + iters):
            ls = gac_iteration(ls, dgx, dgy, mask, b, n * s, s)
    nan = torch.tensor(math.nan, dtype=g.dtype, device=g.device)
    return GACResult(ls, ls >= 0.5, int(iters), nan)
