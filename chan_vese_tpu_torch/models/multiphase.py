"""Multiphase Vese-Chan segmentation: M coupled level sets, 2^M phases.

Counterpart of ``chan_vese_tpu/models/multiphase.py``. Energy

    F = sum_s int (u0 - c_s)^2 w_s + mu sum_m Length(phi_m)
    w_s = prod_m [ H(phi_m) if bit m of s else 1 - H(phi_m) ]

Each outer iteration computes the 2^M phase means once, then sweeps the
level sets in order, each data term built from the current state (phi_1's
sweep sees phi_0's new Heaviside). (H, W, C) images take per-channel means
and channel-averaged squared distances. The plain functions work for any
M.

Routes (:func:`_mp2_route`, the reference's): for M = 2 on a grayscale
image with red-black sweeps, the whole coupled iteration runs in one
kernel, resident (K9 flat or K10 parity planes, one launch per chunk of
iterations) where the image fits the reference's resident envelope and
banded (K9, one launch per iteration) elsewhere; explicit
``use_pallas=True`` on other configurations runs each level set's sweep
through K1's force mode (``fused_sweep``), the coupling terms in plain
PyTorch. ``use_pallas=None`` takes the kernels on a CUDA tensor and the
plain path on a CPU one (the reference: kernels on a TPU backend only).
CUDA tensors launch the kernels; CPU tensors run their plain versions.
With ``p.reinit_every > 0`` every level set is redistanced on the cadence
(one R1 chain for the stack on the card) after an iteration's energy and
flips; the resident route is refused (it runs between launches) and K9's
banded route takes its next means from the redistanced level sets after a
redistance, from the kernel's partials otherwise.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import fused_kernel, multiphase_kernel, packed_kernel
from ..ops.numerics import dirac, grad_forward, heaviside
from ..ops.reductions import loop_continue, phase_means, phase_weights
from ..ops.reinit import maybe_reinit, reinit_fires
from ..ops.sweep import semi_implicit_step
from ..params import CVParams
from ..utils.init_phi import checkerboard, circle

_TINY = 1e-30


def _sqdist(u0, c):
    """(u0 - c)^2, channel-averaged for vector-valued images."""
    if u0.ndim == 3:
        return torch.mean((u0 - c) ** 2, dim=-1)
    return (u0 - c) ** 2


def _coupling_term(u0, phis, cs, m: int, p: CVParams):
    """Data-fitting force on phi_m given all current level sets (a stacked
    (M, H, W) tensor or a length-M sequence of (H, W))."""
    m_sets = len(phis)
    f = torch.zeros(u0.shape[:2], dtype=phis[0].dtype, device=u0.device)
    hs = [heaviside(phis[k], p.eps) for k in range(m_sets)]
    for s in range(2 ** m_sets):
        d = _sqdist(u0, cs[s])
        w_other = None
        for k in range(m_sets):
            if k == m:
                continue
            factor = hs[k] if (s >> k) & 1 else (1.0 - hs[k])
            w_other = factor if w_other is None else w_other * factor
        if w_other is None:  # M == 1
            w_other = torch.ones_like(f)
        sign = -1.0 if (s >> m) & 1 else 1.0
        f = f + sign * d * w_other
    return f - p.nu


def multiphase_step(phis, u0, p: CVParams, use_pallas: bool = False):
    """One outer iteration: the 2^M means, then M sequential sweeps.
    ``use_pallas`` routes each sweep through K1's force mode
    (:func:`..ops.fused_kernel.fused_sweep`). Returns (phis_new, cs)."""
    cs = phase_means(u0, phis, p.eps)
    new = [phis[m] for m in range(len(phis))]
    for m in range(len(phis)):
        f = _coupling_term(u0, new, cs, m, p)
        if use_pallas:
            new[m], _ = fused_kernel.fused_sweep(new[m], f, p)
        else:
            new[m] = semi_implicit_step(new[m], f, p)
    return torch.stack(new), cs


def _mp2_route(u0, p: CVParams, m_sets: int, use_pallas,
               allow_resident: bool = True):
    """The kernel route: 'resident' (K9 resident / K10), 'banded' (K9
    banded), 'sweeps' (K1's force mode per level set, the only kernel
    route for M != 2 or vector images) or None (plain). ``use_pallas=None``
    takes the fused kernels on a CUDA tensor and the plain path elsewhere;
    explicit True picks the best supported kernel route or raises."""
    mp = multiphase_kernel
    mp2_ok = m_sets == 2 and u0.ndim == 2 and p.order == "redblack"
    resident_ok = (allow_resident and not p.reinit_every
                   and mp.supports_mp2_resident(*u0.shape[:2]))
    if use_pallas is None:
        if u0.device.type == "cuda" and mp2_ok:
            if resident_ok:
                return "resident"
            if mp.supports_mp2(*u0.shape):
                return "banded"
        return None
    if not use_pallas:
        return None
    if mp2_ok:
        if resident_ok:
            return "resident"
        if mp.supports_mp2(*u0.shape):
            return "banded"
    if p.order == "redblack" and fused_kernel.supports(*u0.shape[:2]):
        return "sweeps"
    raise ValueError(f"multiphase kernel path unsupported for "
                     f"{tuple(u0.shape)} with order={p.order!r}")


def multiphase_energy(u0, phis, p: CVParams):
    """F = sum_s fit_s + mu sum_m Length(phi_m) + nu sum_m Area(phi_m)."""
    cs = phase_means(u0, phis, p.eps)
    ws = phase_weights(phis, p.eps)
    fit = torch.zeros((), dtype=phis.dtype, device=phis.device)
    for w, c in zip(ws, cs):
        fit = fit + torch.sum(_sqdist(u0, c) * w)
    reg = torch.zeros((), dtype=phis.dtype, device=phis.device)
    for m in range(phis.shape[0]):
        gx, gy = grad_forward(phis[m])
        reg = reg + p.mu * torch.sum(dirac(phis[m], p.eps)
                                     * torch.sqrt(gx * gx + gy * gy))
        reg = reg + p.nu * torch.sum(heaviside(phis[m], p.eps))
    return fit + reg


def labels_from_phis(phis):
    """Phase label map: bit m set where phi_m >= 0 (int32)."""
    lab = torch.zeros(phis.shape[1:], dtype=torch.int32, device=phis.device)
    for m in range(phis.shape[0]):
        lab = lab | ((phis[m] >= 0).to(torch.int32) << m)
    return lab


@functools.lru_cache(maxsize=None)
def _libm_sinf():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.sinf.argtypes = [ctypes.c_float]
    lib.sinf.restype = ctypes.c_float
    return lib.sinf


def _checkerboard_factor(n: int, dtype):
    """sin(pi i / 5) for i < n, as the reference evaluates it on the CPU:
    the argument rounded to ``dtype``, then the C library's sinf in float32
    (XLA's CPU sine) or numpy's sin in float64."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    x = np.arange(n).astype(npdt) * npdt(math.pi / 5.0)
    if npdt is np.float32:
        sinf = _libm_sinf()
        return np.array([sinf(float(v)) for v in x], np.float32)
    return np.sin(x)


def _reference_circles(shape, m_sets: int, dtype):
    """The reference's staggered circles on the host in numpy, bitwise
    equal to its CPU start (torch's CPU sqrt is not correctly rounded)."""
    h, w = shape
    npdt = np.float32 if dtype == torch.float32 else np.float64
    i = np.arange(h).astype(npdt)[:, None]
    j = np.arange(w).astype(npdt)[None, :]
    phis = []
    for m in range(m_sets):
        cy = h * (0.35 + 0.3 * (m % 2))
        cx = w * (0.35 + 0.3 * ((m // 2) % 2))
        phis.append(min(h, w) / 3.5 - np.sqrt((i - cy) ** 2 + (j - cx) ** 2))
    return torch.from_numpy(np.stack(phis).astype(npdt))


def init_multiphase(shape, m_sets: int = 2, kind: str = "checkerboard",
                    dtype=torch.float32, device=None):
    """Default multiphase start: phase-shifted checkerboards (level set m
    rolled by (5 m) // 2 + 1 columns, so all 2^M phase combinations are
    seeded), or 'circles' (staggered circles of radius min(H, W) / 3.5).

    In float32 and float64 the values are the reference's bit for bit: the
    checkerboard is separable, so its H + W sines are taken on the host as
    the reference's CPU build takes them (:func:`_checkerboard_factor`)
    and multiplied on ``device``; the circles are built on the host. Other
    dtypes use the port's ``checkerboard`` and ``circle``."""
    if kind not in ("checkerboard", "circles"):
        raise ValueError(f"unknown multiphase init {kind!r}")
    exact = dtype in (torch.float32, torch.float64)
    h, w = shape
    if kind == "checkerboard":
        if exact:
            fi, fj = (torch.from_numpy(_checkerboard_factor(n, dtype))
                      .to(device) for n in shape)
            base = fi[:, None] * fj[None, :]
        else:
            base = checkerboard(shape, dtype, device=device)
        return torch.stack([torch.roll(base, (5 * m) // 2 + 1, dims=1)
                            if m else base for m in range(m_sets)])
    if exact:
        return _reference_circles(shape, m_sets, dtype).to(device)
    return torch.stack([
        circle(shape, dtype, center=(h * (0.35 + 0.3 * (m % 2)),
                                     w * (0.35 + 0.3 * ((m // 2) % 2))),
               radius=min(h, w) / 3.5, device=device)
        for m in range(m_sets)])


class MultiphaseResult(NamedTuple):
    phis: torch.Tensor     # (M, H, W)
    labels: torch.Tensor   # (H, W) int32 phase labels
    iters: int
    delta: torch.Tensor
    cs: torch.Tensor       # (2^M,) or (2^M, C) phase means


class MultiphaseTrace(NamedTuple):
    phis: torch.Tensor
    labels: torch.Tensor
    energy: torch.Tensor   # (iters,) energy after each iteration
    delta: torch.Tensor    # (iters,) label-flip fraction of each iteration


def _inf(u0):
    return torch.tensor(math.inf, dtype=u0.dtype, device=u0.device)


def _mp2_banded_loop(u0, p: CVParams, phis0, fixed: bool, cap: int):
    """Host loop over K9's banded mode, one launch per iteration. The means
    come from each iteration's partials (the partials of the new level sets
    are the means the next iteration starts from). Returns (phis, iters,
    delta)."""
    n_pix = float(u0.numel())
    cs = torch.stack(phase_means(u0, phis0, p.eps))
    phis, n, streak = phis0, 0, 0
    delta, delta_f = _inf(u0), math.inf
    while (n < cap) if fixed else loop_continue(n, delta_f, streak, p, cap):
        phis, parts = multiphase_kernel.mp2_iteration(phis, u0, cs, p)
        cs = parts[0:4] / torch.clamp(parts[4:8], min=_TINY)
        # 0 * s_dphi2 NaN-poisons the flip metric when a phi went
        # non-finite (labels of NaN fields are finite garbage)
        delta = parts[8] / n_pix + 0.0 * parts[9]
        if reinit_fires(n, p):
            # the redistance moves H_eps: the partials' means go stale
            phis = maybe_reinit(phis, n, p)
            cs = torch.stack(phase_means(u0, phis, p.eps))
        if not fixed:
            delta_f = float(delta)
            # compared in delta's dtype, as the reference's device loop does
            streak = streak + 1 if bool(delta < p.tol) else 0
        n += 1
    return phis, n, delta


def _mp2_resident_loop(u0, p: CVParams, phis0, fixed: bool, cap: int,
                       chunk: int = 32):
    """Chunks of resident launches (K10 where the packed envelope holds,
    else K9 flat). Tolerance mode reads each chunk's per-iteration rows
    back once: the streak runs over every row, a non-finite row stops the
    run, and the max_iter cap is exact (full chunks, then the remainder).
    Fixed mode is one launch; it asks for unroll 2, which, as in the
    reference, reaches only the packed kernel (the flat call drops it).
    Returns (phis, iters, delta)."""
    use_packed = packed_kernel.supports_packed_mp2_resident(*u0.shape)

    def run_kernel(phis, size, unroll=1):
        if use_packed:
            un = unroll if size % unroll == 0 else 1
            return packed_kernel.packed_mp2_resident_iterations(
                phis, u0, p, size, unroll=un)
        return multiphase_kernel.mp2_resident_iterations(phis, u0, p, size)

    n_pix = float(u0.numel())

    def delta_rows(parts):
        return parts[:, 0] / n_pix + 0.0 * parts[:, 1]

    if fixed:
        if cap < 1:
            return phis0, 0, _inf(u0)
        phis, parts = run_kernel(phis0, cap, unroll=2)
        return phis, cap, delta_rows(parts)[-1]

    phis, n, streak, diverged = phis0, 0, 0, False
    delta = _inf(u0)

    def not_stopped():
        done = streak >= p.patience and n >= p.min_iter
        return not (done or diverged)

    def run_chunk(size):
        nonlocal phis, n, delta, streak, diverged
        phis, parts = run_kernel(phis, size)
        deltas = delta_rows(parts)
        # one device-to-host read per chunk: the rows and their tol test,
        # compared in the rows' dtype as the reference's scan does
        rows = torch.stack((deltas, (deltas < p.tol).to(deltas.dtype)))
        rows = rows.cpu()
        for below in rows[1].tolist():
            streak = streak + 1 if below else 0
        diverged = not bool(torch.isfinite(rows[0]).all())
        delta = deltas[-1]
        n += size

    full = (cap // chunk) * chunk
    while n < full and not_stopped():
        run_chunk(chunk)
    rem = cap - full
    if rem and n < cap and not_stopped():
        run_chunk(rem)
    return phis, n, delta


def _default_phis(u0, m_sets: int, phis0):
    if phis0 is None:
        return init_multiphase(u0.shape[:2], m_sets, dtype=u0.dtype,
                               device=u0.device)
    return phis0


def _label_flips(new, old, u0):
    """Fraction of cells whose label changed; 0 * sum(new) NaN-poisons it
    when a level set went non-finite (labels of NaN phis are finite
    garbage), so the divergence abort fires."""
    return (torch.mean((labels_from_phis(new) != labels_from_phis(old))
                       .to(u0.dtype)) + 0.0 * torch.sum(new))


def segment_multiphase(u0, p: CVParams = CVParams(), m_sets: int = 2,
                       phis0: Optional[torch.Tensor] = None,
                       use_pallas: Optional[bool] = None,
                       fixed: bool = False,
                       max_iter: Optional[int] = None) -> MultiphaseResult:
    """Segment into 2^m_sets phases; converges on the label-flip fraction
    (every route ignores ``p.conv_norm``, as the reference). ``fixed=True``
    runs exactly ``max_iter`` (or p.max_iter) iterations."""
    route = _mp2_route(u0, p, m_sets, use_pallas)
    cap = p.max_iter if max_iter is None else max_iter
    phis0 = _default_phis(u0, m_sets, phis0)

    if route == "resident":
        phis, iters, delta = _mp2_resident_loop(u0, p, phis0, fixed, cap)
    elif route == "banded":
        phis, iters, delta = _mp2_banded_loop(u0, p, phis0, fixed, cap)
    else:
        phis, iters, streak = phis0, 0, 0
        delta, delta_f = _inf(u0), math.inf
        while (iters < cap) if fixed else loop_continue(iters, delta_f,
                                                        streak, p, cap):
            new, _ = multiphase_step(phis, u0, p, route == "sweeps")
            delta = _label_flips(new, phis, u0)
            if not fixed:
                delta_f = float(delta)
                streak = streak + 1 if bool(delta < p.tol) else 0
            phis = maybe_reinit(new, iters, p)
            iters += 1
    cs = torch.stack(phase_means(u0, phis, p.eps))
    return MultiphaseResult(phis, labels_from_phis(phis), iters, delta, cs)


def segment_multiphase_fixed(u0, p: CVParams = CVParams(), iters: int = 100,
                             m_sets: int = 2,
                             phis0: Optional[torch.Tensor] = None,
                             use_pallas: Optional[bool] = None
                             ) -> MultiphaseTrace:
    """Fixed-iteration run with the energy and label-flip fraction of every
    iteration. The energy is evaluated in plain PyTorch between iterations,
    so the resident route is excluded; K9's banded mode still applies."""
    route = _mp2_route(u0, p, m_sets, use_pallas, allow_resident=False)
    phis = _default_phis(u0, m_sets, phis0)
    es, ds = [], []
    if route == "banded":
        n_pix = float(u0.numel())
        cs = torch.stack(phase_means(u0, phis, p.eps))
        for n in range(iters):
            phis, parts = multiphase_kernel.mp2_iteration(phis, u0, cs, p)
            cs = parts[0:4] / torch.clamp(parts[4:8], min=_TINY)
            ds.append(parts[8] / n_pix)
            es.append(multiphase_energy(u0, phis, p))
            if reinit_fires(n, p):
                phis = maybe_reinit(phis, n, p)
                cs = torch.stack(phase_means(u0, phis, p.eps))
    else:
        for n in range(iters):
            new, _ = multiphase_step(phis, u0, p, route == "sweeps")
            ds.append(torch.mean((labels_from_phis(new)
                                  != labels_from_phis(phis)).to(u0.dtype)))
            es.append(multiphase_energy(u0, new, p))
            phis = maybe_reinit(new, n, p)
    stack = (lambda xs: torch.stack(xs) if xs
             else torch.empty(0, dtype=u0.dtype, device=u0.device))
    return MultiphaseTrace(phis, labels_from_phis(phis), stack(es),
                           stack(ds))
