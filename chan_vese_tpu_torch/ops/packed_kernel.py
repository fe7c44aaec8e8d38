"""K3 and K6: the banded chunk on parity planes (2, 2, H/2, W/2), for a
scalar image (K3) or a C-channel one (K6, u0 as (C, 2, 2, H/2, W/2)); K8:
the exact-means resident iterations of K7 on parity planes.

Counterpart of ``chan_vese_tpu/ops/pallas_packed.py`` (whole-image entries
``packed_banded_chunk`` and ``packed_banded_chunk_mc``). Plane (a, b)
holds P[a][b][r, c] = phi[2r+a, 2c+b]. On a CUDA tensor
:func:`packed_banded_chunk` launches ``csrc/packed.cu`` and
:func:`packed_banded_chunk_mc` ``csrc/packed_mc.cu``; on a CPU tensor they
run their ``_reference`` plain versions.

``_pack``/``_pack_n``/``_unpack``/``_unpack_n`` are a plain reshape +
permute: the reference's MXU permutation-matmul pack was a TPU workaround
and is not carried over. ``band_rows_packed(_mc)`` and
``supports_packed_banded(_mc)`` are the reference's routing predicates;
their VMEM and alignment terms are the reference's routing, not limits of
the Hopper kernel.

K8 (``packed_resident_iterations``, ``_batch``, ``_mc``) keeps the
reference's contract: (H, W) / (N, H, W) in and out, packed inside. On a
CUDA tensor it launches ``csrc/packed_resident.cu`` or
``csrc/packed_resident_mc.cu``; on a CPU tensor it runs the K7 plain
versions, whose values the plane layout does not change.

K10 (``packed_mp2_resident_iterations``) is K9's resident 4-phase mode on
parity planes, with K9's contract ((2, H, W) in and out, rows
(iters // unroll, 8)); on a CUDA tensor it launches
``csrc/packed_mp2_resident.cu``, on a CPU tensor K9's plain version.
"""

from __future__ import annotations

from ..params import CVParams
from . import _cuda
from .banded_kernel import banded_chunk_mc_reference, banded_chunk_reference
from .fused_kernel import _VMEM_LIMIT
from .multiphase_kernel import check_mp2, mp2_resident_iterations_reference
from .resident_kernel import (check_iters, check_stack,
                              resident_iterations_batch_reference,
                              resident_iterations_mc_reference,
                              resident_iterations_reference)

# routing constants of chan_vese_tpu/ops/pallas_packed.py
_TILES_BANDED = 34
_ARRAYS_RESIDENT = 20
_ARRAYS_MP2_RESIDENT = 26


def _pack(x):
    """(H, W) -> (2, 2, H/2, W/2) parity planes, contiguous."""
    h, w = x.shape
    return x.reshape(h // 2, 2, w // 2, 2).permute(1, 3, 0, 2).contiguous()


def _unpack(planes):
    """(2, 2, H/2, W/2) -> (H, W). Inverse of :func:`_pack`."""
    _, _, hp, wp = planes.shape
    return planes.permute(2, 0, 3, 1).reshape(2 * hp, 2 * wp)


def _pack_n(xn):
    """(N, H, W) -> (N, 2, 2, H/2, W/2): :func:`_pack` over a leading axis."""
    n, h, w = xn.shape
    return (xn.reshape(n, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3)
            .contiguous())


def _pack_mc(ucf):
    """(C, H, W) channels-first -> (C, 2, 2, H/2, W/2)."""
    return _pack_n(ucf)


def _unpack_n(planes_n):
    """(N, 2, 2, H/2, W/2) -> (N, H, W). Inverse of :func:`_pack_n`."""
    n, _, _, hp, wp = planes_n.shape
    return planes_n.permute(0, 3, 1, 4, 2).reshape(n, 2 * hp, 2 * wp)


def band_rows_packed(h: int, w: int, k: int):
    """The reference's (bp, upp, dnp) packed-row band geometry."""
    upp = -(-2 * k // 8) * 8
    dnp = -(-k // 8) * 8
    per_real_row = w * 4 * _TILES_BANDED
    b_real = max(16, (_VMEM_LIMIT // per_real_row) // 16 * 16)
    bp = b_real // 2
    hp = h // 2
    bp = min(bp, max(8, ((hp - upp - dnp) // 8) * 8))
    return bp, upp, dnp


def supports_packed_banded(h: int, w: int, k: int) -> bool:
    """Whether the reference can route (h, w, k) to its packed kernel."""
    if h % 16 or w % 256 or not (1 <= k <= 64):
        return False
    bp, upp, dnp = band_rows_packed(h, w, k)
    return bp + upp + dnp <= h // 2


def packed_banded_chunk_reference(phi_planes, u0_planes, c1, c2,
                                  p: CVParams, k: int = 8):
    """Plain PyTorch version of :func:`packed_banded_chunk`."""
    phi, parts = banded_chunk_reference(_unpack(phi_planes),
                                        _unpack(u0_planes), c1, c2, p, k)
    return _pack(phi), parts


def packed_banded_chunk(phi_planes, u0_planes, c1, c2, p: CVParams,
                        k: int = 8, unroll: int = 1, fuse: bool = False):
    """k frozen-means iterations on pre-packed planes; returns
    (phi_planes_new, partials (8,)). ``unroll``/``fuse``: as
    :func:`..banded_kernel.banded_chunk`."""
    if unroll < 1 or k % unroll:
        raise ValueError(f"unroll must divide k (got k={k}, unroll={unroll})")
    if phi_planes.ndim != 4 or tuple(phi_planes.shape[:2]) != (2, 2):
        raise ValueError(f"expected (2, 2, H/2, W/2) planes, got "
                         f"{tuple(phi_planes.shape)}")
    if phi_planes.device.type == "cpu":
        return packed_banded_chunk_reference(phi_planes, u0_planes, c1, c2,
                                             p, k)
    _, _, hp, wp = phi_planes.shape
    out = _cuda.launch_chunk("cv_packed_banded_chunk", phi_planes,
                             u0_planes, c1, c2, p, k, 2 * hp, 2 * wp)
    packed_banded_chunk.launches += 1
    return out


packed_banded_chunk.launches = 0


def band_rows_packed_mc(h: int, w: int, k: int, c: int):
    """The reference's (bp, upp, dnp) band geometry of the mc kernel."""
    upp = -(-2 * k // 8) * 8
    dnp = -(-k // 8) * 8
    per_real_row = w * 4 * (_TILES_BANDED + 2 * c)
    b_real = max(16, (_VMEM_LIMIT // per_real_row) // 16 * 16)
    bp = b_real // 2
    hp = h // 2
    bp = min(bp, max(8, ((hp - upp - dnp) // 8) * 8))
    return bp, upp, dnp


def supports_packed_banded_mc(h: int, w: int, k: int, c: int) -> bool:
    """Whether the reference can route (h, w, k, c) to its packed mc
    kernel."""
    if h % 16 or w % 256 or not (1 <= k <= 64) or not (1 <= c <= 8):
        return False
    bp, upp, dnp = band_rows_packed_mc(h, w, k, c)
    return bp + upp + dnp <= h // 2


def packed_banded_chunk_mc_reference(phi_planes, u0_planes, c1, c2,
                                     p: CVParams, k: int = 8, lambda1=None,
                                     lambda2=None):
    """Plain PyTorch version of :func:`packed_banded_chunk_mc`."""
    phi, parts = banded_chunk_mc_reference(
        _unpack(phi_planes), _unpack_n(u0_planes), c1, c2, p, k, lambda1,
        lambda2)
    return _pack(phi), parts


def packed_banded_chunk_mc(phi_planes, u0_planes, c1, c2, p: CVParams,
                           k: int = 8, unroll: int = 1, fuse: bool = False,
                           lambda1=None, lambda2=None):
    """k frozen-means iterations on pre-packed planes: phi (2, 2, H/2, W/2),
    u0 (C, 2, 2, H/2, W/2); c1, c2: (C,) means. Returns (phi_planes_new,
    partials (16,)) in :func:`..banded_kernel.banded_chunk_mc`'s layout.
    ``unroll``/``fuse``: as :func:`..banded_kernel.banded_chunk`."""
    if unroll < 1 or k % unroll:
        raise ValueError(f"unroll must divide k (got k={k}, unroll={unroll})")
    if phi_planes.ndim != 4 or tuple(phi_planes.shape[:2]) != (2, 2):
        raise ValueError(f"expected (2, 2, H/2, W/2) planes, got "
                         f"{tuple(phi_planes.shape)}")
    C = _cuda.mc_channels(phi_planes, u0_planes)
    if phi_planes.device.type == "cpu":
        return packed_banded_chunk_mc_reference(phi_planes, u0_planes, c1,
                                                c2, p, k, lambda1, lambda2)
    _, _, hp, wp = phi_planes.shape
    l1, l2 = p.channel_lambdas(C, lambda1, lambda2)
    out = _cuda.launch_chunk_mc("cv_packed_banded_chunk_mc", phi_planes,
                                u0_planes, c1, c2, p, k, 2 * hp, 2 * wp, l1,
                                l2, 16)
    packed_banded_chunk_mc.launches += 1
    return out


packed_banded_chunk_mc.launches = 0


def supports_packed_resident(h: int, w: int) -> bool:
    """Whether the reference routes (h, w) to its packed resident kernel."""
    return (h % 16 == 0 and w % 256 == 0
            and h * w * 4 * _ARRAYS_RESIDENT <= _VMEM_LIMIT)


def supports_packed_resident_mc(h: int, w: int, c: int) -> bool:
    """Whether the reference routes (h, w, c) to its packed resident mc
    kernel."""
    return (h % 16 == 0 and w % 256 == 0 and 1 <= c <= 8
            and h * w * 4 * (_ARRAYS_RESIDENT + 2 * c) <= _VMEM_LIMIT)


def packed_resident_iterations_reference(phi, u0, p: CVParams, iters: int,
                                         unroll: int = 1):
    """Plain PyTorch version of :func:`packed_resident_iterations`: K7's,
    since packing moves values without changing them."""
    return resident_iterations_reference(phi, u0, p, iters, unroll)


def packed_resident_iterations(phi, u0, p: CVParams, iters: int,
                               unroll: int = 1):
    """K7's :func:`..resident_kernel.resident_iterations` contract ((H, W)
    in and out, partials (iters // unroll, 8)) on parity planes."""
    check_iters(iters, unroll)
    if phi.ndim != 2 or u0.shape != phi.shape:
        raise ValueError(f"phi {tuple(phi.shape)} and u0 "
                         f"{tuple(u0.shape)} must be one (H, W) shape")
    if phi.device.type == "cpu":
        return packed_resident_iterations_reference(phi, u0, p, iters,
                                                    unroll)
    h, w = phi.shape
    _cuda.check_even(h, w)
    out, parts = _cuda.launch_resident(
        "cv_packed_resident_iterations", _pack(phi), _pack(u0), p, iters,
        unroll, h, w)
    packed_resident_iterations.launches += 1
    return _unpack(out), parts


packed_resident_iterations.launches = 0


def packed_resident_iterations_batch_reference(phis, u0s, p: CVParams,
                                               iters: int, unroll: int = 1):
    """Plain PyTorch version of :func:`packed_resident_iterations_batch`."""
    return resident_iterations_batch_reference(phis, u0s, p, iters, unroll)


def packed_resident_iterations_batch(phis, u0s, p: CVParams, iters: int,
                                     unroll: int = 1):
    """K7's batch contract ((N, H, W) in and out, partials (N, 8), each
    frame's last iteration) on parity planes, all frames in one launch."""
    check_iters(iters, unroll)
    check_stack(phis, u0s)
    if phis.device.type == "cpu":
        return packed_resident_iterations_batch_reference(phis, u0s, p,
                                                          iters, unroll)
    n, h, w = phis.shape
    _cuda.check_even(h, w)
    out, parts = _cuda.launch_resident(
        "cv_packed_resident_iterations", _pack_n(phis), _pack_n(u0s), p,
        iters, unroll, h, w, frames=n, batch=True)
    packed_resident_iterations_batch.launches += 1
    return _unpack_n(out), parts


packed_resident_iterations_batch.launches = 0


def packed_resident_iterations_mc_reference(phi, u0_cfirst, p: CVParams,
                                            iters: int, lambda1=None,
                                            lambda2=None, unroll: int = 1):
    """Plain PyTorch version of :func:`packed_resident_iterations_mc`."""
    return resident_iterations_mc_reference(phi, u0_cfirst, p, iters,
                                            lambda1, lambda2, unroll)


def packed_resident_iterations_mc(phi, u0_cfirst, p: CVParams, iters: int,
                                  lambda1=None, lambda2=None,
                                  unroll: int = 1):
    """K7's mc contract ((H, W) phi, (C, H, W) image, partials
    (iters // unroll, C + 4)) on parity planes."""
    check_iters(iters, unroll)
    C = _cuda.mc_channels(phi, u0_cfirst)
    if phi.device.type == "cpu":
        return packed_resident_iterations_mc_reference(
            phi, u0_cfirst, p, iters, lambda1, lambda2, unroll)
    h, w = phi.shape
    _cuda.check_even(h, w)
    l1, l2 = p.channel_lambdas(C, lambda1, lambda2)
    out, parts = _cuda.launch_resident(
        "cv_packed_resident_iterations_mc", _pack(phi), _pack_mc(u0_cfirst),
        p, iters, unroll, h, w, l1=l1, l2=l2)
    packed_resident_iterations_mc.launches += 1
    return _unpack(out), parts


packed_resident_iterations_mc.launches = 0


def supports_packed_mp2_resident(h: int, w: int) -> bool:
    """Whether the reference routes (h, w) to its packed 4-phase resident
    kernel."""
    return (h % 16 == 0 and w % 256 == 0
            and h * w * 4 * _ARRAYS_MP2_RESIDENT <= _VMEM_LIMIT)


def packed_mp2_resident_iterations_reference(phis, u0, p: CVParams,
                                             iters: int, unroll: int = 1):
    """Plain PyTorch version of :func:`packed_mp2_resident_iterations`:
    K9's, since packing moves values without changing them."""
    return mp2_resident_iterations_reference(phis, u0, p, iters, unroll)


def packed_mp2_resident_iterations(phis, u0, p: CVParams, iters: int,
                                   unroll: int = 1):
    """K9's :func:`..multiphase_kernel.mp2_resident_iterations` contract
    ((2, H, W) in and out, partials (iters // unroll, 8)) on parity planes,
    packed inside."""
    check_mp2(phis, u0, supports_packed_mp2_resident, "packed mp2 resident")
    if iters < 1 or unroll < 1 or iters % unroll:
        raise ValueError(f"unroll must divide iters (iters={iters}, "
                         f"unroll={unroll})")
    if phis.device.type == "cpu":
        return packed_mp2_resident_iterations_reference(phis, u0, p, iters,
                                                        unroll)
    h, w = u0.shape
    out, parts = _cuda.launch_mp2_resident(
        "cv_packed_mp2_resident_iterations", _pack_n(phis), _pack(u0), p,
        iters, unroll, h, w)
    packed_mp2_resident_iterations.launches += 1
    return _unpack_n(out), parts


packed_mp2_resident_iterations.launches = 0
