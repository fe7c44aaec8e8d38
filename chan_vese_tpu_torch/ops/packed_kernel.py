"""K3 and K6: the banded chunk on parity planes (2, 2, H/2, W/2), for a
scalar image (K3) or a C-channel one (K6, u0 as (C, 2, 2, H/2, W/2)).

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
"""

from __future__ import annotations

from ..params import CVParams
from . import _cuda
from .banded_kernel import banded_chunk_mc_reference, banded_chunk_reference
from .fused_kernel import _VMEM_LIMIT

# routing constant of chan_vese_tpu/ops/pallas_packed.py
_TILES_BANDED = 34


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
