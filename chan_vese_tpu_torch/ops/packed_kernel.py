"""K3: the banded chunk on parity planes (2, 2, H/2, W/2).

Counterpart of ``chan_vese_tpu/ops/pallas_packed.py`` (whole-image entry
``packed_banded_chunk``). Plane (a, b) holds P[a][b][r, c] = phi[2r+a,
2c+b]. On a CUDA tensor :func:`packed_banded_chunk` launches
``csrc/packed.cu``; on a CPU tensor it runs
:func:`packed_banded_chunk_reference`.

``_pack``/``_unpack`` are a plain reshape + permute: the reference's MXU
permutation-matmul pack was a TPU workaround and is not carried over.
``band_rows_packed`` and ``supports_packed_banded`` are the reference's
routing predicates; their VMEM and alignment terms are the reference's
routing, not limits of the Hopper kernel.
"""

from __future__ import annotations

from ..params import CVParams
from . import _cuda
from .banded_kernel import banded_chunk_reference
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
