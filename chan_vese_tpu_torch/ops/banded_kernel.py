"""K2 and K5: k red-black iterations per pass over device memory, means
frozen, on a scalar image (K2) or a C-channel one (K5).

Counterpart of ``chan_vese_tpu/ops/pallas_banded.py`` (whole-image modes
of ``_banded_kernel`` / ``_banded_kernel_fusej`` and ``_banded_mc_kernel``
/ ``_banded_mc_kernel_fusej``). On a CUDA tensor :func:`banded_chunk`
launches ``csrc/banded.cu`` and :func:`banded_chunk_mc`
``csrc/banded_mc.cu``; on a CPU tensor they run
:func:`banded_chunk_reference` and :func:`banded_chunk_mc_reference`.

Trajectory class: c1/c2 stay frozen across the k iterations of a chunk;
the partials describe the LAST iteration's transition. k = 1 is the fused
kernel's schedule exactly.

``_halos``, ``band_rows_banded(_mc)`` and ``supports_banded(_mc)`` are the
reference's routing predicates (pure integer functions of the shape). The
VMEM and alignment terms inside them are the reference's routing, not
limits of the Hopper kernel, which takes any even H and W.
"""

from __future__ import annotations

from typing import Tuple

from ..params import CVParams
from . import _cuda
from .fused_kernel import _VMEM_LIMIT, chunk_reference
from .fused_kernel_mc import chunk_reference_mc

# routing constant of chan_vese_tpu/ops/pallas_banded.py
_TILES = 34


def _halos(k: int) -> Tuple[int, int]:
    """(up, down) halo rows of the reference kernel, 8-row aligned."""
    up = -(-4 * k // 8) * 8
    dn = -(-2 * k // 8) * 8
    return up, dn


def _tile_height_cap(w: int, up: int, dn: int, extra: int = 0) -> int:
    t_cap = _VMEM_LIMIT // (w * 4 * (27 + extra))
    return max(8, (t_cap - up - dn) // 8 * 8)


def band_rows_banded(h: int, w: int, k: int) -> int:
    """The reference's band height for k in-tile iterations."""
    up, dn = _halos(k)
    per_row = w * 4 * _TILES
    b = max(8, (_VMEM_LIMIT // per_row) // 8 * 8)
    b = min(b, _tile_height_cap(w, up, dn))
    return min(b, max(8, ((h - up - dn) // 8) * 8))


def supports_banded(h: int, w: int, k: int) -> bool:
    """Whether the reference routes (h, w, k) to its banded kernel."""
    up, dn = _halos(k)
    return (w % 128 == 0 and h % 8 == 0 and 1 <= k <= 64
            and band_rows_banded(h, w, k) + up + dn <= h)


def banded_chunk_reference(phi, u0, c1, c2, p: CVParams, k: int = 8):
    """Plain PyTorch version of :func:`banded_chunk`."""
    return chunk_reference(phi, u0, c1, c2, p, k)


def banded_chunk(phi, u0, c1, c2, p: CVParams, k: int = 8,
                 unroll: int = 1, fuse: bool = False):
    """Run k red-black iterations with frozen means.

    Returns (phi_new, partials (8,)). ``unroll`` and ``fuse`` are accepted
    for signature parity with the reference; they changed only the TPU
    grid, never the values, and the Hopper kernel ignores them.
    """
    if unroll < 1 or k % unroll:
        raise ValueError(f"unroll must divide k (got k={k}, unroll={unroll})")
    if phi.device.type == "cpu":
        return banded_chunk_reference(phi, u0, c1, c2, p, k)
    h, w = phi.shape
    out = _cuda.launch_chunk("cv_banded_chunk", phi, u0, c1, c2, p, k, h, w)
    banded_chunk.launches += 1
    return out


banded_chunk.launches = 0


def band_rows_banded_mc(h: int, w: int, k: int, c: int) -> int:
    """The reference's band height for the C-channel kernel."""
    up, dn = _halos(k)
    per_row = w * 4 * (_TILES + 2 * c)
    b = max(8, (_VMEM_LIMIT // per_row) // 8 * 8)
    b = min(b, _tile_height_cap(w, up, dn, extra=2 * (c - 1)))
    return min(b, max(8, ((h - up - dn) // 8) * 8))


def supports_banded_mc(h: int, w: int, k: int, c: int) -> bool:
    """Whether the reference routes (h, w, k, c) to its banded mc kernel."""
    up, dn = _halos(k)
    return (w % 128 == 0 and h % 8 == 0 and 1 <= k <= 64 and 1 <= c <= 8
            and band_rows_banded_mc(h, w, k, c) + up + dn <= h)


def banded_chunk_mc_reference(phi, u0_cfirst, c1, c2, p: CVParams,
                              k: int = 8, lambda1=None, lambda2=None):
    """Plain PyTorch version of :func:`banded_chunk_mc`."""
    return chunk_reference_mc(phi, u0_cfirst, c1, c2, p, k, lambda1,
                              lambda2, 16)


def banded_chunk_mc(phi, u0_cfirst, c1, c2, p: CVParams, k: int = 8,
                    unroll: int = 1, lambda1=None, lambda2=None,
                    fuse: bool = False):
    """k frozen-means iterations on a (C, H, W) image; c1, c2: (C,) means.

    Returns (phi_new, partials (16,)): [s_uH per channel..., s_H,
    s_dphi2, flips, s_absdphi, 0...] of the last iteration's transition.
    ``unroll``/``fuse``: as :func:`banded_chunk`.
    """
    if unroll < 1 or k % unroll:
        raise ValueError(f"unroll must divide k (got k={k}, unroll={unroll})")
    C = _cuda.mc_channels(phi, u0_cfirst)
    if phi.device.type == "cpu":
        return banded_chunk_mc_reference(phi, u0_cfirst, c1, c2, p, k,
                                         lambda1, lambda2)
    h, w = phi.shape
    l1, l2 = p.channel_lambdas(C, lambda1, lambda2)
    out = _cuda.launch_chunk_mc("cv_banded_chunk_mc", phi, u0_cfirst, c1, c2,
                                p, k, h, w, l1, l2, 16)
    banded_chunk_mc.launches += 1
    return out


banded_chunk_mc.launches = 0
