"""K3 and K6: the banded chunk on parity planes (2, 2, H/2, W/2), for a
scalar image (K3) or a C-channel one (K6, u0 as (C, 2, 2, H/2, W/2)); K8:
the exact-means resident iterations of K7 on parity planes.

Counterpart of ``chan_vese_tpu/ops/pallas_packed.py`` (whole-image entries
``packed_banded_chunk`` and ``packed_banded_chunk_mc``; K3's shard-canvas
mode :func:`packed_banded_chunk_sharded`, which launches
``csrc/packed.cu``'s shard launcher). Plane (a, b)
holds P[a][b][r, c] = phi[2r+a, 2c+b]. On a CUDA tensor
:func:`packed_banded_chunk` launches ``csrc/packed.cu`` and
:func:`packed_banded_chunk_mc` ``csrc/packed_mc.cu``, both on the band body
of ``csrc/band.cuh`` (:func:`._cuda.launch_band`, K2's and K5's geometry
and cell order, so a launch is bitwise K2's or K5's on the unpacked
image); on a CPU tensor they run their ``_reference`` plain versions.

K15/K16 (:func:`pack_planes`, :func:`unpack_planes`) are the parity pack
and its inverse for (H, W) and (N, H, W) inputs (a frame or channel
axis); every packed route packs and unpacks through them, looked up as
module attributes at each call. On a CUDA tensor they launch
``csrc/pack.cu``; on a CPU tensor they run the plain reshape + permute
(``pack_planes_reference``, ``unpack_planes_reference``). Both are exact
permutations, so bitwise equal. The reference's MXU permutation-matmul
pack (a TPU workaround) flushes denormals to zero; these keep them.

K13 (:func:`packed_chunk`) is the reference's layout A/B: k frozen-means
iterations with the whole image resident, on parity planes
(``packed=True``) or flat, (H, W) in and out, the partials of the last
iteration; on a CUDA tensor it launches ``csrc/resident_chunk.cu``, on a
CPU tensor it runs :func:`..fused_kernel.chunk_reference`.

``band_rows_packed(_mc)`` and
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

from .. import spans
from ..params import CVParams
from . import _cuda
from .banded_kernel import (banded_chunk_mc_reference, banded_chunk_reference,
                            banded_chunk_sharded_reference)
from .fused_kernel import _VMEM_LIMIT, chunk_reference
from .multiphase_kernel import check_mp2, mp2_resident_iterations_reference
from .resident_kernel import (check_iters, check_stack,
                              resident_iterations_batch_reference,
                              resident_iterations_mc_reference,
                              resident_iterations_reference)

# routing constants of chan_vese_tpu/ops/pallas_packed.py
_TILES_BANDED = 34
_ARRAYS_RESIDENT = 20
_ARRAYS_MP2_RESIDENT = 26


def _image_shape(x):
    """(N or None, H, W) of an (H, W) or (N, H, W) input; odd sides and
    other ranks raise."""
    if x.ndim not in (2, 3):
        raise ValueError(f"expected (H, W) or (N, H, W), got "
                         f"{tuple(x.shape)}")
    n = x.shape[0] if x.ndim == 3 else None
    h, w = x.shape[-2:]
    _cuda.check_even(h, w)
    return n, h, w


def pack_planes_reference(x):
    """Plain PyTorch version of :func:`pack_planes`."""
    n, h, w = _image_shape(x)
    lead = () if n is None else (n,)
    y = x.reshape(*lead, h // 2, 2, w // 2, 2)
    order = (1, 3, 0, 2) if n is None else (0, 2, 4, 1, 3)
    return y.permute(*order).contiguous()


def pack_planes(x):
    """(H, W) -> (2, 2, H/2, W/2) parity planes, or (N, H, W) -> (N, 2, 2,
    H/2, W/2) (a frame or channel axis), contiguous; plane (a, b) holds
    x[2r + a, 2c + b]. CPU tensors run the plain version; CUDA tensors
    (float32) launch K15 or raise."""
    with spans.span("cv.launch.pack_planes"):
        n, h, w = _image_shape(x)
        if x.device.type == "cpu":
            return pack_planes_reference(x)
        out = _cuda.launch_pack("cv_pack_planes", x.reshape(n or 1, h, w),
                                (n or 1, 2, 2, h // 2, w // 2))
        pack_planes.launches += 1
        return out if n is not None else out[0]


pack_planes.launches = 0


def _planes_shape(planes):
    """(N or None, H, W) of (2, 2, H/2, W/2) or (N, 2, 2, H/2, W/2)
    planes; other shapes raise."""
    if planes.ndim not in (4, 5) or tuple(planes.shape[-4:-2]) != (2, 2):
        raise ValueError(f"expected (2, 2, H/2, W/2) or (N, 2, 2, H/2, W/2) "
                         f"planes, got {tuple(planes.shape)}")
    n = planes.shape[0] if planes.ndim == 5 else None
    return n, 2 * planes.shape[-2], 2 * planes.shape[-1]


def unpack_planes_reference(planes):
    """Plain PyTorch version of :func:`unpack_planes`."""
    n, h, w = _planes_shape(planes)
    if n is None:
        return planes.permute(2, 0, 3, 1).reshape(h, w)
    return planes.permute(0, 3, 1, 4, 2).reshape(n, h, w)


def unpack_planes(planes):
    """Inverse of :func:`pack_planes`: (2, 2, H/2, W/2) -> (H, W) or
    (N, 2, 2, H/2, W/2) -> (N, H, W). CPU tensors run the plain version;
    CUDA tensors (float32) launch K16 or raise."""
    with spans.span("cv.launch.unpack_planes"):
        n, h, w = _planes_shape(planes)
        if planes.device.type == "cpu":
            return unpack_planes_reference(planes)
        out = _cuda.launch_pack("cv_unpack_planes",
                                planes.reshape(n or 1, 2, 2, h // 2, w // 2),
                                (n or 1, h, w))
        unpack_planes.launches += 1
        return out if n is not None else out[0]


unpack_planes.launches = 0


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
    phi, parts = banded_chunk_reference(unpack_planes_reference(phi_planes),
                                        unpack_planes_reference(u0_planes),
                                        c1, c2, p, k)
    return pack_planes_reference(phi), parts


def packed_banded_chunk(phi_planes, u0_planes, c1, c2, p: CVParams,
                        k: int = 8, unroll: int = 1, fuse: bool = False):
    """k frozen-means iterations on pre-packed planes; returns
    (phi_planes_new, partials (8,)). ``unroll``/``fuse``: as
    :func:`..banded_kernel.banded_chunk`."""
    with spans.span("cv.launch.packed_banded_chunk"):
        if unroll < 1 or k % unroll:
            raise ValueError(f"unroll must divide k (got k={k}, "
                             f"unroll={unroll})")
        if phi_planes.ndim != 4 or tuple(phi_planes.shape[:2]) != (2, 2):
            raise ValueError(f"expected (2, 2, H/2, W/2) planes, got "
                             f"{tuple(phi_planes.shape)}")
        if phi_planes.device.type == "cpu":
            return packed_banded_chunk_reference(phi_planes, u0_planes, c1, c2,
                                                 p, k)
        out = _cuda.launch_band(phi_planes, u0_planes, c1, c2, p, k)
        packed_banded_chunk.launches += 1
        return out


packed_banded_chunk.launches = 0


def _check_plane_canvas(planes, u0_planes, crop):
    if planes.ndim != 4 or tuple(planes.shape[:2]) != (2, 2):
        raise ValueError(f"expected (2, 2, H/2, W/2) planes, got "
                         f"{tuple(planes.shape)}")
    if u0_planes.shape != planes.shape:
        raise ValueError(f"u0 planes {tuple(u0_planes.shape)} vs phi "
                         f"planes {tuple(planes.shape)}")
    if any(int(c) % 2 for c in crop):
        raise ValueError(f"packed sharded crop must be even, got {crop}")


def packed_banded_chunk_sharded_reference(canvas_planes, u0_canvas_planes,
                                          c1, c2, p: CVParams, k: int,
                                          edges, crop):
    """Plain PyTorch version of :func:`packed_banded_chunk_sharded`."""
    _check_plane_canvas(canvas_planes, u0_canvas_planes, crop)
    phi, parts = banded_chunk_sharded_reference(
        unpack_planes_reference(canvas_planes),
        unpack_planes_reference(u0_canvas_planes), c1, c2, p, k, 0, edges,
        crop)
    return pack_planes_reference(phi), parts


def packed_banded_chunk_sharded(canvas_planes, u0_canvas_planes, c1, c2,
                                p: CVParams, k: int, edges, crop,
                                unroll: int = 1):
    """k frozen-means iterations on a shard canvas stored as parity planes
    (2, 2, Hc/2, Wc/2): :func:`..banded_kernel.banded_chunk_sharded`'s
    contract, with the canvas origin on an even global cell (the sharded
    solver's even shards and even halo depth give it), so the lattice
    parity is 0 and takes no argument, and an even crop (checked, as in
    the reference). Returns (canvas_planes_new, partials (8,)).
    ``unroll``: as :func:`packed_banded_chunk`. CPU tensors run the plain
    version; CUDA tensors launch ``cv_packed_banded_chunk_shard``
    (``csrc/packed.cu``) or raise."""
    with spans.span("cv.launch.packed_banded_chunk_sharded"):
        if unroll < 1 or k % unroll:
            raise ValueError(f"unroll must divide k (got k={k}, "
                             f"unroll={unroll})")
        _check_plane_canvas(canvas_planes, u0_canvas_planes, crop)
        _, _, hp, wp = canvas_planes.shape
        shard = _cuda.shard_args(2 * hp, 2 * wp, k, 0, crop, edges)
        if canvas_planes.device.type == "cpu":
            return packed_banded_chunk_sharded_reference(
                canvas_planes, u0_canvas_planes, c1, c2, p, k, edges, crop)
        out = _cuda.launch_band(canvas_planes, u0_canvas_planes, c1, c2, p, k,
                                shard=shard)
        packed_banded_chunk_sharded.launches += 1
        return out


packed_banded_chunk_sharded.launches = 0


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
        unpack_planes_reference(phi_planes),
        unpack_planes_reference(u0_planes), c1, c2, p, k, lambda1, lambda2)
    return pack_planes_reference(phi), parts


def packed_banded_chunk_mc(phi_planes, u0_planes, c1, c2, p: CVParams,
                           k: int = 8, unroll: int = 1, fuse: bool = False,
                           lambda1=None, lambda2=None):
    """k frozen-means iterations on pre-packed planes: phi (2, 2, H/2, W/2),
    u0 (C, 2, 2, H/2, W/2); c1, c2: (C,) means. Returns (phi_planes_new,
    partials (16,)) in :func:`..banded_kernel.banded_chunk_mc`'s layout.
    ``unroll``/``fuse``: as :func:`..banded_kernel.banded_chunk`."""
    with spans.span("cv.launch.packed_banded_chunk_mc"):
        if unroll < 1 or k % unroll:
            raise ValueError(f"unroll must divide k (got k={k}, "
                             f"unroll={unroll})")
        if phi_planes.ndim != 4 or tuple(phi_planes.shape[:2]) != (2, 2):
            raise ValueError(f"expected (2, 2, H/2, W/2) planes, got "
                             f"{tuple(phi_planes.shape)}")
        C = _cuda.mc_channels(phi_planes, u0_planes)
        if phi_planes.device.type == "cpu":
            return packed_banded_chunk_mc_reference(phi_planes, u0_planes, c1,
                                                    c2, p, k, lambda1, lambda2)
        l1, l2 = p.channel_lambdas(C, lambda1, lambda2)
        out = _cuda.launch_band(phi_planes, u0_planes, c1, c2, p, k, l1=l1,
                                l2=l2)
        packed_banded_chunk_mc.launches += 1
        return out


packed_banded_chunk_mc.launches = 0


def supports_packed_resident(h: int, w: int) -> bool:
    """Whether the reference routes (h, w) to its packed resident kernel."""
    return (h % 16 == 0 and w % 256 == 0
            and h * w * 4 * _ARRAYS_RESIDENT <= _VMEM_LIMIT)


def supports_packed(h: int, w: int) -> bool:
    """Whether the reference's :func:`packed_chunk` takes (h, w) (the same
    envelope as its packed resident kernel)."""
    return supports_packed_resident(h, w)


def packed_chunk_reference(phi, u0, c1, c2, p: CVParams, k: int = 8):
    """Plain PyTorch version of :func:`packed_chunk` (either layout: the
    plane layout moves values without changing them)."""
    return chunk_reference(phi, u0, c1, c2, p, k)


def packed_chunk(phi, u0, c1, c2, p: CVParams, k: int = 8, unroll: int = 1,
                 packed: bool = True):
    """k frozen-means red-black iterations with the whole image resident,
    on parity planes (``packed=True``, packed and unpacked inside) or
    flat; (H, W) in and out. Returns (phi_new, partials (8,)) with the
    partials describing the LAST iteration (the ``banded_chunk``
    contract). Shapes off ``supports_packed`` raise, as do k < 1 and an
    ``unroll`` that does not divide k; ``unroll`` changes nothing else.

    CPU tensors run the plain version; CUDA tensors (float32) launch
    ``csrc/resident_chunk.cu`` (one cooperative launch) or raise.
    """
    with spans.span("cv.launch.packed_chunk"):
        if phi.ndim != 2 or u0.shape != phi.shape:
            raise ValueError(f"phi {tuple(phi.shape)} and u0 "
                             f"{tuple(u0.shape)} must be one (H, W) shape")
        h, w = phi.shape
        if not supports_packed(h, w):
            raise ValueError(f"packed resident unsupported for {(h, w)}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if unroll < 1 or k % unroll:
            raise ValueError(f"unroll must divide k (got k={k}, "
                             f"unroll={unroll})")
        if phi.device.type == "cpu":
            return packed_chunk_reference(phi, u0, c1, c2, p, k)
        if packed:
            out, parts = _cuda.launch_resident_chunk(
                "cv_packed_resident_chunk", pack_planes(phi), pack_planes(u0),
                c1, c2, p, k, h, w)
            out = unpack_planes(out)
        else:
            out, parts = _cuda.launch_resident_chunk(
                "cv_resident_chunk", phi, u0, c1, c2, p, k, h, w)
        packed_chunk.launches["packed" if packed else "flat"] += 1
        return out, parts


# one count per layout: the two layouts are two kernels
packed_chunk.launches = {"flat": 0, "packed": 0}


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
    with spans.span("cv.launch.packed_resident_iterations"):
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
            "cv_packed_resident_iterations", pack_planes(phi), pack_planes(u0),
            p, iters, unroll, h, w)
        packed_resident_iterations.launches += 1
        return unpack_planes(out), parts


packed_resident_iterations.launches = 0


def packed_resident_iterations_batch_reference(phis, u0s, p: CVParams,
                                               iters: int, unroll: int = 1):
    """Plain PyTorch version of :func:`packed_resident_iterations_batch`."""
    return resident_iterations_batch_reference(phis, u0s, p, iters, unroll)


def packed_resident_iterations_batch(phis, u0s, p: CVParams, iters: int,
                                     unroll: int = 1):
    """K7's batch contract ((N, H, W) in and out, partials (N, 8), each
    frame's last iteration) on parity planes, all frames in one launch."""
    with spans.span("cv.launch.packed_resident_iterations_batch"):
        check_iters(iters, unroll)
        check_stack(phis, u0s)
        if phis.device.type == "cpu":
            return packed_resident_iterations_batch_reference(phis, u0s, p,
                                                              iters, unroll)
        n, h, w = phis.shape
        _cuda.check_even(h, w)
        out, parts = _cuda.launch_resident(
            "cv_packed_resident_iterations", pack_planes(phis),
            pack_planes(u0s), p, iters, unroll, h, w, frames=n, batch=True)
        packed_resident_iterations_batch.launches += 1
        return unpack_planes(out), parts


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
    with spans.span("cv.launch.packed_resident_iterations_mc"):
        check_iters(iters, unroll)
        C = _cuda.mc_channels(phi, u0_cfirst)
        if phi.device.type == "cpu":
            return packed_resident_iterations_mc_reference(
                phi, u0_cfirst, p, iters, lambda1, lambda2, unroll)
        h, w = phi.shape
        _cuda.check_even(h, w)
        l1, l2 = p.channel_lambdas(C, lambda1, lambda2)
        out, parts = _cuda.launch_resident(
            "cv_packed_resident_iterations_mc", pack_planes(phi),
            pack_planes(u0_cfirst), p, iters, unroll, h, w, l1=l1, l2=l2)
        packed_resident_iterations_mc.launches += 1
        return unpack_planes(out), parts


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
                                   unroll: int = 1, planes=None):
    """K9's :func:`..multiphase_kernel.mp2_resident_iterations` contract
    ((2, H, W) in and out, partials (iters // unroll, 8)) on parity planes,
    packed inside; ``planes``, where given, are phis's parity planes
    (:func:`pack_planes`), which the caller keeps, so phis is not packed
    again."""
    with spans.span("cv.launch.packed_mp2_resident_iterations"):
        check_mp2(phis, u0, supports_packed_mp2_resident,
                  "packed mp2 resident")
        if iters < 1 or unroll < 1 or iters % unroll:
            raise ValueError(f"unroll must divide iters (iters={iters}, "
                             f"unroll={unroll})")
        if phis.device.type == "cpu":
            return packed_mp2_resident_iterations_reference(phis, u0, p, iters,
                                                            unroll)
        h, w = u0.shape
        out, parts = _cuda.launch_mp2_resident(
            "cv_packed_mp2_resident_iterations",
            pack_planes(phis) if planes is None else planes,
            pack_planes(u0), p, iters, unroll, h, w)
        packed_mp2_resident_iterations.launches += 1
        return unpack_planes(out), parts


packed_mp2_resident_iterations.launches = 0
