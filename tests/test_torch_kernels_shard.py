"""The shard-canvas modes of K1, K2, K3 and K5 in the port against the JAX
reference.

- Each mode's plain version against the JAX kernel in interpret mode
  (``pallas_sweep.fused_iteration(parity, crop, edges)``,
  ``pallas_banded.banded_chunk_sharded``, ``banded_chunk_mc_sharded``,
  ``pallas_packed.packed_banded_chunk_sharded``) on the reference's
  lane-padded canvases of every shard of a 2x4 mesh (each combination of
  global-edge flags but none) and of a 3x3 mesh's centre shard: the crop
  window and the partials. f64: the crop at 1e-10 of its scale, s_uH and
  s_H at 1e-8 (the reference's Heaviside takes a Cephes atan accurate to
  f32), the other partials at 1e-10; f32: equal masks and chip_smoke.py's
  bars.
- ``segment_sharded(use_pallas=True)`` on CPU devices runs these plain
  versions through the driver, against the reference's kernel route
  (interpret mode) and its jnp route.
- ``cuda``-marked tests hold each mode against its plain version on the
  card, with a second launch bitwise equal to the first (skipped without a
  GPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.ops import pallas_banded, pallas_packed, pallas_sweep
from chan_vese_tpu.ops.reductions import region_means as j_region_means
from chan_vese_tpu.parallel import mesh as jmesh
from chan_vese_tpu.parallel import sharded as jsharded
from chan_vese_tpu.utils.init_phi import init_phi as j_init_phi
from chan_vese_tpu_torch.ops import banded_kernel, fused_kernel, \
    packed_kernel
from chan_vese_tpu_torch.parallel import make_grid_mesh, segment_sharded
from fixtures import colored_squares, two_disks
from torch_port_helpers import assert_digest, assert_rel, cuda_device, \
    params, to_np, to_torch

F32 = np.float32
CPU = torch.device("cpu")
# chip_smoke.py's bars for a kernel against its plain version
PHI_BAR = dict(rtol=1e-4, atol=1e-4)
PARTS_BAR = dict(rtol=1e-4, atol=16.0)


def _canvases(img, phi, nx, ny, D, lane):
    """The reference's canvases of every shard of an nx x ny mesh: the
    shard's block padded by D (its neighbours' cells, edge replicas at the
    global edges: what the halo exchange builds) and edge-extended to a
    multiple of ``lane`` columns. Yields ((ix, iy), phi canvas, image
    canvas (channels-first for an (H, W, C) image), parity, edges, crop)."""
    H, W = phi.shape
    h, w = H // nx, W // ny
    wc = -(-(w + 2 * D) // lane) * lane
    cimg = np.moveaxis(img, -1, 0) if img.ndim == 3 else img
    lead = ((0, 0),) * (cimg.ndim - 2)
    pp = np.pad(phi, D, mode="edge")
    up = np.pad(cimg, lead + ((D, D), (D, D)), mode="edge")
    for ix in range(nx):
        for iy in range(ny):
            win = np.s_[..., ix * h: ix * h + h + 2 * D,
                        iy * w: iy * w + w + 2 * D]
            lane_pad = ((0, 0), (0, wc - (w + 2 * D)))
            yield ((ix, iy), np.pad(pp[win], lane_pad, mode="edge"),
                   np.pad(up[win], lead + lane_pad, mode="edge"),
                   (ix * h + iy * w) % 2,
                   (ix == 0, ix == nx - 1, iy == 0, iy == ny - 1),
                   (D, D + h, D, D + w))


def _inputs(shape, dtype, rgb=False):
    """(image, checkerboard phi, c1, c2) numpy: two disks, or colored
    squares with per-channel means."""
    img = (colored_squares(*shape, noise=8.0, seed=3)[0] if rgb
           else two_disks(*shape, noise=6.0)[0]).astype(dtype)
    phi = np.asarray(j_init_phi(shape, "checkerboard", jnp.float64), dtype)
    c1, c2 = j_region_means(jnp.asarray(img), jnp.asarray(phi), 1.0)
    return img, phi, np.asarray(c1, dtype), np.asarray(c2, dtype)


def _mode_calls(mode, k, pj, pt):
    """(reference call, port call) of a mode, each taking (phi canvas,
    image canvas, c1, c2, parity, edges, crop) as its own arrays."""
    if mode == "K1":
        return (lambda c, u, a, b, par, e, cr: pallas_sweep.fused_iteration(
                    c, u, a, b, pj, parity=par, crop=cr, edges=e,
                    interpret=True),
                lambda c, u, a, b, par, e, cr: fused_kernel.fused_iteration(
                    c, u, a, b, pt, parity=par, crop=cr, edges=e))
    if mode == "K2":
        return (lambda c, u, a, b, par, e, cr:
                pallas_banded.banded_chunk_sharded(
                    c, u, a, b, pj, k, par, e, cr, interpret=True),
                lambda c, u, a, b, par, e, cr:
                banded_kernel.banded_chunk_sharded(c, u, a, b, pt, k, par, e,
                                                   cr))
    if mode == "K5":
        return (lambda c, u, a, b, par, e, cr:
                pallas_banded.banded_chunk_mc_sharded(
                    c, u, a, b, pj, k, par, e, cr, interpret=True),
                lambda c, u, a, b, par, e, cr:
                banded_kernel.banded_chunk_mc_sharded(
                    c, u, a, b, pt, k, par, e, cr))
    # K3: each packs the flat canvases its own way
    pack = packed_kernel.pack_planes_reference
    return (lambda c, u, a, b, par, e, cr:
            pallas_packed.packed_banded_chunk_sharded(
                pallas_packed._pack(c), pallas_packed._pack(u), a, b, pj, k,
                e, cr, interpret=True),
            lambda c, u, a, b, par, e, cr:
            packed_kernel.packed_banded_chunk_sharded(
                pack(c), pack(u), a, b, pt, k, e, cr))


# mode, image shape, mesh, halo depth D, k, lane width
CASES = {
    "K1": ((64, 100), (2, 4), 4, 1, 128),
    "K2": ((48, 96), (2, 4), 8, 2, 128),
    "K2 k=3 remainder": ((48, 256), (2, 4), 16, 3, 128),
    "K3": ((64, 128), (2, 4), 8, 2, 256),
    "K5": ((48, 96), (2, 4), 8, 2, 128),
    "K5 k=1": ((48, 256), (2, 4), 4, 1, 128),
    "K2 3x3 centre": ((72, 96), (3, 3), 8, 2, 128),
}


def _compare(case, dtype, only=None):
    """Run a case on every shard (or only the shard ``only``) and hold the
    port's plain version against the reference kernel."""
    shape, (nx, ny), D, k, lane = CASES[case]
    mode = case.split()[0]
    rgb = mode == "K5"
    img, phi, c1, c2 = _inputs(shape, dtype, rgb)
    pj, pt = params()
    ref, port = _mode_calls(mode, k, pj, pt)
    seen = set()
    for pos, canvas, ucanvas, par, edges, crop in _canvases(
            img, phi, nx, ny, D, lane):
        if only is not None and pos != only:
            continue
        r0, r1, c0, c1w = crop
        want, wparts = ref(jnp.asarray(canvas), jnp.asarray(ucanvas),
                           jnp.asarray(c1), jnp.asarray(c2), jnp.int32(par),
                           jnp.asarray(edges, dtype), crop)
        got, parts = port(to_torch(canvas, dtype), to_torch(ucanvas, dtype),
                          to_torch(c1, dtype), to_torch(c2, dtype), par,
                          edges, crop)
        if mode == "K3":
            want = pallas_packed._unpack(want)
            got = packed_kernel.unpack_planes_reference(got)
        want = np.asarray(want)[r0:r1, c0:c1w]
        got = to_np(got)[r0:r1, c0:c1w]
        wparts = np.asarray(wparts)
        nh = 3 if rgb else 1  # s_uH per channel, then s_H
        assert parts.shape == wparts.shape
        if dtype == np.float64:
            assert_rel(got, want, 1e-10)
            assert_rel(parts[:nh + 1], wparts[:nh + 1], 1e-8)
            assert_rel(parts[nh + 1:nh + 5], wparts[nh + 1:nh + 5], 1e-10)
        else:
            np.testing.assert_array_equal(got >= 0, want >= 0)
            np.testing.assert_allclose(got, want, **PHI_BAR)
            np.testing.assert_allclose(to_np(parts), wparts, **PARTS_BAR)
        seen.add(edges)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_plain_shard_modes_f64_match_pallas(case):
    seen = _compare(case, np.float64,
                    only=(1, 1) if "centre" in case else None)
    if "centre" in case:
        assert seen == {(False, False, False, False)}
    else:  # the 2x4 mesh's six flag combinations
        assert len(seen) == 6


@pytest.mark.parametrize("case", ["K1", "K2", "K3", "K5"])
def test_plain_shard_modes_f32_match_pallas(case):
    _compare(case, F32)


def test_shard_modes_copy_the_canvas_outside_the_crop():
    """Cells outside the crop come back as they went in; a canvas whose
    crop lacks the reach, an odd packed crop and a bad unroll raise."""
    img, phi, c1, c2 = _inputs((48, 96), np.float64)
    c1, c2 = to_torch(c1), to_torch(c2)
    _, pt = params()
    (_, canvas, ucanvas, par, edges, crop), = [
        c for c in _canvases(img, phi, 2, 4, 8, 128) if c[0] == (0, 1)]
    x, u = to_torch(canvas), to_torch(ucanvas)
    got, _ = banded_kernel.banded_chunk_sharded(x, u, c1, c2, pt, 2, par,
                                                edges, crop)
    r0, r1, c0, c1w = crop
    inside = torch.zeros_like(x, dtype=torch.bool)
    inside[r0:r1, c0:c1w] = True
    assert torch.equal(got[~inside], x[~inside])
    assert not torch.equal(got[inside], x[inside])
    # an interior side needs 4k rows up, 2k down; a flagged side two
    with pytest.raises(ValueError, match="needs"):
        banded_kernel.banded_chunk_sharded(x, u, c1, c2, pt, 3, par, edges,
                                           crop)
    with pytest.raises(ValueError, match="needs"):
        fused_kernel.fused_iteration(x, u, c1, c2, pt, par,
                                     (1, r1, c0, c1w), edges)
    fused_kernel.fused_iteration(x, u, c1, c2, pt, par, (2, r1, c0, c1w),
                                 edges)
    with pytest.raises(ValueError, match="window"):
        banded_kernel.banded_chunk_sharded(x, u, c1, c2, pt, 2, par, edges,
                                           (8, 8, 8, 40))
    planes = packed_kernel.pack_planes_reference(x)
    with pytest.raises(ValueError, match="even"):
        packed_kernel.packed_banded_chunk_sharded(
            planes, packed_kernel.pack_planes_reference(u), c1, c2, pt, 2,
            edges, (8, 31, 8, 40))
    with pytest.raises(ValueError, match="unroll"):
        banded_kernel.banded_chunk_sharded(x, u, c1, c2, pt, 2, par, edges,
                                           crop, unroll=3)


# the driver through the kernels ---------------------------------------------

@pytest.fixture(scope="module")
def jgrid():
    return jmesh.make_grid_mesh(2, 4)


def _rel(a, b):
    a, b = to_np(a).astype(np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("comm_k,iters,rgb", [(1, 6, False), (4, 10, False),
                                              (2, 6, True)])
def test_driver_through_kernels_f64_matches_reference(jgrid, comm_k, iters,
                                                      rgb):
    """Port segment_sharded(use_pallas=True) on a 2x4 grid of CPU devices
    (the kernels' plain versions) against the reference's kernel route in
    interpret mode and its jnp route: within 1e-10 of the jnp route, within
    twice the reference's own kernel-vs-jnp gap of its kernel route, masks
    identical."""
    shape = (48, 256)
    img = (colored_squares(*shape, noise=8.0, seed=3)[0] if rgb
           else two_disks(*shape, noise=6.0)[0])
    pj, pt = params(init="circle")
    kw = dict(fixed=True, max_iter=iters, comm_k=comm_k)
    want_k = jsharded.segment_sharded(jnp.asarray(img), pj, jgrid,
                                      use_pallas=True, interpret=True, **kw)
    want_j = jsharded.segment_sharded(jnp.asarray(img), pj, jgrid,
                                      use_pallas=False, **kw)
    mesh = make_grid_mesh(2, 4, [CPU] * 8)
    got = segment_sharded(to_torch(img), pt, mesh, use_pallas=True, **kw)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want_k.mask))
    assert _rel(got.phi, want_j.phi) <= 1e-10
    assert _rel(got.phi, want_k.phi) <= max(
        2 * _rel(want_k.phi, want_j.phi), 1e-12)


# on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K1", "K2", "K3", "K5", "K2 3x3 centre"])
def test_shard_modes_cuda_match_plain(case):
    """Each mode on the card against its plain version on the same card, on
    every shard's canvas, at chip_smoke.py's bars; a second launch is
    bitwise the first, and each launch is counted."""
    dev = cuda_device()
    shape, (nx, ny), D, k, lane = CASES[case]
    mode = case.split()[0]
    img, phi, c1, c2 = _inputs(shape, F32, mode == "K5")
    _, pt = params()
    c1, c2 = to_torch(c1, F32).to(dev), to_torch(c2, F32).to(dev)
    wrapper = {"K1": fused_kernel.fused_iteration,
               "K2": banded_kernel.banded_chunk_sharded,
               "K3": packed_kernel.packed_banded_chunk_sharded,
               "K5": banded_kernel.banded_chunk_mc_sharded}[mode]
    count = "shard_launches" if mode == "K1" else "launches"
    n0, runs = getattr(wrapper, count), 0
    for _, canvas, ucanvas, par, edges, crop in _canvases(
            img, phi, nx, ny, D, lane):
        x = to_torch(canvas, F32).to(dev)
        u = to_torch(ucanvas, F32).to(dev)
        if mode == "K1":
            def kern(x, u):
                return fused_kernel.fused_iteration(x, u, c1, c2, pt, par,
                                                    crop, edges)

            def plain(x, u):
                return fused_kernel.fused_iteration_reference(
                    x, u, c1, c2, pt, par, crop, edges)
        elif mode == "K3":
            x = packed_kernel.pack_planes_reference(x)
            u = packed_kernel.pack_planes_reference(u)

            def kern(x, u):
                return packed_kernel.packed_banded_chunk_sharded(
                    x, u, c1, c2, pt, k, edges, crop)

            def plain(x, u):
                return packed_kernel.packed_banded_chunk_sharded_reference(
                    x, u, c1, c2, pt, k, edges, crop)
        else:
            def kern(x, u):
                return wrapper(x, u, c1, c2, pt, k, par, edges, crop)

            plain = {"K2": banded_kernel.banded_chunk_sharded_reference,
                     "K5": banded_kernel.banded_chunk_mc_sharded_reference
                     }[mode]
            plain = (lambda x, u, plain=plain:
                     plain(x, u, c1, c2, pt, k, par, edges, crop))
        got, parts = kern(x, u)
        again, aparts = kern(x, u)
        want, wparts = plain(x, u)
        torch.cuda.synchronize()
        runs += 2
        assert torch.equal(got, again) and torch.equal(parts, aparts)
        sure = want.abs() > PHI_BAR["atol"]
        assert bool(((got >= 0) == (want >= 0))[sure].all())
        np.testing.assert_allclose(to_np(got), to_np(want), **PHI_BAR)
        np.testing.assert_allclose(to_np(parts), to_np(wparts), **PARTS_BAR)
    assert getattr(wrapper, count) == n0 + runs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K2", "K2 k=3 remainder", "K2 3x3 centre",
                                  "K5", "K5 k=1"])
def test_band_shard_modes_cuda_are_bitwise_the_first_body(case):
    """K2's and K5's shard modes on csrc/band.cuh on every shard's canvas:
    the canvas and the flips bitwise the first body's recorded output, the
    partials at the plain version's bars."""
    dev = cuda_device()
    shape, (nx, ny), D, k, lane = CASES[case]
    rgb = case.startswith("K5")
    img, phi, c1, c2 = _inputs(shape, F32, rgb)
    _, pt = params()
    c1, c2 = to_torch(c1, F32).to(dev), to_torch(c2, F32).to(dev)
    for pos, canvas, ucanvas, par, edges, crop in _canvases(
            img, phi, nx, ny, D, lane):
        x = to_torch(canvas, F32).to(dev)
        u = to_torch(ucanvas, F32).to(dev)
        if rgb:
            got = banded_kernel.banded_chunk_mc_sharded(x, u, c1, c2, pt, k,
                                                        par, edges, crop)
            want = banded_kernel.banded_chunk_mc_sharded_reference(
                x, u, c1, c2, pt, k, par, edges, crop)
        else:
            got = banded_kernel.banded_chunk_sharded(x, u, c1, c2, pt, k,
                                                     par, edges, crop)
            want = banded_kernel.banded_chunk_sharded_reference(
                x, u, c1, c2, pt, k, par, edges, crop)
        torch.cuda.synchronize()
        flip = (u.shape[0] if rgb else 1) + 2
        assert_digest(f"{case} shard {pos}", got[0], got[1][flip:flip + 1])
        np.testing.assert_allclose(to_np(got[1]), to_np(want[1]),
                                   **PARTS_BAR)


# K3's shard mode on the card: (image shape, mesh, D, k, lane) as CASES,
# even shards and an even D (the packed mode's lattice parity 0)
K3_CARD = {"k=2": CASES["K3"], "k=3": ((48, 256), (2, 4), 16, 3, 128),
           "k=8": ((128, 256), (2, 2), 32, 8, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K3_CARD))
def test_packed_shard_mode_cuda_is_bitwise_the_first_body(case):
    """K3's shard mode on csrc/band.cuh on every shard's canvas: the planes
    and the flips bitwise the first body's recorded output, the partials at
    the plain version's bars; and K2's shard mode on the unpacked canvas,
    packed, bitwise in the planes and in every partial slot."""
    dev = cuda_device()
    shape, (nx, ny), D, k, lane = K3_CARD[case]
    img, phi, c1, c2 = _inputs(shape, F32)
    _, pt = params()
    c1, c2 = to_torch(c1, F32).to(dev), to_torch(c2, F32).to(dev)
    pack = packed_kernel.pack_planes
    for pos, canvas, ucanvas, par, edges, crop in _canvases(
            img, phi, nx, ny, D, lane):
        x = to_torch(canvas, F32).to(dev)
        u = to_torch(ucanvas, F32).to(dev)
        assert par == 0
        got = packed_kernel.packed_banded_chunk_sharded(
            pack(x), pack(u), c1, c2, pt, k, edges, crop)
        want = packed_kernel.packed_banded_chunk_sharded_reference(
            pack(x), pack(u), c1, c2, pt, k, edges, crop)
        flat = banded_kernel.banded_chunk_sharded(x, u, c1, c2, pt, k, 0,
                                                  edges, crop)
        torch.cuda.synchronize()
        assert_digest(f"K3 {case} shard {pos}", got[0], got[1][3:4])
        np.testing.assert_allclose(to_np(got[1]), to_np(want[1]),
                                   **PARTS_BAR)
        assert torch.equal(got[0], pack(flat[0]))
        assert torch.equal(got[1], flat[1])
