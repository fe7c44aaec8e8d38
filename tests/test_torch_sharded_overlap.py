"""``halo='overlap'`` of the port's sharded solvers (parallel/sharded.py:
the interior swept from each shard's own cells while the exchange runs,
then the rim stitched from strips of the exchanged block) against the
port's exchange-then-sweep route and the JAX reference, on grids of CPU
devices.

- The plain route is bitwise the port's ``halo='ppermute'`` route: per
  iteration and at comm_k 2 (a remainder chunk included), the trace, and
  multiphase gray and RGB; and within 1e-10 of the reference's overlap
  route (masks and iteration counts equal), in tolerance mode within
  twice the reference's own 1x1-vs-2x4 gap.
- The hybrid (``use_pallas=True``: K1's or K2's shard mode as the
  interior, their plain versions here) after one iteration or chunk:
  interior cells bitwise the port's kernel route, rim cells bitwise its
  plain route (tests/test_sharded_overlap.py's bars for the reference's
  hybrid), and held to the reference's hybrid at that file's bars
  (masks equal, phi within rtol 1e-3 and atol 5e-2 over 15 iterations),
  the gap printed under ``pytest -s``.
- Every ValueError of the reference's overlap and rdma routing is raised
  for the same arguments.
- ``cuda``-marked: on the card, with the exchange on a second stream, the
  plain route bitwise the ppermute route and the hybrid's interior
  bitwise the kernel route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.parallel import mesh as jmesh
from chan_vese_tpu.parallel import sharded as jsharded
from chan_vese_tpu_torch.parallel import (
    make_grid_mesh, segment_multiphase_sharded,
    segment_multiphase_sharded_fixed_trace, segment_sharded,
    segment_sharded_fixed_trace)
from fixtures import four_regions, two_disks
from torch_port_helpers import (assert_rel, cuda_device, params, to_np,
                                to_torch)

CPU = torch.device("cpu")
MU_MP = 0.003 * 255.0 ** 2
GRAY = two_disks(48, 96, noise=6.0)[0]        # 24x24 shards on a 2x4 grid
WIDE = two_disks(48, 256, noise=6.0)[0]       # 24x64: K2's envelope
MP_GRAY = four_regions(64, 128, noise=4.0)[0]
# twice the reference's own 1x1-vs-2x4 gap of the overlap tolerance runs
TOL_GAP = 2 * 2.5e-9


def _rgb(h=64, w=128):
    rng = np.random.default_rng(0)
    colors = np.array([[220.0, 40.0, 40.0], [40.0, 220.0, 40.0],
                       [40.0, 40.0, 220.0], [200.0, 200.0, 200.0]])
    lab = np.zeros((h, w), np.int32)
    lab[:h // 2, w // 2:] = 1
    lab[h // 2:, :w // 2] = 2
    lab[h // 2:, w // 2:] = 3
    return colors[lab] + 3.0 * rng.standard_normal((h, w, 3))


def cpu_grid(nx, ny):
    return make_grid_mesh(nx, ny, [CPU] * (nx * ny))


@pytest.fixture(scope="module")
def jgrid():
    return jmesh.make_grid_mesh(2, 4)


def rim_mask(shape, nx, ny, top, bottom):
    """The stitched rim of every shard: ``top`` rows/cols top/left,
    ``bottom`` bottom/right."""
    h, w = shape[0] // nx, shape[1] // ny
    rim = np.zeros(shape, bool)
    for bi in range(nx):
        for bj in range(ny):
            r0, c0 = bi * h, bj * w
            rim[r0:r0 + top, c0:c0 + w] = True
            rim[r0 + h - bottom:r0 + h, c0:c0 + w] = True
            rim[r0:r0 + h, c0:c0 + top] = True
            rim[r0:r0 + h, c0 + w - bottom:c0 + w] = True
    return rim


# the plain route ---------------------------------------------------------------

@pytest.mark.parametrize("comm_k,iters", [(1, 5), (2, 7)])
def test_overlap_equals_exchange_then_sweep_and_reference(jgrid, comm_k,
                                                          iters):
    pj, pt = params()
    kw = dict(fixed=True, max_iter=iters, comm_k=comm_k, use_pallas=False)
    mesh = cpu_grid(2, 4)
    got = segment_sharded(to_torch(GRAY), pt, mesh, halo="overlap", **kw)
    std = segment_sharded(to_torch(GRAY), pt, mesh, **kw)
    assert torch.equal(got.phi, std.phi)
    assert torch.equal(got.c1, std.c1) and torch.equal(got.c2, std.c2)
    want = jsharded.segment_sharded(jnp.asarray(GRAY), pj, jgrid,
                                    halo="overlap", **kw)
    assert_rel(got.phi, want.phi, 1e-10)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    assert got.iters == int(want.iters) == iters


def _rel(a, b):
    a, b = to_np(a).astype(np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("comm_k", [1, 4])
def test_overlap_tolerance_mode_matches_reference(jgrid, comm_k):
    """The reference's overlap tolerance test (24 iterations): its
    trajectory amplifies the shards' reduction order (the reference's own
    1x1 run of this test lies 2.49e-9 and 2.50e-9 of phi's scale from its
    2x4 run at comm_k 1 and 4), so phi is held within twice that gap, as
    test_torch_sharded.py holds its tolerance runs."""
    pj, pt = params(tol=1e-4, max_iter=200, min_iter=5)
    kw = dict(comm_k=comm_k, use_pallas=False, halo="overlap")
    got = segment_sharded(to_torch(GRAY), pt, cpu_grid(2, 4), **kw)
    want = jsharded.segment_sharded(jnp.asarray(GRAY), pj, jgrid, **kw)
    assert got.iters == int(want.iters) < 200
    assert _rel(got.phi, want.phi) <= TOL_GAP
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))


def test_overlap_trace_equals_exchange_then_sweep(jgrid):
    pj, pt = params(init="circle")
    mesh = cpu_grid(2, 4)
    got = segment_sharded_fixed_trace(to_torch(GRAY), pt, mesh, iters=4,
                                      use_pallas=False, halo="overlap")
    std = segment_sharded_fixed_trace(to_torch(GRAY), pt, mesh, iters=4,
                                      use_pallas=False)
    for field in ("phi", "energy", "delta", "c1", "c2"):
        assert torch.equal(getattr(got, field), getattr(std, field)), field
    want = jsharded.segment_sharded_fixed_trace(
        jnp.asarray(GRAY), pj, jgrid, iters=4, use_pallas=False,
        halo="overlap")
    assert_rel(got.energy, want.energy, 1e-10)


@pytest.mark.parametrize("rgb,m_sets", [(False, 2), (False, 3), (True, 2)])
def test_multiphase_overlap_equals_exchange_then_sweep(jgrid, rgb, m_sets):
    img = _rgb() if rgb else MP_GRAY
    pj, pt = params(mu=MU_MP)
    kw = dict(fixed=True, max_iter=3, m_sets=m_sets, use_pallas=False)
    mesh = cpu_grid(2, 4)
    got = segment_multiphase_sharded(to_torch(img), pt, mesh,
                                     halo="overlap", **kw)
    std = segment_multiphase_sharded(to_torch(img), pt, mesh, **kw)
    assert torch.equal(got.phis, std.phis)
    want = jsharded.segment_multiphase_sharded(jnp.asarray(img), pj, jgrid,
                                               halo="overlap", **kw)
    assert_rel(got.phis, want.phis, 1e-10)
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))


def test_multiphase_overlap_trace_and_tolerance_match_reference(jgrid):
    pj, pt = params(mu=MU_MP, max_iter=200)
    mesh = cpu_grid(2, 4)
    got = segment_multiphase_sharded_fixed_trace(
        to_torch(MP_GRAY), pt, mesh, iters=3, halo="overlap")
    std = segment_multiphase_sharded_fixed_trace(to_torch(MP_GRAY), pt,
                                                 mesh, iters=3)
    assert torch.equal(got.phis, std.phis)
    assert torch.equal(got.energy, std.energy)
    tol = segment_multiphase_sharded(to_torch(MP_GRAY), pt, mesh,
                                     use_pallas=False, halo="overlap")
    want = jsharded.segment_multiphase_sharded(
        jnp.asarray(MP_GRAY), pj, jgrid, use_pallas=False, halo="overlap")
    assert tol.iters == int(want.iters) < 200
    np.testing.assert_array_equal(to_np(tol.labels), np.asarray(want.labels))


# the hybrid: the kernels as the interior -------------------------------------

@pytest.mark.parametrize("comm_k", [1, 2])
def test_hybrid_interior_is_kernel_route_rim_is_plain_route(comm_k):
    """One iteration (comm_k 1) or chunk (comm_k 2): the interior cells
    bitwise the kernel route, the rim (4k up/left, 2k down/right) bitwise
    the plain route, as the reference's hybrid."""
    img = GRAY if comm_k == 1 else WIDE
    _, pt = params()
    kw = dict(fixed=True, max_iter=comm_k, comm_k=comm_k)
    mesh = cpu_grid(2, 4)
    ovl = segment_sharded(to_torch(img), pt, mesh, use_pallas=True,
                          halo="overlap", **kw)
    ker = segment_sharded(to_torch(img), pt, mesh, use_pallas=True, **kw)
    jnp_ = segment_sharded(to_torch(img), pt, mesh, use_pallas=False, **kw)
    a, k, j = to_np(ovl.phi), to_np(ker.phi), to_np(jnp_.phi)
    rim = rim_mask(a.shape, 2, 4, 4 * comm_k, 2 * comm_k)
    np.testing.assert_array_equal(a[~rim], k[~rim])
    np.testing.assert_array_equal(a[rim], j[rim])


@pytest.mark.parametrize("comm_k,iters", [(1, 15), (2, 14)])
def test_hybrid_matches_reference_hybrid(jgrid, comm_k, iters, capsys):
    """The port's hybrid against the reference's (its kernels in
    interpret mode) at tests/test_sharded_overlap.py's bars for its
    hybrid against its parents: masks equal, phi within rtol 1e-3, atol
    5e-2. The measured gap is printed."""
    img = GRAY if comm_k == 1 else WIDE
    pj, pt = params()
    kw = dict(fixed=True, max_iter=iters, comm_k=comm_k, use_pallas=True,
              halo="overlap")
    got = segment_sharded(to_torch(img), pt, cpu_grid(2, 4), **kw)
    want = jsharded.segment_sharded(jnp.asarray(img), pj, jgrid,
                                    interpret=True, **kw)
    gap = float(np.max(np.abs(to_np(got.phi) - np.asarray(want.phi))))
    with capsys.disabled():
        print(f"\nhybrid overlap comm_k={comm_k}, {iters} iterations, f64: "
              f"max |phi - reference hybrid| = {gap:.3e}")
    np.testing.assert_allclose(to_np(got.phi), np.asarray(want.phi),
                               rtol=1e-3, atol=5e-2)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))


# the reference's raises ----------------------------------------------------------

RAISES = {  # case: (function name, image shape, keywords, message)
    "overlap shard below 16": ("segment_sharded", (16, 32),
                               dict(halo="overlap", use_pallas=False),
                               "16x16"),
    "overlap x comm_k RGB": ("segment_sharded", (48, 96, 3),
                             dict(halo="overlap", comm_k=2), "grayscale"),
    "rdma RGB": ("segment_sharded", (48, 96, 3), dict(halo="rdma"),
                 "grayscale"),
    "overlap RGB": ("segment_sharded", (48, 96, 3), dict(halo="overlap"),
                    "grayscale"),
    "packed rdma": ("segment_sharded", (48, 256),
                    dict(halo="rdma", comm_k=2, use_pallas=True,
                         packed=True), "packed"),
    "trace rdma RGB": ("segment_sharded_fixed_trace", (48, 96, 3),
                       dict(halo="rdma"), "grayscale"),
    "multiphase overlap x comm_k": ("segment_multiphase_sharded", (64, 128),
                                    dict(halo="overlap", comm_k=2),
                                    "overlap x comm_k"),
    "multiphase overlap shard below 16": (
        "segment_multiphase_sharded", (16, 32), dict(halo="overlap"),
        "16x16"),
    "multiphase overlap kernel": ("segment_multiphase_sharded", (64, 256),
                                  dict(halo="overlap", use_pallas=True),
                                  "pallas path unsupported"),
    "multiphase trace overlap kernel": (
        "segment_multiphase_sharded_fixed_trace", (64, 256),
        dict(halo="overlap", use_pallas=True), "pallas path unsupported"),
    "multiphase trace overlap shard below 16": (
        "segment_multiphase_sharded_fixed_trace", (16, 32),
        dict(halo="overlap"), "16x16"),
}


@pytest.mark.parametrize("case", list(RAISES))
def test_overlap_and_rdma_raise_where_the_reference_raises(jgrid, case):
    name, shape, kw, match = RAISES[case]
    pj, pt = params()
    with pytest.raises(ValueError, match=match):
        getattr(jsharded, name)(jnp.zeros(shape), pj, jgrid, **kw)
    import chan_vese_tpu_torch.parallel as tpar
    with pytest.raises(ValueError, match=match):
        getattr(tpar, name)(torch.zeros(shape, dtype=torch.float64), pt,
                            cpu_grid(2, 4), **kw)


# on the card -------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("comm_k", [1, 4])
def test_overlap_on_the_card_with_a_second_stream(comm_k):
    dev = cuda_device()
    img = torch.from_numpy(two_disks(256, 512, noise=6.0)[0]
                           .astype(np.float32)).to(dev)
    _, pt = params()
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    kw = dict(fixed=True, max_iter=comm_k, comm_k=comm_k)
    plain = segment_sharded(img, pt, mesh, use_pallas=False, halo="overlap",
                            **kw)
    std = segment_sharded(img, pt, mesh, use_pallas=False, **kw)
    hyb = segment_sharded(img, pt, mesh, use_pallas=True, halo="overlap",
                          **kw)
    ker = segment_sharded(img, pt, mesh, use_pallas=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(plain.phi, std.phi)
    a, k = hyb.phi.cpu().numpy(), ker.phi.cpu().numpy()
    rim = rim_mask(a.shape, 2, 2, 4 * comm_k, 2 * comm_k)
    np.testing.assert_array_equal(a[~rim], k[~rim])
