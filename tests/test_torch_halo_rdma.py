"""The port's halo exchange on the card (parallel/halo_rdma.py, K14: the
clamped gather) and ``halo='rdma'``
through the sharded drivers, against the port's plain exchange and the JAX
reference, on grids of CPU devices.

- ``exchange_halo2d_rdma`` is bitwise ``exchange_halo2d`` on 2x4, 1x1
  (self-ring) and 3x3 grids at depths 1, 4 and 8, and on stacks; bitwise
  the reference's ``exchange_halo2d_rdma(interpret=True)`` under
  ``shard_map`` on the 2x4 mesh.
- ``_ring_shift_reference`` equals the reference's ring kernel on the
  single-axis 8-device mesh (the deepest check interpret mode allows).
- K14's geometry table (``_gather_plan``), executed on the CPU by an
  interpreter of csrc/halo_gather.cu's row rule (each padded row from the
  grid row that owns its clamped global row: west run, centre, east run,
  replicas at the image edges), gives ``exchange_halo2d`` bitwise on 1x1,
  1x3, 2x2, 2x4, 3x3, 4x5 and ragged grids at depths 1, 3, 4 and min(h,
  w), f32 and f64, for images, two-level-set stacks and parity-plane
  stacks, and the
  reference's ``exchange_halo2d_rdma(interpret=True)`` bitwise where the
  grid fits the 8-device mesh; one launch a device; the table is built
  once per geometry and reused; grids it does not take raise.
- ``halo='rdma'`` end to end: bitwise the port's ``halo='ppermute'``, and
  within 1e-10 of the reference's ``halo='rdma'`` (same masks and
  iteration counts), for ``segment_sharded`` (per iteration and comm_k 2,
  plain route and kernels' plain versions), its trace, and
  ``segment_multiphase_sharded`` (M = 2 and 3, the kernel route, the
  trace).
- ``cuda``-marked: K14 on the card bitwise its plain version, its first
  body's recorded output (tests/card_digests.json) and
  ``exchange_halo2d``, one launch an exchange, a second stream bitwise the
  first, and the CLI's ``--mesh 2 2 --halo rdma`` on one card.
"""

import ctypes
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chan_vese_tpu_torch._build as tbuild
from chan_vese_tpu.parallel import halo_rdma as jrdma
from chan_vese_tpu.parallel import mesh as jmesh
from chan_vese_tpu.parallel import sharded as jsharded
from chan_vese_tpu_torch.parallel import (
    exchange_halo2d, exchange_halo2d_rdma, grid_sharding, make_grid_mesh,
    segment_multiphase_sharded, segment_multiphase_sharded_fixed_trace,
    segment_sharded, segment_sharded_fixed_trace, shard_grid)
from chan_vese_tpu_torch.parallel import halo_rdma as trdma
from fixtures import four_regions, two_disks
from torch_port_helpers import (assert_digest, assert_rel, cuda_device, params,
                                to_np, to_torch)

CPU = torch.device("cpu")
MU_MP = 0.003 * 255.0 ** 2


def cpu_grid(nx, ny):
    return make_grid_mesh(nx, ny, [CPU] * (nx * ny))


def equal_grids(a, b):
    return all(torch.equal(x, y) for ra, rb in zip(a, b)
               for x, y in zip(ra, rb))


@pytest.fixture(scope="module")
def jgrid():
    return jmesh.make_grid_mesh(2, 4)


# the exchange ---------------------------------------------------------------

@pytest.mark.parametrize("nx,ny", [(2, 4), (1, 1), (3, 3)])
@pytest.mark.parametrize("depth", [1, 4, 8])
def test_rdma_exchange_equals_plain_exchange(nx, ny, depth):
    img = np.random.default_rng(nx * 10 + depth).standard_normal(
        (16 * nx, 20 * ny))
    blocks = shard_grid(to_torch(img), grid_sharding(cpu_grid(nx, ny)))
    assert equal_grids(exchange_halo2d_rdma(blocks, depth),
                       exchange_halo2d(blocks, depth))
    # a stack of level sets exchanges slice by slice
    stack = [[torch.stack([b, -b, 2 * b]) for b in row] for row in blocks]
    assert equal_grids(exchange_halo2d_rdma(stack, depth),
                       exchange_halo2d(stack, depth))


def test_rdma_exchange_checks_its_arguments():
    blocks = shard_grid(torch.zeros(16, 16), grid_sharding(cpu_grid(2, 2)))
    with pytest.raises(ValueError, match="depth"):
        exchange_halo2d_rdma(blocks, 9)
    mixed = [[blocks[0][0], blocks[0][1].to("meta")], blocks[1]]
    with pytest.raises(ValueError, match="CUDA device"):
        exchange_halo2d_rdma(mixed, 2)


@pytest.mark.parametrize("depth", [1, 4])
def test_rdma_exchange_equals_reference_rdma(jgrid, depth):
    """The reference's exchange_halo2d_rdma (interpret mode: a ppermute
    ring stands in for the remote copies on a multi-axis mesh) under
    shard_map on the 2x4 mesh, block by block."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    img = np.random.default_rng(depth).standard_normal((16, 32))
    mapped = jax.shard_map(
        lambda b: jrdma.exchange_halo2d_rdma(b, depth, interpret=True),
        mesh=jgrid, in_specs=P("x", "y"), out_specs=P("x", "y"),
        check_vma=False)
    with jax.set_mesh(jgrid):
        want = np.asarray(jax.jit(mapped)(jax.device_put(
            jnp.asarray(img), NamedSharding(jgrid, P("x", "y")))))
    got = exchange_halo2d_rdma(
        shard_grid(to_torch(img), grid_sharding(cpu_grid(2, 4))), depth)
    ph, pw = 8 + 2 * depth, 8 + 2 * depth
    for ix in range(2):
        for iy in range(4):
            np.testing.assert_array_equal(
                to_np(got[ix][iy]),
                want[ix * ph:(ix + 1) * ph, iy * pw:(iy + 1) * pw])


def test_ring_shift_reference_equals_reference_ring_kernel():
    """_ring_shift_reference against the reference's remote-copy ring
    kernel (_ring_exchange, interpret mode) on the single-axis 8-device
    mesh, as tests/test_halo_rdma.py holds that kernel against ppermute."""
    from jax import lax
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    mesh1d = jax.make_mesh((8,), ("x",), axis_types=(AxisType.Explicit,))
    x = np.random.default_rng(1).standard_normal((64, 128))

    def body(b):
        ix, n = lax.axis_index("x"), lax.axis_size("x")
        from_lo, from_hi = jrdma._ring_exchange(
            b[:4], b[-4:], prev_id=(ix - 1 + n) % n, next_id=(ix + 1) % n,
            collective_id=3, interpret=True)
        return jnp.concatenate([from_lo, from_hi], axis=0)

    mapped = jax.shard_map(body, mesh=mesh1d, in_specs=P("x"),
                           out_specs=P("x"), check_vma=False)
    with jax.set_mesh(mesh1d):
        want = np.asarray(jax.jit(mapped)(jax.device_put(
            jnp.asarray(x), NamedSharding(mesh1d, P("x")))))
    blocks = [to_torch(x[8 * i:8 * (i + 1)]) for i in range(8)]
    from_lo, from_hi = trdma._ring_shift_reference(
        [b[:4] for b in blocks], [b[-4:] for b in blocks])
    got = np.concatenate([np.concatenate([to_np(a), to_np(b)])
                          for a, b in zip(from_lo, from_hi)])
    np.testing.assert_array_equal(got, want)


class _GatherRows:
    """csrc/halo_gather.cu's row rule carried out on CPU memory: padded
    row r of the launch belongs to dst[k] (the last whose row0 <= r), slice
    b, row i; it holds global row clamp(r0 - D + i), found in the grid row
    above, its own or below; its west D cells are the last D of the shard
    to the west (or copies of the row's first cell), then the centre, then
    the east D cells (the first D of the shard to the east, or copies of
    the row's last cell)."""

    def __init__(self):
        self.launches = []

    def cv_halo_gather(self, geo_addr, ptrs_addr, esize, dev, stream):
        g = trdma._GatherGeo.from_address(geo_addr)
        n, D = g.nx * g.ny, g.depth
        ptrs = (ctypes.c_uint64 * (n + g.ndst)).from_address(ptrs_addr)
        assert esize in (4, 8) and 1 <= g.ndst <= n <= trdma._MAX_SHARDS
        self.launches.append(g.ndst)
        rows0 = list(g.rows0[:g.nx + 1])
        for r in range(g.total):
            k = max(j for j in range(g.ndst) if g.row0[j] <= r)
            s = g.dst[k]
            ix, iy = divmod(s, g.ny)
            ph, pw = g.h[s] + 2 * D, g.w[s] + 2 * D
            b, i = divmod(r - g.row0[k], ph)
            gr = min(max(rows0[ix] - D + i, 0), rows0[-1] - 1)
            sx = (ix - 1 if gr < rows0[ix] else
                  ix + 1 if gr >= rows0[ix + 1] else ix)
            c = sx * g.ny + iy

            def row(t, col=0):
                return ptrs[t] + (b * g.src_slice[t]
                                  + (gr - rows0[sx]) * g.src_row[t]
                                  + col) * esize

            d = ptrs[n + k] + (b * ph + i) * pw * esize
            w = g.w[s]
            runs = [(0, row(c - 1, g.w[c - 1] - D) if iy > 0 else None,
                     row(c)),
                    (D + w, row(c + 1) if iy < g.ny - 1 else None,
                     row(c, w - 1))]
            ctypes.memmove(d + D * esize, row(c), w * esize)
            for at, src, edge in runs:
                if src is not None:
                    ctypes.memmove(d + at * esize, src, D * esize)
                else:
                    for j in range(D):
                        ctypes.memmove(d + (at + j) * esize, edge, esize)
        return 0


def _grid_key(blocks, depth):
    return trdma._key([x for row in blocks for x in row], depth,
                      len(blocks), len(blocks[0]))


def _gather(blocks, plan):
    return trdma._gather([x for row in blocks for x in row], len(blocks[0]),
                         plan)


def _fake_cuda_plan(blocks, depth, cards=1):
    """K14's plan for the grid as if shard s lay on cuda:(s % cards), each
    launch then run on the CPU (its buffer there, no cross-card waits)."""
    depth_, nx, ny, metas = _grid_key(blocks, depth)
    metas = tuple((shape, stride, torch.device("cuda", s % cards), dt)
                  for s, (shape, stride, _, dt) in enumerate(metas))
    plan = trdma._gather_plan.__wrapped__((depth_, nx, ny, metas))
    for lp in plan.launches:
        lp.device, lp.remote = CPU, []
    return plan


@pytest.fixture
def gather_lib(monkeypatch):
    lib = _GatherRows()
    monkeypatch.setattr(tbuild, "library", lambda: lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    return lib


def _stacks(blocks):
    """The inputs of one exchange: the image, a stack of two level sets,
    and parity planes (2, 2, h/2, w/2) of each block."""
    return {"image": blocks,
            "two level sets": [[torch.stack([b, 1 - 2 * b]) for b in row]
                               for row in blocks],
            "parity planes": [[b.reshape(b.shape[0] // 2, 2, b.shape[1] // 2,
                                         2).permute(1, 3, 0, 2).contiguous()
                               for b in row] for row in blocks]}


GATHER_GRIDS = [(1, 1), (1, 3), (2, 2), (2, 4), (3, 3), (4, 5)]


@pytest.mark.parametrize("nx,ny", GATHER_GRIDS)
@pytest.mark.parametrize("depth", [1, 3, 4, "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_table_builds_the_exchange(gather_lib, nx, ny, depth, dtype):
    """The geometry _gather hands K14, executed by _GatherRows: every padded
    block bitwise exchange_halo2d's, for the image, two level sets and
    parity planes; one launch for the grid on one device."""
    img = np.random.default_rng(nx * 7 + ny).standard_normal(
        (12 * nx, 10 * ny))
    blocks = shard_grid(to_torch(img).to(dtype),
                        grid_sharding(cpu_grid(nx, ny)))
    for tag, xs in _stacks(blocks).items():
        d = min(xs[0][0].shape[-2:]) if depth == "min" else depth
        n0 = exchange_halo2d_rdma.launches
        got = _gather(xs, _fake_cuda_plan(xs, d))
        assert exchange_halo2d_rdma.launches - n0 == 1, tag
        want = exchange_halo2d(xs, d)
        assert equal_grids(got, want), tag
        assert all(x.is_contiguous() for row in got for x in row)
    assert gather_lib.launches == [nx * ny] * 3


@pytest.mark.parametrize("nx,ny", GATHER_GRIDS[:4])
@pytest.mark.parametrize("depth", [1, 4, "min"])
def test_gather_table_equals_reference_rdma(gather_lib, nx, ny, depth):
    """The reference's exchange_halo2d_rdma (interpret mode) under
    shard_map on an nx x ny mesh of the 8 CPU devices, slice by slice for
    a stack of two level sets, against the table's exchange."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jm = jmesh.make_grid_mesh(nx, ny)
    img = np.random.default_rng(nx + 5 * ny).standard_normal(
        (8 * nx, 10 * ny))
    d = 8 if depth == "min" else depth
    mapped = jax.jit(jax.shard_map(
        lambda b: jrdma.exchange_halo2d_rdma(b, d, interpret=True),
        mesh=jm, in_specs=P("x", "y"), out_specs=P("x", "y"),
        check_vma=False))
    sets = np.stack([img, 0.5 - img])
    with jax.set_mesh(jm):
        want = [np.asarray(mapped(jax.device_put(
            jnp.asarray(x), NamedSharding(jm, P("x", "y"))))) for x in sets]
    blocks = shard_grid(to_torch(sets.transpose(1, 2, 0)),
                        grid_sharding(cpu_grid(nx, ny)))
    blocks = [[b.permute(2, 0, 1) for b in row] for row in blocks]
    got = _gather(blocks, _fake_cuda_plan(blocks, d))
    ph, pw = 8 + 2 * d, 10 + 2 * d
    for ix in range(nx):
        for iy in range(ny):
            for m in range(2):
                np.testing.assert_array_equal(
                    to_np(got[ix][iy][m]),
                    want[m][ix * ph:(ix + 1) * ph, iy * pw:(iy + 1) * pw])


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_table_ragged_grid(gather_lib, depth, dtype):
    """A grid whose rows and columns differ in extent (7, 5, 6 rows; 9, 4,
    8 columns), cut by hand: the table reads each shard's own offset."""
    img = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (18, 21))).to(dtype)
    rows, cols = (0, 7, 12, 18), (0, 9, 13, 21)
    blocks = [[img[rows[i]:rows[i + 1], cols[j]:cols[j + 1]].contiguous()
               for j in range(3)] for i in range(3)]
    got = _gather(blocks, _fake_cuda_plan(blocks, depth))
    assert equal_grids(got, exchange_halo2d(blocks, depth))
    # the same grid as views into the image (row strides 21): no copy
    views = [[img[rows[i]:rows[i + 1], cols[j]:cols[j + 1]]
              for j in range(3)] for i in range(3)]
    plan = _fake_cuda_plan(views, depth)
    assert not any(plan.copy)
    assert equal_grids(_gather(views, plan), got)


def test_gather_table_copies_what_does_not_fold(gather_lib):
    """A block whose columns are not unit-stride (a transposed view) is
    copied first; the exchange is still bitwise."""
    img = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (24, 20)))
    blocks = [[img[:12, :10], img[:12, 10:].t().contiguous().t()],
              [img[12:, :10], img[12:, 10:]]]
    plan = _fake_cuda_plan(blocks, 3)
    assert plan.copy == [False, True, False, False]
    assert equal_grids(_gather(blocks, plan),
                       exchange_halo2d(blocks, 3))


def test_gather_splits_the_grid_by_device(gather_lib):
    """Shards on two cards: one launch on each, each writing its own
    shards' padded blocks, reading across the cards only from the 3x3
    neighbourhoods of its shards; together bitwise exchange_halo2d."""
    img = np.random.default_rng(6).standard_normal((24, 30))
    blocks = shard_grid(to_torch(img), grid_sharding(cpu_grid(2, 3)))
    depth, nx, ny, metas = _grid_key(blocks, 4)
    metas = tuple((shape, stride, torch.device("cuda", int(s in (0, 3))),
                   dt) for s, (shape, stride, _, dt) in enumerate(metas))
    plan = trdma._gather_plan.__wrapped__((depth, nx, ny, metas))
    assert [(lp.device.index, lp.dst) for lp in plan.launches] == [
        (1, [0, 3]), (0, [1, 2, 4, 5])]
    assert [lp.remote for lp in plan.launches] == [
        [torch.device("cuda", 0)], [torch.device("cuda", 1)]]
    assert [lp.geo.total for lp in plan.launches] == [2 * 20, 4 * 20]
    for lp in plan.launches:
        lp.device, lp.remote = CPU, []
    assert equal_grids(_gather(blocks, plan), exchange_halo2d(blocks,
                                                                    4))
    assert gather_lib.launches == [2, 4]


def test_gather_plan_is_built_once_per_geometry():
    """A second exchange of the same geometry (other tensors, same shapes,
    strides, devices, dtype and depth) reuses the cached table; another
    depth or dtype builds its own."""
    def key(seed, depth, dtype=torch.float32):
        img = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (16, 24))).to(dtype)
        blocks = shard_grid(img, grid_sharding(cpu_grid(2, 2)))
        d, nx, ny, metas = _grid_key(blocks, depth)
        return (d, nx, ny, tuple((sh, st, torch.device("cuda", 0), dt)
                                 for sh, st, _, dt in metas))

    trdma._gather_plan.cache_clear()
    first = trdma._gather_plan(key(0, 4))
    info = trdma._gather_plan.cache_info()
    assert trdma._gather_plan(key(1, 4)) is first
    after = trdma._gather_plan.cache_info()
    assert (after.hits, after.misses) == (info.hits + 1, info.misses)
    assert trdma._gather_plan(key(1, 3)) is not first
    assert trdma._gather_plan(key(1, 4, torch.float64)) is not first
    assert trdma._gather_plan.cache_info().misses == info.misses + 2
    assert first.launches[0].geo.total == 4 * (8 + 8)


def test_gather_plan_refuses_what_it_cannot_take():
    def key(blocks, depth, dtype=None):
        d, nx, ny, metas = _grid_key(blocks, depth)
        return (d, nx, ny, tuple((sh, st, torch.device("cuda", 0),
                                  dtype or dt) for sh, st, _, dt in metas))

    img = torch.zeros(16, 24)
    even = shard_grid(img, grid_sharding(cpu_grid(2, 2)))
    with pytest.raises(TypeError, match="4- or 8-byte"):
        trdma._gather_plan(key(even, 2, torch.float16))
    thin = [[img[:14, :12], img[:14, 12:]], [img[14:, :12], img[14:, 12:]]]
    with pytest.raises(ValueError, match="depth 3 must lie in 1..2"):
        trdma._gather_plan(key(thin, 3))
    skew = [[img[:8, :12], img[:8, 12:]], [img[8:, :10], img[8:, 10:]]]
    with pytest.raises(ValueError, match="grid row and column"):
        trdma._gather_plan(key(skew, 2))
    many = [[torch.zeros(2, 2)] * 9] * 8
    with pytest.raises(ValueError, match="at most 64"):
        trdma._gather_plan(key(many, 1))


# halo='rdma' through the drivers ---------------------------------------------

GRAY = two_disks(48, 256, noise=6.0)[0]
MP_GRAY = four_regions(64, 256, noise=4.0)[0]


@pytest.mark.parametrize("comm_k,iters", [(1, 6), (2, 7)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_sharded_rdma_equals_ppermute_and_reference(jgrid, comm_k, iters,
                                                    use_pallas):
    """Bitwise the port's ppermute route of the same class; within 1e-10
    of the reference's rdma route (its jnp route: the kernels' plain
    versions compute its arithmetic, as test_torch_sharded.py holds them),
    the masks and iteration counts equal."""
    pj, pt = params(max_iter=iters)
    kw = dict(fixed=True, max_iter=iters, comm_k=comm_k)
    mesh = cpu_grid(2, 4)
    got = segment_sharded(to_torch(GRAY), pt, mesh, halo="rdma",
                          use_pallas=use_pallas, **kw)
    pp = segment_sharded(to_torch(GRAY), pt, mesh, use_pallas=use_pallas,
                         **kw)
    assert torch.equal(got.phi, pp.phi) and got.iters == pp.iters
    want = jsharded.segment_sharded(jnp.asarray(GRAY), pj, jgrid,
                                    halo="rdma", interpret=True,
                                    use_pallas=False, **kw)
    assert_rel(got.phi, want.phi, 1e-9 if use_pallas and comm_k > 1
               else 1e-10)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    assert got.iters == int(want.iters)
    assert_rel(got.c1, want.c1, 1e-10)


def test_sharded_rdma_tolerance_mode_matches_reference(jgrid):
    pj, pt = params(init="circle", max_iter=100)
    got = segment_sharded(to_torch(GRAY), pt, cpu_grid(2, 4), halo="rdma",
                          use_pallas=False)
    want = jsharded.segment_sharded(jnp.asarray(GRAY), pj, jgrid,
                                    halo="rdma", interpret=True,
                                    use_pallas=False)
    assert got.iters == int(want.iters) < 100
    assert_rel(got.phi, want.phi, 1e-10)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))


def test_fixed_trace_rdma_matches_reference(jgrid):
    pj, pt = params(init="circle")
    want = jsharded.segment_sharded_fixed_trace(
        jnp.asarray(GRAY), pj, jgrid, iters=5, use_pallas=False, halo="rdma",
        interpret=True)
    mesh = cpu_grid(2, 4)
    pp = segment_sharded_fixed_trace(to_torch(GRAY), pt, mesh, iters=5)
    for use_pallas in (False, True):
        got = segment_sharded_fixed_trace(to_torch(GRAY), pt, mesh, iters=5,
                                          use_pallas=use_pallas, halo="rdma")
        for field in ("phi", "energy", "delta", "c1", "c2"):
            assert_rel(getattr(got, field), getattr(want, field), 1e-10)
        if not use_pallas:
            assert torch.equal(got.phi, pp.phi)
            assert torch.equal(got.energy, pp.energy)


@pytest.mark.parametrize("case", ["m2", "m3", "m2 comm_k 2", "m2 kernel"])
def test_multiphase_rdma_equals_ppermute_and_reference(jgrid, case):
    img = MP_GRAY if case == "m2 kernel" else MP_GRAY[:, :64]
    kw = dict(fixed=True, max_iter=4, m_sets=3 if case == "m3" else 2,
              comm_k=2 if "comm_k" in case else 1)
    pj, pt = params(mu=MU_MP)
    kernel = case == "m2 kernel"
    mesh = cpu_grid(2, 4)
    got = segment_multiphase_sharded(to_torch(img), pt, mesh, halo="rdma",
                                     use_pallas=kernel, **kw)
    pp = segment_multiphase_sharded(to_torch(img), pt, mesh,
                                    use_pallas=kernel, **kw)
    assert torch.equal(got.phis, pp.phis)
    want = jsharded.segment_multiphase_sharded(
        jnp.asarray(img), pj, jgrid, halo="rdma", interpret=True,
        use_pallas=kernel, **kw)
    if kernel:  # the reference's kernel: test_torch_sharded_multiphase.py
        np.testing.assert_allclose(to_np(got.phis), np.asarray(want.phis),
                                   rtol=2e-5, atol=2e-3)
    else:
        assert_rel(got.phis, want.phis, 1e-10)
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))
    assert got.iters == int(want.iters)


def test_multiphase_trace_rdma_matches_reference(jgrid):
    img = MP_GRAY[:, :64]
    pj, pt = params(mu=MU_MP)
    want = jsharded.segment_multiphase_sharded_fixed_trace(
        jnp.asarray(img), pj, jgrid, iters=4, use_pallas=False, halo="rdma",
        interpret=True)
    got = segment_multiphase_sharded_fixed_trace(
        to_torch(img), pt, cpu_grid(2, 4), iters=4, use_pallas=False,
        halo="rdma")
    assert_rel(got.energy, want.energy, 1e-10)
    np.testing.assert_allclose(to_np(got.delta), np.asarray(want.delta),
                               atol=1e-12)
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))


# on the card -----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("nx,ny,depth", [(2, 2, 4), (3, 3, 32), (1, 1, 4),
                                         (2, 4, 1)])
def test_k14_cuda_equals_plain_version(nx, ny, depth):
    dev = cuda_device()
    img = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (96 * nx, 128 * ny)).astype(np.float32)).to(dev)
    blocks = shard_grid(img, grid_sharding(make_grid_mesh(
        nx, ny, [dev] * (nx * ny))))
    n0 = exchange_halo2d_rdma.launches
    got = exchange_halo2d_rdma(blocks, depth)
    again = exchange_halo2d_rdma(blocks, depth)
    torch.cuda.synchronize()
    assert exchange_halo2d_rdma.launches - n0 == 2
    assert equal_grids(got, trdma.exchange_halo2d_rdma_reference(blocks,
                                                                 depth))
    assert equal_grids(got, exchange_halo2d(blocks, depth))
    assert equal_grids(got, again)
    assert_digest(f"K14 {nx}x{ny} D={depth}",
                  *(x for row in got for x in row))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [4, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k14_cuda_stacks_match_first_body_and_a_second_stream(depth,
                                                               dtype):
    """Two level sets and parity planes of a 2x2 grid on the card: the
    gather bitwise its first body's recorded output, the plain version and
    exchange_halo2d; the same exchange on a second stream bitwise the
    first."""
    dev = cuda_device()
    img = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 256, 384))).to(dtype).to(dev)
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    sets = shard_grid(img.permute(1, 2, 0), grid_sharding(mesh))
    sets = [[b.permute(2, 0, 1) for b in row] for row in sets]
    planes = [[b.reshape(2, 64, 2, 96, 2).permute(0, 2, 4, 1, 3)
               .contiguous() for b in row] for row in sets]
    for tag, xs in (("sets", sets), ("planes", planes)):
        d = min(depth, *xs[0][0].shape[-2:])
        got = exchange_halo2d_rdma(xs, d)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            second = exchange_halo2d_rdma(xs, d)
        torch.cuda.synchronize()
        assert_digest(f"K14 2x2 {tag} D={d} {dtype}",
                      *(x for row in got for x in row))
        assert equal_grids(got, second)
        assert equal_grids(got, trdma.exchange_halo2d_rdma_reference(xs, d))
        assert equal_grids(got, exchange_halo2d(xs, d))


@pytest.mark.cuda
def test_cli_mesh_rdma_on_one_card(tmp_path):
    cuda_device()
    src, out = tmp_path / "img.npy", tmp_path / "mask.npy"
    np.save(src, two_disks(256, 512, noise=6.0)[0].astype(np.float32))
    base = [sys.executable, "-m", "chan_vese_tpu_torch", str(src), "--mesh",
            "2", "2", "--comm-k", "4", "--iters", "40"]
    subprocess.run(base + ["--halo", "rdma", "-o", str(out)], check=True)
    rdma = np.load(out)
    subprocess.run(base + ["-o", str(out)], check=True)
    np.testing.assert_array_equal(rdma, np.load(out))
    assert rdma.shape == (256, 512) and 0 < (rdma > 0).mean() < 1
