"""The port's ring-shift halo exchange (parallel/halo_rdma.py, K14) and
``halo='rdma'`` through the sharded drivers, against the port's plain
exchange and the JAX reference, on grids of CPU devices.

- ``exchange_halo2d_rdma`` is bitwise ``exchange_halo2d`` on 2x4, 1x1
  (self-ring) and 3x3 grids at depths 1, 4 and 8, and on stacks; bitwise
  the reference's ``exchange_halo2d_rdma(interpret=True)`` under
  ``shard_map`` on the 2x4 mesh.
- ``_ring_shift_reference`` equals the reference's ring kernel on the
  single-axis 8-device mesh (the deepest check interpret mode allows).
- K14's task table: the tasks ``_ring_shift`` builds, carried out on the
  CPU by a copy that follows csrc/halo_ring.cu's contract (row copies,
  zero-stride replicas), give ``exchange_halo2d`` bitwise, with one
  launch a stage (two where a device holds more than 16 shards).
- ``halo='rdma'`` end to end: bitwise the port's ``halo='ppermute'``, and
  within 1e-10 of the reference's ``halo='rdma'`` (same masks and
  iteration counts), for ``segment_sharded`` (per iteration and comm_k 2,
  plain route and kernels' plain versions), its trace, and
  ``segment_multiphase_sharded`` (M = 2 and 3, the kernel route, the
  trace).
- ``cuda``-marked: K14 on the card bitwise its plain version and
  ``exchange_halo2d``, and the CLI's ``--mesh 2 2 --halo rdma`` on one
  card.
"""

import contextlib
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
from torch_port_helpers import (assert_rel, cuda_device, params, to_np,
                                to_torch)

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


class _Stream:
    cuda_stream = 0


class _RingCopies:
    """csrc/halo_ring.cu's contract carried out on CPU memory: each task
    copies rows x cols elements of each slice, row by row; src_row 0
    repeats source row 0, src_col 0 repeats each row's first element."""

    def __init__(self):
        self.launches = []

    def cv_halo_ring(self, addr, n, esize, stream):
        assert 1 <= n <= trdma._MAX_TASKS and esize in (4, 8)
        self.launches.append(n)
        for t in (trdma._Task * n).from_address(addr):
            for b in range(t.batch):
                for r in range(t.rows):
                    src = t.src + (b * t.src_batch + r * t.src_row) * esize
                    dst = t.dst + (b * t.dst_batch + r * t.dst_row) * esize
                    if t.src_col:
                        ctypes.memmove(dst, src, t.cols * esize)
                    else:
                        for c in range(t.cols):
                            ctypes.memmove(dst + c * esize, src, esize)
        return 0


@pytest.mark.parametrize("nx,ny,depth", [(2, 4, 4), (1, 1, 3), (3, 3, 2),
                                         (4, 5, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ring_tasks_build_the_exchange(monkeypatch, nx, ny, depth, dtype):
    """The tasks _ring_shift hands K14, carried out by _RingCopies: every
    padded block bitwise exchange_halo2d's, a stack too, one launch a
    stage (a 4x5 grid's 60 tasks a stage take two launches)."""
    lib = _RingCopies()
    monkeypatch.setattr(tbuild, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    img = np.random.default_rng(nx * ny).standard_normal((12 * nx, 10 * ny))
    blocks = shard_grid(to_torch(img).to(dtype),
                        grid_sharding(cpu_grid(nx, ny)))
    n0 = exchange_halo2d_rdma.launches
    got = trdma._ring_shift(trdma._ring_shift(blocks, depth, -2), depth, -1)
    assert equal_grids(got, exchange_halo2d(blocks, depth))
    per_stage = -(-3 * nx * ny // trdma._MAX_TASKS)
    assert exchange_halo2d_rdma.launches - n0 == 2 * per_stage
    assert lib.launches == [min(3 * nx * ny - i * trdma._MAX_TASKS,
                                trdma._MAX_TASKS)
                            for i in range(per_stage)] * 2
    stack = [[torch.stack([b, 1 - b]) for b in row] for row in blocks]
    got = trdma._ring_shift(trdma._ring_shift(stack, depth, -2), depth, -1)
    assert equal_grids(got, exchange_halo2d(stack, depth))


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
    assert exchange_halo2d_rdma.launches - n0 == 4
    assert equal_grids(got, trdma.exchange_halo2d_rdma_reference(blocks,
                                                                 depth))
    assert equal_grids(got, exchange_halo2d(blocks, depth))
    assert equal_grids(got, again)


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
