"""The port's sharded two-phase solver (parallel/mesh.py, halo.py,
sharded.py) against the JAX reference and against the port's unsharded
drivers, on grids of CPU devices (one process drives every shard).

- ``make_grid_mesh``: too few devices raise; a device may repeat.
- Halo exchange on 2x2, 2x4 and 3x3 grids equals the edge-padded image
  cut per shard, at depths 4 and 8; the batched exchange likewise on a
  stack of parity planes.
- ``_make_phi0`` equals the reference's start bitwise in f64.
- The plain route in f64 against the reference's jnp route
  (``segment_sharded(use_pallas=False)`` on the fake 2x4 CPU mesh), gray
  and RGB, comm_k 1 and 4 with a remainder chunk, fixed and tolerance
  mode: phi within 1e-10 of its scale, masks identical, c1/c2 within
  1e-10, iteration counts equal.
- The kernel route (plain versions) against the port's unsharded drivers:
  ``segment_banded_fixed`` at the same k within 1e-9, ``segment_fixed``
  at comm_k = 1 within 1e-10, packed equal to flat.
- ``segment_sharded_fixed_trace`` against the reference's trace.
- The 1x1 delegation, the argument errors and the CLI's ``--mesh``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu import cli as jcli
from chan_vese_tpu.parallel import mesh as jmesh
from chan_vese_tpu.parallel import sharded as jsharded
from chan_vese_tpu_torch import cli as tcli
from chan_vese_tpu_torch.models import fused as tfused
from chan_vese_tpu_torch.models.banded import segment_banded_fixed
from chan_vese_tpu_torch.models.scalar import segment_fixed
from chan_vese_tpu_torch.ops.reductions import region_means
from chan_vese_tpu_torch.parallel import (exchange_halo2d,
                                          exchange_halo2d_batched,
                                          gather_grid, grid_sharding,
                                          make_data_mesh, make_grid_mesh,
                                          make_hybrid_mesh, segment_sharded,
                                          segment_sharded_fixed_trace,
                                          shard_grid)
from chan_vese_tpu_torch.parallel import sharded as tsharded
from chan_vese_tpu_torch.utils.init_phi import init_phi
from fixtures import colored_squares, two_disks
from torch_port_helpers import assert_rel, params, to_np, to_torch

CPU = torch.device("cpu")


def cpu_grid(nx, ny):
    return make_grid_mesh(nx, ny, [CPU] * (nx * ny))


@pytest.fixture(scope="module")
def jgrid():
    return jmesh.make_grid_mesh(2, 4)


# meshes and halos -----------------------------------------------------------

def test_make_grid_mesh_and_hybrid():
    mesh = make_grid_mesh(2, 3, [CPU] * 7)
    assert mesh.shape == {"x": 2, "y": 3} and mesh.axis_names == ("x", "y")
    assert mesh.devices == (CPU,) * 6 and mesh.device(1, 2) == CPU
    with pytest.raises(ValueError, match="needs 6 devices"):
        make_grid_mesh(2, 3, [CPU] * 5)
    hyb = make_hybrid_mesh(2, 1, 2, [CPU] * 4)
    assert hyb.shape == {"data": 2, "x": 1, "y": 2}
    with pytest.raises(ValueError, match="needs 8"):
        make_hybrid_mesh(2, 2, 2, [CPU] * 4)
    # the data mesh keeps its axis and devices
    data = make_data_mesh(devices=[CPU] * 3)
    assert data.axis_names == ("data",) and data.shape == {"data": 3}


@pytest.mark.parametrize("nx,ny", [(2, 2), (2, 4), (3, 3)])
@pytest.mark.parametrize("depth", [4, 8])
def test_halo_exchange_equals_edge_padded_image(nx, ny, depth):
    H, W = 8 * nx, 10 * ny
    img = np.random.default_rng(0).standard_normal((H, W))
    mesh = cpu_grid(nx, ny)
    blocks = shard_grid(to_torch(img), grid_sharding(mesh))
    padded = exchange_halo2d(blocks, depth)
    ref = np.pad(img, depth, mode="edge")
    h, w = H // nx, W // ny
    for ix in range(nx):
        for iy in range(ny):
            np.testing.assert_array_equal(
                to_np(padded[ix][iy]),
                ref[ix * h: ix * h + h + 2 * depth,
                    iy * w: iy * w + w + 2 * depth])
    np.testing.assert_array_equal(to_np(gather_grid(blocks, mesh)), img)
    # a stack of four planes exchanges plane by plane
    planes = np.random.default_rng(1).standard_normal((2, 2, H, W))
    pb = [[to_torch(planes[..., ix * h:(ix + 1) * h, iy * w:(iy + 1) * w])
           for iy in range(ny)] for ix in range(nx)]
    out = exchange_halo2d_batched(pb, depth)
    ref = np.pad(planes, ((0, 0), (0, 0), (depth, depth), (depth, depth)),
                 mode="edge")
    for ix in range(nx):
        for iy in range(ny):
            np.testing.assert_array_equal(
                to_np(out[ix][iy]),
                ref[..., ix * h: ix * h + h + 2 * depth,
                    iy * w: iy * w + w + 2 * depth])
    with pytest.raises(ValueError, match="depth"):
        exchange_halo2d(blocks, h + 1)


@pytest.mark.parametrize("kind", ["checkerboard", "circle", "small disk",
                                  "rect"])
def test_make_phi0_bitwise_matches_reference(jgrid, kind):
    want = jsharded._make_phi0((48, 256), kind, jnp.float64, jgrid)
    got = gather_grid(tsharded._make_phi0((48, 256), kind, torch.float64,
                                          cpu_grid(2, 4)), cpu_grid(2, 4))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


# the plain route against the reference's jnp route -------------------------

GRAY = two_disks(48, 256, noise=6.0)[0]
RGB = colored_squares(96, 256, noise=8.0, seed=3)[0]


def _rel(a, b):
    a, b = to_np(a).astype(np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("comm_k", [1, 4])
@pytest.mark.parametrize("fixed", [True, False])
def test_plain_route_f64_matches_reference(jgrid, rgb, comm_k, fixed):
    """Fixed mode (10 iterations: with k = 4 a remainder chunk of 2) and
    tolerance mode on the reference's jnp route, phi at 1e-10 of its
    scale. The gray tolerance run starts from a circle: from the
    checkerboard at the default mu it does not converge within max_iter.
    The RGB tolerance runs (46 and 76 iterations) amplify reduction-order
    ulps: the reference's own 1x1 run lies 4.3e-8 and 1.0e-10 from its 2x4
    run, and the port is held within twice that gap where it is wider (the
    pattern of test_stack_fused_driver_f64_matches_reference)."""
    img = RGB if rgb else GRAY
    pj, pt = params(init="circle" if not (rgb or fixed) else "checkerboard",
                    max_iter=100)
    kw = dict(fixed=fixed, max_iter=10 if fixed else None, comm_k=comm_k,
              use_pallas=False)
    want = jsharded.segment_sharded(jnp.asarray(img), pj, jgrid, **kw)
    got = segment_sharded(to_torch(img), pt, cpu_grid(2, 4), **kw)
    bar = 1e-10
    if rgb and not fixed:
        one = jsharded.segment_sharded(jnp.asarray(img), pj,
                                       jmesh.make_grid_mesh(1, 1), **kw)
        bar = max(bar, 2 * _rel(one.phi, want.phi))
    assert _rel(got.phi, want.phi) <= bar
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    assert_rel(got.c1, want.c1, 1e-10)
    assert_rel(got.c2, want.c2, 1e-10)
    assert got.iters == int(want.iters)
    if not fixed:
        assert got.iters < 100
        assert float(got.delta) == pytest.approx(float(want.delta),
                                                 rel=1e-8, abs=1e-12)


# the kernel route against the port's unsharded drivers ---------------------

@pytest.mark.parametrize("nx,ny", [(2, 4), (3, 3)])
@pytest.mark.parametrize("k,iters", [(2, 8), (4, 10)])
def test_kernel_route_equals_unsharded_banded(nx, ny, k, iters):
    """The plain versions of K2's shard mode on every shard (the 3x3 grid
    has corner, side and centre shards) against the unsharded banded
    driver at the same k (1e-9 in f64, the reference's bar for its own
    kernel route)."""
    # W % 128 keeps the unsharded driver on its banded route
    img = two_disks(24 * nx, 384 if nx == 3 else 256, noise=6.0)[0]
    _, pt = params()
    phi0 = init_phi(img.shape, pt.init, torch.float64)
    got = segment_sharded(to_torch(img), pt, cpu_grid(nx, ny), fixed=True,
                          max_iter=iters, comm_k=k, phi0=phi0,
                          use_pallas=True)
    want, wmask = segment_banded_fixed(to_torch(img), pt, iters=iters, k=k,
                                       phi0=phi0)
    assert_rel(got.phi, want, 1e-9)
    np.testing.assert_array_equal(to_np(got.mask), to_np(wmask))


def test_packed_route_equals_flat_route():
    """K3's shard mode on parity planes (plain versions): the chunk state
    stays on planes, plane halos at half depth; equal to the flat route
    in f64."""
    img = two_disks(64, 128, noise=6.0)[0]
    _, pt = params()
    mesh = cpu_grid(2, 2)
    kw = dict(fixed=True, max_iter=10, comm_k=4, use_pallas=True)
    flat = segment_sharded(to_torch(img), pt, mesh, **kw)
    packed = segment_sharded(to_torch(img), pt, mesh, packed=True, **kw)
    assert_rel(packed.phi, flat.phi, 1e-12)
    np.testing.assert_array_equal(to_np(packed.mask), to_np(flat.mask))


@pytest.mark.parametrize("rgb", [False, True])
def test_per_iteration_route_equals_segment_fixed(rgb):
    """comm_k = 1 through the kernels' plain versions (K1's shard mode for
    a gray image, K5's at k = 1 for RGB) equals the unsharded plain
    segment_fixed on a 3x3 grid within 1e-10 (RGB with per-channel
    lambdas: K5's data term sums its channels in another order)."""
    img = RGB[:72, :192] if rgb else two_disks(72, 192, noise=6.0)[0]
    lam = dict(lambda1=(1.0, 1.2, 0.8), lambda2=(0.9, 1.0, 1.1)) if rgb \
        else {}
    _, pt = params(init="circle")
    got = segment_sharded(to_torch(img), pt, cpu_grid(3, 3), fixed=True,
                          max_iter=6, use_pallas=True, **lam)
    want = segment_fixed(to_torch(img), pt, iters=6, **lam)
    assert_rel(got.phi, want.phi, 1e-10)
    np.testing.assert_array_equal(to_np(got.mask), to_np(want.mask))
    assert_rel(got.c1, region_means(to_torch(img), got.phi, 1.0)[0], 1e-10)


def test_fixed_trace_f64_matches_reference(jgrid):
    pj, pt = params(init="circle")
    want = jsharded.segment_sharded_fixed_trace(jnp.asarray(GRAY), pj, jgrid,
                                                iters=5, use_pallas=False)
    mesh = cpu_grid(2, 4)
    for use_pallas in (False, True):
        got = segment_sharded_fixed_trace(to_torch(GRAY), pt, mesh, iters=5,
                                          use_pallas=use_pallas)
        for field in ("phi", "energy", "delta", "c1", "c2"):
            assert_rel(getattr(got, field), getattr(want, field), 1e-10)
        np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))


# delegation, errors, CLI ----------------------------------------------------

def test_one_by_one_mesh_delegates_to_segment_fused(monkeypatch):
    calls = []
    real = tsharded.segment_fused

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)
    monkeypatch.setattr(tsharded, "segment_fused", spy)
    img = two_disks(64, 128, noise=6.0)[0]
    _, pt = params()
    got = segment_sharded(to_torch(img), pt, cpu_grid(1, 1), fixed=True,
                          max_iter=5, use_pallas=True)
    want = tfused.segment_fused(to_torch(img), pt, fixed=True, max_iter=5)
    assert len(calls) == 1
    torch.testing.assert_close(got.phi, want.phi, rtol=0, atol=0)
    # comm_k > 1 is not delegated: the canvas chunk path runs
    segment_sharded(to_torch(img), pt, cpu_grid(1, 1), fixed=True,
                    max_iter=4, comm_k=2, use_pallas=True)
    assert len(calls) == 1


def test_arguments_raise_where_the_reference_raises(jgrid):
    pj, pt = params()
    u = torch.zeros(48, 96, dtype=torch.float64)
    mesh = cpu_grid(2, 4)
    with pytest.raises(ValueError, match="needs a mesh"):
        segment_sharded(u, pt)
    with pytest.raises(ValueError, match="not divisible"):
        segment_sharded(torch.zeros(49, 96), pt, mesh)
    with pytest.raises(ValueError, match="comm_k=4 needs"):
        segment_sharded(torch.zeros(24, 96), pt, cpu_grid(2, 2), comm_k=4)
    with pytest.raises(ValueError, match="comm_k must"):
        segment_sharded(u, pt, mesh, comm_k=0)
    with pytest.raises(ValueError, match="unknown halo"):
        segment_sharded(u, pt, mesh, halo="nccl")
    with pytest.raises(ValueError, match="packed sharded"):
        segment_sharded(u, pt, mesh, comm_k=2, use_pallas=True, packed=True)
    with pytest.raises(ValueError, match="pallas path unsupported"):
        segment_sharded(torch.zeros(36, 96), pt, cpu_grid(2, 2),
                        use_pallas=True)
    with pytest.raises(ValueError, match="per-channel"):
        segment_sharded(u, pt, mesh, lambda1=(1.0, 2.0))
    # the halo mechanisms of M13d run and equal the reference's
    # (tests/test_torch_halo_rdma.py, test_torch_sharded_overlap.py)
    img = two_disks(48, 96, noise=6.0)[0]
    for halo in ("rdma", "overlap"):
        kw = dict(fixed=True, max_iter=3, use_pallas=False, halo=halo)
        got = segment_sharded(to_torch(img), pt, mesh, **kw)
        want = jsharded.segment_sharded(jnp.asarray(img), pj, jgrid,
                                        interpret=True, **kw)
        assert_rel(got.phi, want.phi, 1e-10)
        got = segment_sharded_fixed_trace(to_torch(img), pt, mesh, iters=2,
                                          use_pallas=False, halo=halo)
        want = jsharded.segment_sharded_fixed_trace(
            jnp.asarray(img), pj, jgrid, iters=2, use_pallas=False,
            interpret=True, halo=halo)
        assert_rel(got.energy, want.energy, 1e-10)
    # a reinit cadence (M10, once unported): each shard redistanced on a
    # reinit_steps-deep halo and the means taken anew, gray (through every
    # halo mechanism) and RGB: six fixed iterations within 1e-10, the
    # tolerance runs' iterations and masks equal; the trace
    pjr, ptr = params(reinit_every=2, reinit_steps=4, init="circle",
                      max_iter=30)
    rgb = colored_squares(48, 96, noise=6.0)[0]
    for x, halo in ((img, "ppermute"), (img, "rdma"), (img, "overlap"),
                    (rgb, "ppermute")):
        for fixed in (True, False):
            kw = dict(use_pallas=False, halo=halo, fixed=fixed,
                      max_iter=6 if fixed else None)
            got = segment_sharded(to_torch(x), ptr, mesh, **kw)
            want = jsharded.segment_sharded(jnp.asarray(x), pjr, jgrid,
                                            interpret=True, **kw)
            assert got.iters == int(want.iters)
            np.testing.assert_array_equal(to_np(got.mask),
                                          np.asarray(want.mask))
            if fixed:
                for name in ("phi", "c1", "c2"):
                    assert_rel(getattr(got, name), getattr(want, name),
                               1e-10)
    got = segment_sharded_fixed_trace(to_torch(img), ptr, mesh, iters=5,
                                      use_pallas=False)
    want = jsharded.segment_sharded_fixed_trace(
        jnp.asarray(img), pjr, jgrid, iters=5, use_pallas=False,
        interpret=True)
    for name in ("phi", "energy", "c1", "c2"):
        assert_rel(getattr(got, name), getattr(want, name), 1e-10)
    with pytest.raises(ValueError, match="exceeds the shard"):
        segment_sharded(torch.zeros(32, 64), pt.replace(reinit_every=5),
                        mesh)
    with pytest.raises(ValueError, match="reinit cadence"):
        segment_sharded(u, pt.replace(reinit_every=5), mesh, comm_k=2)
    with pytest.raises(ValueError, match="pallas path unsupported"):
        segment_sharded_fixed_trace(torch.zeros(48, 96, 3), pt, mesh,
                                    use_pallas=True)


def test_cli_mesh_writes_the_reference_mask(tmp_path):
    img = two_disks(64, 128, noise=6.0)[0]
    src = tmp_path / "img.npy"
    np.save(src, img)
    args = [str(src), "--mesh", "2", "2", "--comm-k", "4", "--iters", "8"]
    assert jcli.main(args + ["-o", str(tmp_path / "j.npy")]) == 0
    assert tcli.main(args + ["-o", str(tmp_path / "t.npy"),
                             "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"),
                                  np.load(tmp_path / "j.npy"))
    # --halo overlap writes the reference CLI's overlap mask; --halo rdma
    # its ppermute mask (the reference CLI runs its ring kernel only on a
    # TPU: on the CPU Pallas takes interpret mode alone, which its CLI does
    # not pass; its own tests hold rdma bitwise equal to ppermute)
    for halo, ref in (("rdma", "j.npy"), ("overlap", "jo.npy")):
        if halo == "overlap":
            assert jcli.main(args + ["--halo", "overlap", "-o",
                                     str(tmp_path / ref)]) == 0
        assert tcli.main(args + ["--halo", halo, "--device", "cpu", "-o",
                                 str(tmp_path / f"t_{halo}.npy")]) == 0
        np.testing.assert_array_equal(np.load(tmp_path / f"t_{halo}.npy"),
                                      np.load(tmp_path / ref))
    # --multiphase, --morph and --morph-gac run sharded
    # (tests/test_torch_sharded_multiphase.py, test_torch_sharded_morph.py);
    # the trace, GIF and checkpoint flags write their artifacts
    # (tests/test_torch_cli_m12.py holds them against the reference's)
    for flag, out in ((["--trace-energy"], "t.csv"),
                      (["--evolution-gif"], "e.gif"),
                      (["--checkpoint-dir"], "ck")):
        assert tcli.main([str(src), "--mesh", "2", "2", "--device", "cpu",
                          "--iters", "2", *flag, str(tmp_path / out)]) == 0
        assert (tmp_path / out).exists()
    assert (tmp_path / "ck" / "ckpt_00000002").is_dir()
