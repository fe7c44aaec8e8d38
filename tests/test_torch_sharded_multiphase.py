"""The port's sharded multiphase solver (``segment_multiphase_sharded``,
``segment_multiphase_sharded_fixed_trace`` in parallel/sharded.py) against
the JAX reference on a 2x4 grid of CPU devices (the reference on the
conftest's eight fake CPU devices; one process drives the port's shards).

- The plain route in f64 against the reference's jnp route
  (``use_pallas=False``): gray, RGB and M = 3, fixed mode at comm_k 1 and
  2 (a remainder chunk included) at 1e-10 of phi's scale; tolerance mode
  at comm_k 1 and 2 with equal labels and iteration counts, phi within
  twice the reference's own 2x4-vs-2x2 gap (the trajectory amplifies the
  shards' reduction order: 5.7e-10 and 4.3e-8 of phi's scale there).
- The kernel route (K9's shard mode, its plain version on CPU devices)
  against the reference's kernel route in interpret mode at comm_k 1 and
  2, at the K9 bars of tests/test_torch_kernels_mp2.py (f64: the
  reference's Heaviside takes a Cephes atan accurate to f32), and at 1e-9
  against the port's unsharded K9 loop of the same trajectory class
  (carried means; frozen per chunk at comm_k 2).
- The trace against the reference's trace; the argument errors, and the
  CLI's ``--mesh`` with ``--multiphase``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu import cli as jcli
from chan_vese_tpu.models import multiphase as jmp
from chan_vese_tpu.parallel import mesh as jmesh
from chan_vese_tpu.parallel import sharded as jsharded
from chan_vese_tpu_torch import cli as tcli
from chan_vese_tpu_torch.models import multiphase as tmp
from chan_vese_tpu_torch.ops import multiphase_kernel
from chan_vese_tpu_torch.parallel import (
    make_grid_mesh, segment_multiphase_sharded,
    segment_multiphase_sharded_fixed_trace)
from chan_vese_tpu_torch.parallel import sharded as tsharded
from fixtures import four_regions
from torch_port_helpers import (assert_rel, cuda_device, params, to_np,
                                to_torch)

CPU = torch.device("cpu")
MU = 0.003 * 255.0 ** 2
BANDED = dict(rtol=2e-5, atol=2e-3)  # test_torch_kernels_mp2.py's K9 bars
# twice the reference's own 2x4-vs-2x2 gap of the tolerance runs
TOL_GAP = {1: 2 * 5.8e-10, 2: 2 * 4.3e-8}


def cpu_grid(nx, ny):
    return make_grid_mesh(nx, ny, [CPU] * (nx * ny))


@pytest.fixture(scope="module")
def jgrid():
    return jmesh.make_grid_mesh(2, 4)


def _rgb(h=64, w=64):
    rng = np.random.default_rng(0)
    colors = np.array([[220.0, 40.0, 40.0], [40.0, 220.0, 40.0],
                       [40.0, 40.0, 220.0], [200.0, 200.0, 200.0]])
    lab = np.zeros((h, w), np.int32)
    lab[:h // 2, w // 2:] = 1
    lab[h // 2:, :w // 2] = 2
    lab[h // 2:, w // 2:] = 3
    return colors[lab] + 3.0 * rng.standard_normal((h, w, 3))


GRAY = four_regions(64, 64, noise=4.0)[0]

FIXED = {  # case: (image, keywords)
    "gray": (GRAY, dict(max_iter=3)),
    "rgb": (_rgb(), dict(max_iter=5)),
    "m3": (GRAY, dict(m_sets=3, max_iter=4)),
    "comm_k 2": (GRAY, dict(max_iter=6, comm_k=2)),
    "comm_k 2 remainder": (GRAY, dict(max_iter=7, comm_k=2)),
}


@pytest.mark.parametrize("case", list(FIXED))
def test_fixed_plain_route_f64_matches_reference(case, jgrid):
    img, kw = FIXED[case]
    pj, pt = params(mu=MU)
    want = jsharded.segment_multiphase_sharded(
        jnp.asarray(img), pj, jgrid, fixed=True, use_pallas=False, **kw)
    got = segment_multiphase_sharded(to_torch(img), pt, cpu_grid(2, 4),
                                     fixed=True, use_pallas=False, **kw)
    assert_rel(got.phis, want.phis, 1e-10)
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))
    assert got.iters == int(want.iters) == kw["max_iter"]
    assert_rel(got.delta, want.delta, 1e-10)
    assert_rel(got.cs, want.cs, 1e-10)


@pytest.mark.parametrize("comm_k", [1, 2])
def test_tolerance_plain_route_f64_matches_reference(comm_k, jgrid):
    pj, pt = params(mu=MU, max_iter=200)
    want = jsharded.segment_multiphase_sharded(
        jnp.asarray(GRAY), pj, jgrid, use_pallas=False, comm_k=comm_k)
    got = segment_multiphase_sharded(to_torch(GRAY), pt, cpu_grid(2, 4),
                                     use_pallas=False, comm_k=comm_k)
    assert got.iters == int(want.iters) < 200
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))
    assert_rel(got.phis, want.phis, TOL_GAP[comm_k])
    assert float(got.delta) < pt.tol


@pytest.mark.parametrize("comm_k,iters", [(1, 4), (2, 6)])
def test_kernel_route_matches_reference_kernel(comm_k, iters, jgrid):
    """K9's shard mode through the driver (plain version) against the
    reference's kernel route in interpret mode, and against the port's
    unsharded K9 loop of the same class at 1e-9."""
    img = four_regions(64, 256, noise=4.0)[0]
    phis0 = np.asarray(jmp.init_multiphase((64, 256), 2, dtype=jnp.float64))
    pj, pt = params(mu=MU)
    want = jsharded.segment_multiphase_sharded(
        jnp.asarray(img), pj, jgrid, phis0=jnp.asarray(phis0),
        max_iter=iters, fixed=True, comm_k=comm_k, use_pallas=True,
        interpret=True)
    n0 = multiphase_kernel.mp2_iteration_sharded.launches
    got = segment_multiphase_sharded(to_torch(img), pt, cpu_grid(2, 4),
                                     phis0=to_torch(phis0), max_iter=iters,
                                     fixed=True, comm_k=comm_k,
                                     use_pallas=True)
    # CPU tensors run the plain version: nothing is launched
    assert multiphase_kernel.mp2_iteration_sharded.launches == n0
    np.testing.assert_allclose(to_np(got.phis), np.asarray(want.phis),
                               **BANDED)
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))
    # the unsharded K9 loop, the means frozen over each comm_k chunk
    u, phis = to_torch(img), to_torch(phis0)
    cs = torch.stack(tmp.phase_means(u, phis, pt.eps))
    done = 0
    while done < iters:
        for _ in range(min(comm_k, iters - done)):
            phis, parts = multiphase_kernel.mp2_iteration(phis, u, cs, pt)
        cs = parts[0:4] / torch.clamp(parts[4:8], min=1e-30)
        done += comm_k
    assert_rel(got.phis, phis, 1e-9)


def test_kernel_and_plain_routes_agree_in_f32(jgrid):
    """The two routes live in one trajectory class: labels after 20
    iterations agree but for a few cells (the reference's own bar)."""
    pj, pt = params(mu=MU)
    u = to_torch(GRAY, np.float32)
    a = segment_multiphase_sharded(u, pt, cpu_grid(2, 4), max_iter=20,
                                   fixed=True, use_pallas=True)
    b = segment_multiphase_sharded(u, pt, cpu_grid(2, 4), max_iter=20,
                                   fixed=True, use_pallas=False)
    assert int((a.labels != b.labels).sum()) <= 5


@pytest.mark.parametrize("use_pallas", [False, True])
def test_trace_matches_reference(use_pallas, jgrid):
    img = four_regions(64, 256, noise=4.0)[0] if use_pallas else GRAY
    pj, pt = params(mu=MU)
    kw = dict(interpret=True) if use_pallas else {}
    want = jsharded.segment_multiphase_sharded_fixed_trace(
        jnp.asarray(img), pj, jgrid, iters=5, use_pallas=use_pallas, **kw)
    got = segment_multiphase_sharded_fixed_trace(
        to_torch(img), pt, cpu_grid(2, 4), iters=5, use_pallas=use_pallas)
    bar = 1e-6 if use_pallas else 1e-10
    assert_rel(got.energy, want.energy, bar)
    np.testing.assert_allclose(to_np(got.delta), np.asarray(want.delta),
                               atol=1e-12 if not use_pallas else 2e-4)
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))
    # the unsharded trace of the same route
    ref = tmp.segment_multiphase_fixed(to_torch(img), pt, iters=5,
                                       use_pallas=use_pallas)
    assert_rel(got.energy, ref.energy, 1e-9)


def test_arguments_raise_where_the_reference_raises(jgrid):
    pj, pt = params(mu=MU)
    u = torch.zeros(64, 64, dtype=torch.float64)
    mesh = cpu_grid(2, 4)
    with pytest.raises(ValueError, match="needs a mesh"):
        segment_multiphase_sharded(u, pt)
    with pytest.raises(ValueError, match="not divisible"):
        segment_multiphase_sharded(torch.zeros(63, 64), pt, mesh)
    with pytest.raises(ValueError, match="unknown halo"):
        segment_multiphase_sharded(u, pt, mesh, halo="nccl")
    with pytest.raises(ValueError, match="overlap x comm_k"):
        segment_multiphase_sharded(u, pt, mesh, comm_k=2, halo="overlap")
    with pytest.raises(ValueError, match="halo='overlap'"):
        segment_multiphase_sharded(u, pt, mesh, use_pallas=True,
                                   halo="overlap")
    with pytest.raises(ValueError, match="comm_k must"):
        segment_multiphase_sharded(u, pt, mesh, comm_k=0)
    with pytest.raises(ValueError, match="8\\*comm_k"):
        segment_multiphase_sharded(u, pt, mesh, comm_k=8)
    with pytest.raises(ValueError, match="reinit cadence"):
        segment_multiphase_sharded(u, pt.replace(reinit_every=5), mesh,
                                   comm_k=2)
    with pytest.raises(ValueError, match="pallas path unsupported"):
        segment_multiphase_sharded(u, pt, mesh, m_sets=3, use_pallas=True)
    with pytest.raises(ValueError, match="pallas path unsupported"):
        segment_multiphase_sharded_fixed_trace(torch.zeros(64, 64, 3), pt,
                                               mesh, use_pallas=True)
    # the halo mechanisms of M13d run and equal the reference's
    # (tests/test_torch_halo_rdma.py, test_torch_sharded_overlap.py)
    img = GRAY[:, :64]
    for halo in ("rdma", "overlap"):
        got = segment_multiphase_sharded(to_torch(img), pt, mesh, halo=halo,
                                         fixed=True, max_iter=2)
        want = jsharded.segment_multiphase_sharded(
            jnp.asarray(img), pj, jgrid, halo=halo, fixed=True, max_iter=2,
            interpret=True)
        assert_rel(got.phis, want.phis, 1e-10)
        got = segment_multiphase_sharded_fixed_trace(to_torch(img), pt, mesh,
                                                     iters=2, halo=halo)
        want = jsharded.segment_multiphase_sharded_fixed_trace(
            jnp.asarray(img), pj, jgrid, iters=2, halo=halo, interpret=True)
        assert_rel(got.energy, want.energy, 1e-10)
    # a reinit cadence (M10, once unported): every level set of each shard
    # redistanced on a reinit_steps-deep halo, the plain route (tolerance
    # mode and the trace, the energy before the redistance)
    pjr, ptr = params(mu=MU, reinit_every=2, reinit_steps=4, max_iter=20)
    assert not tsharded._mp_pallas_ok(ptr, to_torch(img), 2, 4, 2)
    for fixed in (True, False):
        kw = dict(fixed=fixed, max_iter=6 if fixed else None)
        got = segment_multiphase_sharded(to_torch(img), ptr, mesh, **kw)
        want = jsharded.segment_multiphase_sharded(
            jnp.asarray(img), pjr, jgrid, interpret=True, **kw)
        assert got.iters == int(want.iters)
        np.testing.assert_array_equal(to_np(got.labels),
                                      np.asarray(want.labels))
        if fixed:
            assert_rel(got.phis, want.phis, 1e-10)
    got = segment_multiphase_sharded_fixed_trace(to_torch(img), ptr, mesh,
                                                 iters=5)
    want = jsharded.segment_multiphase_sharded_fixed_trace(
        jnp.asarray(img), pjr, jgrid, iters=5, interpret=True)
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))
    assert_rel(got.phis, want.phis, 1e-10)
    assert_rel(got.energy, want.energy, 1e-10)


@pytest.mark.parametrize("extra", [["--max-iter", "60"],
                                   ["--iters", "6", "--comm-k", "2"]])
def test_cli_mesh_multiphase_writes_the_reference_labels(extra, tmp_path):
    """Both CLIs in float32:
    the label maps agree but for 1e-3 of the cells (chip_smoke.py's
    LABELS_FRAC for f32 multiphase runs)."""
    src = tmp_path / "img.npy"
    np.save(src, four_regions(64, 128, noise=4.0)[0])
    args = [str(src), "--mesh", "2", "2", "--multiphase", "2", "--mu",
            "195"] + extra
    assert jcli.main(args + ["--quiet", "-o", str(tmp_path / "j.npy")]) == 0
    assert tcli.main(args + ["-o", str(tmp_path / "t.npy"), "--device",
                             "cpu"]) == 0
    got, want = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got != want).mean() <= 1e-3


@pytest.mark.cuda
def test_sharded_multiphase_cuda_matches_cpu():
    """On the card (a 2x2 grid on cuda:0) the kernel route launches K9's
    shard mode once an iteration per shard and lands within the f32 label
    bar of the same run on CPU devices."""
    dev = cuda_device()
    img = four_regions(128, 512, noise=4.0)[0]
    _, pt = params(mu=MU)
    u = to_torch(img, np.float32)
    n0 = multiphase_kernel.mp2_iteration_sharded.launches
    got = segment_multiphase_sharded(u.to(dev), pt,
                                     make_grid_mesh(2, 2, [dev] * 4),
                                     max_iter=10, fixed=True)
    assert multiphase_kernel.mp2_iteration_sharded.launches == n0 + 40
    ref = segment_multiphase_sharded(u, pt, cpu_grid(2, 2), max_iter=10,
                                     fixed=True, use_pallas=True)
    assert float((got.labels.cpu() != ref.labels).double().mean()) <= 1e-3
