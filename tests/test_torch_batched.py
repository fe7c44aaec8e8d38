"""Frame stacks in the port (K1's batch mode, models/batched.py,
parallel/) against the JAX reference.

- The plain K1 batch iteration against ``pallas_sweep.
  fused_iteration_batch(interpret=True)``: f64 at 1e-10, f32 at
  tests/test_torch_resident.py's first-iteration bar, partials per frame.
- ``segment_stack_fused_fixed``: one batch call per iteration (not per
  frame), against the reference's in f64 (1e-10, identical masks) and f32
  (identical masks).
- ``segment_batch`` against the reference's on frames that stop at
  different iterations: per-frame iters, delta, c1, c2 and phi.
- ``segment_stack_sharded`` on a 4-device CPU data mesh: the routes, the
  results against the local drivers and the reference's sharded driver,
  tolerance mode, the indivisible batch, the K1 batch route off the
  resident envelope.
- ``cuda``-marked twins hold K1's batch mode against its plain version
  and against single-image launches on the card (skipped without a GPU).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.models import batched as jbatched
from chan_vese_tpu.ops import pallas_sweep
from chan_vese_tpu.ops.reductions import region_means as j_region_means
from chan_vese_tpu.parallel import data_parallel as jdp
from chan_vese_tpu.parallel import mesh as jmesh
from chan_vese_tpu.utils.init_phi import init_phi as j_init_phi
from chan_vese_tpu_torch.models import batched as tbatched
from chan_vese_tpu_torch.ops import fused_kernel, resident_kernel
from chan_vese_tpu_torch.parallel import data_parallel as tdp
from chan_vese_tpu_torch.parallel import make_data_mesh
from fixtures import colored_squares, iou, two_disks
from torch_port_helpers import assert_rel, cuda_device, params, to_np, \
    to_torch

F32 = np.float32
FIRST = dict(rtol=1e-6, atol=1e-5)
SHAPE = (64, 128)
CPU4 = [torch.device("cpu")] * 4


def _stack(n=3, shape=SHAPE, noises=(4.0, 8.0, 12.0), dtype=np.float64):
    """Two-disks frames, each with its own noise level and seed (so the
    frames converge at different iterations), and their truths."""
    frames = [two_disks(*shape, noise=noises[k % len(noises)], seed=k)
              for k in range(n)]
    return (np.stack([f for f, _ in frames]).astype(dtype),
            [g for _, g in frames])


def _batch_inputs(dtype):
    """(phis, u0s, c1s, c2s) numpy: three frames from the checkerboard
    start, each with its own region means."""
    u0s, _ = _stack(dtype=dtype)
    phi = np.asarray(j_init_phi(SHAPE, "checkerboard", jnp.float64))
    phis = np.stack([phi, phi[::-1], -phi]).astype(dtype)
    cs = [j_region_means(jnp.asarray(u), jnp.asarray(ph), 1.0)
          for u, ph in zip(u0s, phis)]
    c1s = np.array([float(c[0]) for c in cs], dtype)
    c2s = np.array([float(c[1]) for c in cs], dtype)
    return phis, u0s, c1s, c2s


def _min_iou(masks, gts):
    """The worst frame's IoU with its truth, up to the swap of the two
    phases (from the checkerboard start the data pick the phi >= 0 side)."""
    return min(max(iou(m, g), iou(~m, g)) for m, g in zip(to_np(masks), gts))


class Spy:
    """Counts the calls of a module attribute while delegating to it."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def spy(*args, **kw):
            self.calls += 1
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, spy)


# K1's batch mode ---------------------------------------------------------

def test_plain_batch_iteration_f64_matches_pallas():
    phis, u0s, c1s, c2s = _batch_inputs(np.float64)
    pj, pt = params()
    want, wparts = pallas_sweep.fused_iteration_batch(
        *(jnp.asarray(a) for a in (phis, u0s, c1s, c2s)), pj, interpret=True)
    got, parts = fused_kernel.fused_iteration_batch(
        *(to_torch(a) for a in (phis, u0s, c1s, c2s)), pt)
    assert tuple(got.shape) == (3, *SHAPE) and tuple(parts.shape) == (3, 8)
    assert_rel(got, want, 1e-10)
    # s_uH and s_H sum the reference's Heaviside, whose Cephes atan is only
    # f32-accurate (measured here: 1.7e-10 relative); the other slots 1e-10
    wparts = np.asarray(wparts)
    for n in range(3):
        assert_rel(parts[n, :2], wparts[n, :2], 1e-8)
        assert_rel(parts[n, 2:], wparts[n, 2:], 1e-10)
    # each frame is the single-image iteration on that frame
    for n in range(3):
        one, oparts = fused_kernel.fused_iteration(
            to_torch(phis[n]), to_torch(u0s[n]), to_torch(c1s[n]),
            to_torch(c2s[n]), pt)
        torch.testing.assert_close(got[n], one, rtol=0, atol=0)
        torch.testing.assert_close(parts[n], oparts, rtol=0, atol=0)


def test_plain_batch_iteration_f32_matches_pallas():
    """The reference sums its band partials in f32, the port in f64
    (measured here: s_uH and s_H within 1.1e-7 relative, flips equal)."""
    phis, u0s, c1s, c2s = _batch_inputs(F32)
    pj, pt = params()
    want, wparts = pallas_sweep.fused_iteration_batch(
        *(jnp.asarray(a) for a in (phis, u0s, c1s, c2s)), pj, interpret=True)
    got, parts = fused_kernel.fused_iteration_batch(
        *(to_torch(a, F32) for a in (phis, u0s, c1s, c2s)), pt)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **FIRST)
    np.testing.assert_allclose(to_np(parts), np.asarray(wparts), rtol=1e-5,
                               atol=0)


def test_batch_iteration_validates_arguments():
    _, pt = params()
    z = torch.zeros(2, *SHAPE)
    c = torch.zeros(2)
    with pytest.raises(ValueError, match="unsupported"):
        fused_kernel.fused_iteration_batch(torch.zeros(2, 64, 100),
                                           torch.zeros(2, 64, 100), c, c, pt)
    with pytest.raises(ValueError, match="N, H, W"):
        fused_kernel.fused_iteration_batch(z[0], z[0], c, c, pt)
    with pytest.raises(ValueError, match="N, H, W"):
        fused_kernel.fused_iteration_batch(z, z[:1], c, c, pt)
    with pytest.raises(ValueError, match=r"\(2,\)"):
        fused_kernel.fused_iteration_batch(z, z, torch.zeros(3), c, pt)


# the fused stack driver ----------------------------------------------------

def test_stack_fused_driver_one_batch_call_per_iteration(monkeypatch):
    u0s, _ = _stack(dtype=F32)
    _, pt = params(init="circle")
    spy = Spy(monkeypatch, fused_kernel, "fused_iteration_batch")
    single = Spy(monkeypatch, fused_kernel, "fused_iteration")
    tbatched.segment_stack_fused_fixed(to_torch(u0s, F32), pt, iters=7)
    assert spy.calls == 7 and single.calls == 0


def _rel(a, b):
    a, b = to_np(a).astype(np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_stack_fused_driver_f64_matches_reference():
    """3 frames from the checkerboard start in f64. One iteration equals
    the reference's fused stack driver to 1e-10 (measured 1.2e-14). Over
    20 the reference's kernel, whose Heaviside takes a Cephes atan accurate
    to f32, feeds means off by ~1e-10 relative and drifts from its own jnp
    stack loop (measured 6.9e-5 of phi's scale): the port is held to that
    jnp loop at 1e-8 (measured 8.3e-10), to the fused driver within twice
    the reference's own gap, and to identical masks."""
    u0s, gts = _stack()
    pj, pt = params()
    for iters in (1, 20):
        want, wmask = jbatched.segment_stack_fused_fixed(
            jnp.asarray(u0s), pj, iters=iters, interpret=True)
        got, mask = tbatched.segment_stack_fused_fixed(to_torch(u0s), pt,
                                                       iters=iters)
        np.testing.assert_array_equal(to_np(mask), np.asarray(wmask))
    jnp_loop, _ = jbatched.segment_stack_fixed(jnp.asarray(u0s), pj,
                                               iters=20)
    assert _rel(got, jnp_loop) <= 1e-8
    assert _rel(got, want) <= 2 * _rel(want, jnp_loop)
    assert _min_iou(mask, gts) > 0.95
    one, _ = tbatched.segment_stack_fused_fixed(to_torch(u0s), pt, iters=1)
    want1, _ = jbatched.segment_stack_fused_fixed(jnp.asarray(u0s), pj,
                                                  iters=1, interpret=True)
    assert_rel(one, want1, 1e-10)


def test_stack_fused_driver_f32_matches_reference():
    u0s, gts = _stack(dtype=F32)
    pj, pt = params()
    want, wmask = jbatched.segment_stack_fused_fixed(
        jnp.asarray(u0s), pj, iters=20, interpret=True)
    got, mask = tbatched.segment_stack_fused_fixed(to_torch(u0s, F32), pt,
                                                   iters=20)
    np.testing.assert_array_equal(to_np(mask), np.asarray(wmask))
    assert _min_iou(mask, gts) > 0.95


def test_stack_fused_driver_fallbacks_match_plain_stack():
    """Off the fused envelope and for another sweep order the plain stack
    loop runs, as in the reference."""
    u0s, _ = _stack(shape=(24, 100))
    _, pt = params(init="circle")
    got, _ = tbatched.segment_stack_fused_fixed(to_torch(u0s), pt, iters=4)
    want, _ = tbatched.segment_stack_fixed(to_torch(u0s), pt, iters=4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    _, pj = params(init="circle", order="jacobi")
    got, _ = tbatched.segment_stack_fused_fixed(to_torch(u0s), pj, iters=4)
    want, _ = tbatched.segment_stack_fixed(to_torch(u0s), pj, iters=4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# tolerance mode --------------------------------------------------------------

def _check_batch_result(got, want, n):
    """Per-frame fields at the bar of test_torch_scalar.py's f64 tolerance
    run of ``segment`` (1e-7; reduction-order ulps grow over the run:
    measured 4.1e-8 of phi's scale here), identical masks and counts."""
    np.testing.assert_array_equal(to_np(got.iters), np.asarray(want.iters))
    assert tuple(got.iters.shape) == (n,) and got.iters.dtype == torch.int64
    for field in ("phi", "delta", "c1", "c2"):
        assert_rel(getattr(got, field), getattr(want, field), 1e-7)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))


def test_segment_batch_matches_reference():
    """Frames that stop at different iterations (13, 12 and 17 here): under
    vmap the reference's while loop keeps a finished frame's carry, so
    every frame equals its own run, as the port's per-frame loop gives."""
    u0s, gts = _stack(shape=(32, 64))
    pj, pt = params()
    want = jbatched.segment_batch(jnp.asarray(u0s), pj)
    got = tbatched.segment_batch(to_torch(u0s), pt)
    assert len(set(np.asarray(want.iters).tolist())) == 3
    _check_batch_result(got, want, 3)
    for n in range(3):
        one = tbatched.segment(to_torch(u0s[n]), pt)
        assert one.iters == int(got.iters[n])
        torch.testing.assert_close(got.phi[n], one.phi, rtol=0, atol=0)
    assert _min_iou(got.mask, gts) > 0.95


def test_segment_batch_rgb_matches_reference():
    """(N, H, W, 3) frames with equal per-channel lambda (the conditioned
    case of tests/test_torch_vector.py): per-channel c1, c2 per frame."""
    frames = [colored_squares(32, 64, noise=8.0, seed=s)[0] for s in (3, 4)]
    u0s = np.stack(frames).astype(np.float64)
    pj, pt = params(init="circle", max_iter=60)
    lam = (1.0, 1.0, 1.0)
    want = jbatched.segment_batch(jnp.asarray(u0s), pj, lambda1=lam,
                                  lambda2=lam)
    got = tbatched.segment_batch(to_torch(u0s), pt, lambda1=lam,
                                 lambda2=lam)
    assert tuple(got.c1.shape) == (2, 3)
    _check_batch_result(got, want, 2)


def test_segment_batch_start_and_reinit():
    u0s, _ = _stack(n=2, shape=(32, 64))
    _, pt = params()
    phi0 = to_torch(np.stack([np.asarray(j_init_phi((32, 64), "circle",
                                                    jnp.float64))] * 2))
    got = tbatched.segment_batch(to_torch(u0s), pt, phi0=phi0)
    one = tbatched.segment(to_torch(u0s[1]), pt, phi0[1])
    torch.testing.assert_close(got.phi[1], one.phi, rtol=0, atol=0)
    # a reinit cadence (M10, once unported): every frame redistanced on
    # its own cadence, in the tolerance driver, the plain stack loop and
    # K1's batch route (its plain version; the reference in interpret
    # mode), each against the reference in f64
    pj, pt = params(init="circle", reinit_every=3, reinit_steps=5,
                    max_iter=40)
    want = jbatched.segment_batch(jnp.asarray(u0s), pj)
    got = tbatched.segment_batch(to_torch(u0s), pt)
    np.testing.assert_array_equal(to_np(got.iters), np.asarray(want.iters))
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    assert_rel(got.phi, want.phi, 1e-10)
    for fused in (False, True):
        u = u0s if fused else u0s[..., :48]
        run = (functools.partial(jbatched.segment_stack_fused_fixed,
                                 interpret=True) if fused
               else jbatched.segment_stack_fixed)
        want = run(jnp.asarray(u), pj, iters=7)
        got = (tbatched.segment_stack_fused_fixed if fused
               else tbatched.segment_stack_fixed)(to_torch(u), pt, iters=7)
        np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
        assert_rel(got[0], want[0], 1e-10)


# the data mesh ----------------------------------------------------------------

def test_make_data_mesh():
    mesh = make_data_mesh(devices=CPU4)
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 4}
    assert mesh.devices == tuple(CPU4)
    assert make_data_mesh(2, devices=CPU4).shape == {"data": 2}
    with pytest.raises(ValueError, match="devices"):
        make_data_mesh(5, devices=CPU4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="devices"):
            make_data_mesh()


def test_shard_stack_splits_and_raises():
    mesh = make_data_mesh(4, devices=CPU4)
    u = torch.arange(8 * 6, dtype=torch.float64).reshape(8, 2, 3)
    shards = tdp.shard_stack(u, mesh)
    assert len(shards) == 4
    torch.testing.assert_close(torch.cat(shards), u, rtol=0, atol=0)
    with pytest.raises(ValueError, match="divisible"):
        tdp.shard_stack(torch.zeros(7, 16, 16), mesh)
    with pytest.raises(ValueError, match="mesh"):
        tdp.segment_stack_sharded(u, params()[1])


@pytest.mark.parametrize("use_pallas", [True, False])
def test_sharded_fixed_matches_local_and_reference(monkeypatch, use_pallas):
    """8 frames over 4 CPU devices, 20 iterations from the checkerboard
    start in f64: equal to the local plain stack loop (the resident
    kernels' plain versions recompute the means every iteration, as it
    does), within 1e-8 of the reference's sharded jnp route on its 4-device
    data mesh (the port's plain drivers against the reference's, as
    test_stack_fused_driver_f64_matches_reference), and with the masks of
    the reference's sharded route of the same ``use_pallas``."""
    u0s, gts = _stack(n=8)
    pj, pt = params()
    resident = Spy(monkeypatch, resident_kernel, "resident_iterations_batch")
    mesh = make_data_mesh(4, devices=CPU4)
    got, mask = tdp.segment_stack_sharded(to_torch(u0s), pt, mesh, iters=20,
                                          use_pallas=use_pallas)
    assert resident.calls == (4 if use_pallas else 0)
    assert got.device == mesh.devices[0] and tuple(got.shape) == u0s.shape
    local, _ = tbatched.segment_stack_fixed(to_torch(u0s), pt, iters=20)
    assert_rel(got, local, 1e-12)
    jmesh4 = jmesh.make_data_mesh(4)
    want, _ = jdp.segment_stack_sharded(jnp.asarray(u0s), pj, jmesh4,
                                        iters=20, use_pallas=False)
    assert_rel(got, want, 1e-8)
    _, wmask = jdp.segment_stack_sharded(jnp.asarray(u0s), pj, jmesh4,
                                         iters=20, use_pallas=use_pallas,
                                         interpret=True)
    np.testing.assert_array_equal(to_np(mask), np.asarray(wmask))
    assert _min_iou(mask, gts) > 0.95


def test_sharded_auto_route_on_cpu_is_plain(monkeypatch):
    """use_pallas=None on CPU devices takes the plain stack loop, as the
    reference does off the TPU."""
    u0s, _ = _stack(n=4)
    _, pt = params()
    resident = Spy(monkeypatch, resident_kernel, "resident_iterations_batch")
    plain = Spy(monkeypatch, tdp, "segment_stack_fixed")
    tdp.segment_stack_sharded(to_torch(u0s), pt,
                              make_data_mesh(2, devices=CPU4), iters=3)
    assert resident.calls == 0 and plain.calls == 2


def test_sharded_tolerance_mode_per_frame():
    u0s, _ = _stack(n=4, shape=(32, 64))
    pj, pt = params()
    res = tdp.segment_stack_sharded(to_torch(u0s), pt,
                                    make_data_mesh(4, devices=CPU4))
    assert tuple(res.iters.shape) == (4,)
    want = jbatched.segment_batch(jnp.asarray(u0s), pj)
    _check_batch_result(res, want, 4)


def test_sharded_off_resident_envelope_runs_k1_batch(monkeypatch):
    """A stack the resident kernels do not take (the predicate patched
    off, as a frame above ~1.4 Mpx would be) reaches
    segment_stack_fused_fixed and one K1 batch call per iteration on each
    shard."""
    u0s, gts = _stack(n=4, dtype=F32)
    _, pt = params()
    monkeypatch.setattr(resident_kernel, "supports_resident",
                        lambda h, w: False)
    fused = Spy(monkeypatch, tbatched, "segment_stack_fused_fixed")
    batch = Spy(monkeypatch, fused_kernel, "fused_iteration_batch")
    phis, mask = tdp.segment_stack_sharded(
        to_torch(u0s, F32), pt, make_data_mesh(2, devices=CPU4), iters=20,
        use_pallas=True)
    assert fused.calls == 2 and batch.calls == 2 * 20
    want, _ = tbatched.segment_stack_fused_fixed(to_torch(u0s, F32), pt,
                                                 iters=20)
    torch.testing.assert_close(phis, want, rtol=0, atol=0)
    assert _min_iou(mask, gts) > 0.95


# on the card ------------------------------------------------------------------

@pytest.mark.cuda
def test_batch_iteration_cuda_matches_plain_and_single_launches():
    dev = cuda_device()
    _, pt = params()
    phis, u0s, c1s, c2s = (to_torch(a, F32).to(dev)
                           for a in _batch_inputs(F32))
    n0 = fused_kernel.fused_iteration_batch.launches
    got, parts = fused_kernel.fused_iteration_batch(phis, u0s, c1s, c2s, pt)
    want, wparts = fused_kernel.fused_iteration_batch_reference(
        phis, u0s, c1s, c2s, pt)
    torch.cuda.synchronize()
    assert fused_kernel.fused_iteration_batch.launches == n0 + 1
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(parts), to_np(wparts), rtol=1e-4,
                               atol=16.0)
    for n in range(3):
        one, oparts = fused_kernel.fused_iteration(
            phis[n].contiguous(), u0s[n].contiguous(), c1s[n], c2s[n], pt)
        torch.cuda.synchronize()
        assert torch.equal(got[n], one) and torch.equal(parts[n], oparts)


@pytest.mark.cuda
def test_stack_fused_driver_cuda_launches_once_per_iteration():
    dev = cuda_device()
    u0s, gts = _stack(dtype=F32)
    _, pt = params(init="circle")
    u = to_torch(u0s, F32).to(dev)
    n0 = fused_kernel.fused_iteration_batch.launches
    s0 = fused_kernel.fused_iteration.launches
    got, mask = tbatched.segment_stack_fused_fixed(u, pt, iters=20)
    torch.cuda.synchronize()
    assert fused_kernel.fused_iteration_batch.launches == n0 + 20
    assert fused_kernel.fused_iteration.launches == s0
    ref, rmask = tbatched.segment_stack_fused_fixed(u.cpu(), pt, iters=20)
    assert iou(to_np(mask), to_np(rmask)) > 0.999
