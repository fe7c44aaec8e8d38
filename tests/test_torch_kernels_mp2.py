"""The 4-phase kernels of the port (K9 banded and resident in
ops/multiphase_kernel.py, K10 in ops/packed_kernel.py) and K1's force mode
(``fused_sweep``) against the JAX kernels in interpret mode.

On the CPU each wrapper runs its plain version; those are held in f32 at
the bars of the JAX package's own kernel tests
(tests/test_multiphase_mp2.py, tests/test_multiphase_pallas.py): one
iteration elementwise, the labels over 25 iterations (the coupling term
amplifies last-ulp differences about 100x per iteration near phi = 0, so
longer runs are compared by label). ``cuda``-marked twins hold each kernel
against its plain version on the card, and K9's band body against its
first body (skipped without a GPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.models import multiphase as jmp
from chan_vese_tpu.ops import pallas_multiphase, pallas_packed, pallas_sweep
from chan_vese_tpu.ops import sweep as jsweep
from chan_vese_tpu_torch.models import multiphase as tmp
from chan_vese_tpu_torch.ops import (_cuda, fused_kernel,
                                     multiphase_kernel, packed_kernel)
from fixtures import four_regions
from test_torch_mp2_band_tiling import twin as band_twin
from torch_port_helpers import cuda_device, params, to_np, to_torch

F32 = np.float32
MU = 0.003 * 255.0 ** 2
BANDED = dict(rtol=2e-5, atol=2e-3)
RESIDENT = dict(rtol=3e-4, atol=2e-3)
RESIDENT_OPS = {"flat": (pallas_multiphase.mp2_resident_iterations,
                         multiphase_kernel.mp2_resident_iterations),
                "packed": (pallas_packed.packed_mp2_resident_iterations,
                           packed_kernel.packed_mp2_resident_iterations)}
RESIDENT_SHAPES = {"flat": (64, 128), "packed": (32, 256)}


def _mk(shape, seed=0):
    """tests/test_multiphase_mp2.py's inputs: uniform image, N(0, 25)
    level sets."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, shape).astype(F32),
            (rng.standard_normal((2,) + shape) * 5).astype(F32))


def _labels(phis):
    return to_np(tmp.labels_from_phis(torch.as_tensor(np.asarray(phis))))


@pytest.mark.parametrize("shape", [(64, 128), (104, 256)])
def test_mp2_iteration_matches_pallas(shape):
    u0, phis = _mk(shape)
    pj, pt = params(mu=MU)
    cs = jnp.stack(jmp.phase_means(jnp.asarray(u0), jnp.asarray(phis),
                                   pj.eps))
    want, wparts = pallas_multiphase.mp2_iteration(
        jnp.asarray(phis), jnp.asarray(u0), cs, pj, interpret=True)
    got, parts = multiphase_kernel.mp2_iteration(
        to_torch(phis, F32), to_torch(u0, F32), to_torch(cs, F32), pt)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **BANDED)
    assert tuple(parts.shape) == (16,)
    parts, wparts = to_np(parts), np.asarray(wparts)
    np.testing.assert_allclose(parts[0:4] / parts[4:8],
                               wparts[0:4] / wparts[4:8], rtol=2e-4)
    np.testing.assert_allclose(parts[:8], wparts[:8], rtol=2e-4)
    assert abs(parts[8] - wparts[8]) <= 2
    np.testing.assert_allclose(parts[9], wparts[9], rtol=1e-4)
    np.testing.assert_array_equal(parts[10:], 0.0)
    # the flips are of the 2-bit label
    flips = (_labels(want) != _labels(phis)).sum()
    assert abs(parts[8] - flips) <= 2


def test_band_twin_matches_pallas():
    """K9's band-body tiling, through the plain windowed twin of
    tests/test_torch_mp2_band_tiling.py, against the JAX kernel in
    interpret mode at the K9 bars, f32: the inputs of
    test_mp2_iteration_matches_pallas at 64 x 128, whose compiled kernel
    this reuses."""
    u0, phis = _mk((64, 128))
    pj, pt = params(mu=MU)
    cs = jnp.stack(jmp.phase_means(jnp.asarray(u0), jnp.asarray(phis),
                                   pj.eps))
    want, _ = pallas_multiphase.mp2_iteration(
        jnp.asarray(phis), jnp.asarray(u0), cs, pj, interpret=True)
    got = band_twin(to_torch(phis, F32), to_torch(u0, F32),
                    to_torch(cs, F32), pt, (16, 32, 0))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **BANDED)


@pytest.mark.parametrize("layout", ["flat", "packed"])
def test_resident_first_iteration_matches_pallas(layout):
    u0, phis = _mk(RESIDENT_SHAPES[layout], seed=2)
    pj, pt = params(mu=MU)
    jop, top = RESIDENT_OPS[layout]
    want, wparts = jop(jnp.asarray(phis), jnp.asarray(u0), pj, 1,
                       interpret=True)
    got, parts = top(to_torch(phis, F32), to_torch(u0, F32), pt, 1)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **RESIDENT)
    assert tuple(parts.shape) == (1, 8)
    assert abs(float(parts[0, 0]) - float(wparts[0, 0])) <= 2
    np.testing.assert_allclose(float(parts[0, 1]), float(wparts[0, 1]),
                               rtol=1e-4)
    np.testing.assert_array_equal(to_np(parts)[:, 2:], 0.0)


@pytest.mark.parametrize("layout", ["flat", "packed"])
def test_resident_long_run_labels_match_pallas(layout):
    """25 iterations from init_multiphase at unroll 1 and 5: at most 5
    cells of another label than the JAX kernel (tests/test_multiphase_mp2.py
    :90-103's bar), rows (iters // unroll, 8)."""
    shape = RESIDENT_SHAPES[layout]
    img = four_regions(*shape, noise=4.0)[0].astype(F32)
    pj, pt = params(mu=MU)
    phis0 = np.asarray(jmp.init_multiphase(shape, 2, dtype=jnp.float32))
    jop, top = RESIDENT_OPS[layout]
    want, wparts = jop(jnp.asarray(phis0), jnp.asarray(img), pj, 25,
                       interpret=True)
    for unroll in (1, 5):
        got, parts = top(to_torch(phis0, F32), to_torch(img, F32), pt, 25,
                         unroll=unroll)
        assert (_labels(got) != _labels(want)).sum() <= 5
        assert tuple(parts.shape) == (25 // unroll, 8)
        assert bool(torch.isfinite(parts).all())
    # unroll changes only which rows are written
    got1, parts1 = top(to_torch(phis0, F32), to_torch(img, F32), pt, 10)
    got2, parts2 = top(to_torch(phis0, F32), to_torch(img, F32), pt, 10,
                       unroll=2)
    torch.testing.assert_close(got1, got2, rtol=0, atol=0)
    torch.testing.assert_close(parts1[1::2], parts2, rtol=0, atol=0)


def test_packed_resident_unroll2_rows_match_pallas():
    img = four_regions(32, 256, noise=4.0)[0].astype(F32)
    pj, pt = params(mu=MU)
    phis0 = np.asarray(jmp.init_multiphase((32, 256), 2, dtype=jnp.float32))
    want, wparts = pallas_packed.packed_mp2_resident_iterations(
        jnp.asarray(phis0), jnp.asarray(img), pj, 4, unroll=2,
        interpret=True)
    got, parts = packed_kernel.packed_mp2_resident_iterations(
        to_torch(phis0, F32), to_torch(img, F32), pt, 4, unroll=2)
    assert tuple(parts.shape) == tuple(wparts.shape) == (2, 8)
    np.testing.assert_allclose(to_np(parts)[:, 0], np.asarray(wparts)[:, 0],
                               atol=2)
    np.testing.assert_allclose(to_np(parts)[:, 1], np.asarray(wparts)[:, 1],
                               rtol=1e-3)


def test_fused_sweep_matches_pallas():
    rng = np.random.default_rng(0)
    phi = (rng.standard_normal((64, 128)) * 10).astype(F32)
    f = (rng.standard_normal((64, 128)) * 1e3).astype(F32)
    pj, pt = params()
    want, wparts = pallas_sweep.fused_sweep(jnp.asarray(phi), jnp.asarray(f),
                                            pj, interpret=True)
    got, parts = fused_kernel.fused_sweep(to_torch(phi, F32),
                                          to_torch(f, F32), pt)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **BANDED)
    np.testing.assert_allclose(
        to_np(got), np.asarray(jsweep.redblack_step(jnp.asarray(phi),
                                                    jnp.asarray(f), pj)),
        **BANDED)
    # slots 2-4: s_dphi2, flips (exact), s_absdphi
    parts, wparts = to_np(parts), np.asarray(wparts)
    np.testing.assert_allclose(parts[[2, 4]], wparts[[2, 4]], rtol=1e-4)
    assert parts[3] == wparts[3]
    assert parts[3] == float(np.sum((to_np(got) >= 0) != (phi >= 0)))


def test_wrappers_validate_arguments():
    _, pt = params()
    phis, u0 = torch.zeros(2, 64, 128), torch.zeros(64, 128)
    cs = torch.zeros(4)
    with pytest.raises(ValueError, match="M = 2"):
        multiphase_kernel.mp2_iteration(torch.zeros(3, 64, 128), u0, cs, pt)
    with pytest.raises(ValueError, match="grayscale"):
        multiphase_kernel.mp2_iteration(phis, torch.zeros(64, 128, 3), cs,
                                        pt)
    with pytest.raises(ValueError, match="unsupported"):
        multiphase_kernel.mp2_iteration(torch.zeros(2, 64, 100),
                                        torch.zeros(64, 100), cs, pt)
    with pytest.raises(ValueError, match="unsupported"):
        multiphase_kernel.mp2_resident_iterations(
            torch.zeros(2, 2048, 2048), torch.zeros(2048, 2048), pt, 1)
    with pytest.raises(ValueError, match="iters"):
        multiphase_kernel.mp2_resident_iterations(phis, u0, pt, 0)
    with pytest.raises(ValueError, match="unroll"):
        multiphase_kernel.mp2_resident_iterations(phis, u0, pt, 6, unroll=4)
    with pytest.raises(ValueError, match="unsupported"):
        packed_kernel.packed_mp2_resident_iterations(phis, u0, pt, 2)
    with pytest.raises(ValueError, match="unroll"):
        packed_kernel.packed_mp2_resident_iterations(
            torch.zeros(2, 32, 256), torch.zeros(32, 256), pt, 3, unroll=2)
    with pytest.raises(ValueError, match="unsupported"):
        fused_kernel.fused_sweep(torch.zeros(64, 100), torch.zeros(64, 100),
                                 pt)
    with pytest.raises(ValueError, match="one"):
        fused_kernel.fused_sweep(torch.zeros(64, 128), torch.zeros(64, 256),
                                 pt)


# on the card: each kernel against its plain version -----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 256), (1000, 1152)])
def test_mp2_iteration_cuda_matches_plain(shape):
    dev = cuda_device()
    u0, phis = _mk(shape, seed=4)
    _, pt = params(mu=MU)
    u, ph = torch.from_numpy(u0).to(dev), torch.from_numpy(phis).to(dev)
    cs = torch.stack(tmp.phase_means(u, ph, pt.eps))
    n = multiphase_kernel.mp2_iteration.launches
    got, parts = multiphase_kernel.mp2_iteration(ph, u, cs, pt)
    want, wparts = multiphase_kernel.mp2_iteration_reference(ph, u, cs, pt)
    torch.cuda.synchronize()
    assert multiphase_kernel.mp2_iteration.launches == n + 1
    np.testing.assert_allclose(to_np(got), to_np(want), **BANDED)
    np.testing.assert_allclose(to_np(parts)[:8], to_np(wparts)[:8],
                               rtol=2e-4)
    assert abs(float(parts[8] - wparts[8])) <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("layout,shape", [("flat", (512, 384)),
                                          ("packed", (256, 256))])
def test_resident_cuda_matches_plain(layout, shape):
    dev = cuda_device()
    u0, phis = _mk(shape, seed=5)
    _, pt = params(mu=MU)
    u, ph = torch.from_numpy(u0).to(dev), torch.from_numpy(phis).to(dev)
    top = RESIDENT_OPS[layout][1]
    plain = multiphase_kernel.mp2_resident_iterations_reference
    n = top.launches
    got, parts = top(ph, u, pt, 1)
    want, wparts = plain(ph, u, pt, 1)
    torch.cuda.synchronize()
    assert top.launches == n + 1
    np.testing.assert_allclose(to_np(got), to_np(want), **RESIDENT)
    assert abs(float(parts[0, 0] - wparts[0, 0])) <= 4
    # 25 iterations from the checkerboard start: labels
    img = torch.from_numpy(four_regions(*shape, noise=4.0)[0]
                           .astype(F32)).to(dev)
    start = tmp.init_multiphase(shape, 2, device=dev)
    got, parts = top(start, img, pt, 25, unroll=5)
    want, _ = plain(start, img, pt, 25)
    torch.cuda.synchronize()
    assert tuple(parts.shape) == (5, 8)
    diff = (tmp.labels_from_phis(got) != tmp.labels_from_phis(want)).sum()
    assert int(diff) <= 1e-3 * shape[0] * shape[1]


@pytest.mark.cuda
def test_fused_sweep_cuda_matches_plain():
    dev = cuda_device()
    rng = np.random.default_rng(6)
    phi = torch.from_numpy((rng.standard_normal((512, 512)) * 10)
                           .astype(F32)).to(dev)
    f = torch.from_numpy((rng.standard_normal((512, 512)) * 1e3)
                         .astype(F32)).to(dev)
    _, pt = params()
    n = fused_kernel.fused_sweep.launches
    got, parts = fused_kernel.fused_sweep(phi, f, pt)
    want, wparts = fused_kernel.fused_sweep_reference(phi, f, pt)
    torch.cuda.synchronize()
    assert fused_kernel.fused_sweep.launches == n + 1
    np.testing.assert_allclose(to_np(got), to_np(want), **BANDED)
    np.testing.assert_allclose(to_np(parts)[2:5], to_np(wparts)[2:5],
                               rtol=1e-4, atol=2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 256), (1000, 1152)])
def test_mp2_band_body_cuda_matches_the_first_body(shape):
    """K9's band body (the wrapper's launch) against the first body's `_v1`
    launcher on the same inputs: phi bitwise, the flips equal, the other
    partial sums equal after their f32 rounding (they add the same per-cell
    terms in another order, in f64); a second launch bitwise the first."""
    dev = cuda_device()
    u0, phis = _mk(shape, seed=8)
    _, pt = params(mu=MU)
    u, ph = torch.from_numpy(u0).to(dev), torch.from_numpy(phis).to(dev)
    cs = torch.stack(tmp.phase_means(u, ph, pt.eps))
    n = multiphase_kernel.mp2_iteration.launches
    got, parts = multiphase_kernel.mp2_iteration(ph, u, cs, pt)
    again, aparts = multiphase_kernel.mp2_iteration(ph, u, cs, pt)
    old, oparts = _cuda.launch_mp2(ph, u, cs, pt, v1=True)
    torch.cuda.synchronize()
    assert multiphase_kernel.mp2_iteration.launches == n + 2
    assert torch.equal(got, old)
    assert float(parts[8]) == float(oparts[8])
    assert torch.equal(parts, oparts)
    assert torch.equal(got, again) and torch.equal(parts, aparts)


@pytest.mark.cuda
def test_mp2_band_launcher_cuda_refuses_a_wrong_block_count():
    """cv_mp2_iteration sizes its grid itself (csrc/mp2_band.cu Mp2Axis)
    and refuses, with cudaErrorInvalidValue, a block count (block_parts'
    rows, ops/_cuda.py::mp2_axis_tiles) that is not the grid's."""
    from chan_vese_tpu_torch._build import library

    dev = cuda_device()
    u0, phis = _mk((256, 256), seed=8)
    _, pt = params(mu=MU)
    u, ph = torch.from_numpy(u0).to(dev), torch.from_numpy(phis).to(dev)
    cs = torch.stack(tmp.phase_means(u, ph, pt.eps)).reshape(4).contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geo, nblocks = _cuda.mp2_plan(256, 256, None, sms)
    out = torch.empty_like(ph)
    block_parts = torch.empty((nblocks + 1, _cuda.MP2_SUMS),
                              dtype=torch.float64, device=dev)
    parts = torch.empty(16, dtype=torch.float32, device=dev)
    pars = (pt.mu, pt.nu, 0.0, 0.0, *_cuda._common_params(pt))
    stream = torch.cuda.current_stream(dev).cuda_stream
    errs = [library().cv_mp2_iteration(
        ph.data_ptr(), u.data_ptr(), cs.data_ptr(), out.data_ptr(),
        block_parts.data_ptr(), parts.data_ptr(), 256, 256, *geo, n, *pars,
        stream) for n in (nblocks, nblocks + 1, nblocks - 1)]
    torch.cuda.synchronize()
    assert errs == [0, 1, 1]  # cudaSuccess, cudaErrorInvalidValue twice
