"""K9's shard-canvas mode, K1's force mode with a parity and K11's shard
kinds (acwe_sh, gac_pre_sh) in the port against the JAX reference.

- ``fused_sweep(parity=...)``'s plain version against the JAX kernel in
  interpret mode (f64: phi and the flips/delta partials at 1e-10, the f H
  and H slots at 1e-8, since the reference's Heaviside takes a Cephes atan
  accurate to f32).
- ``mp2_iteration_sharded``'s plain version against the JAX kernel in
  interpret mode on the reference's lane-padded canvases (the top-left,
  bottom-right, no and all edge flags; both parities) at the K9 bars of
  tests/test_torch_kernels_mp2.py in f32; the whole canvas is compared
  (the kernel sweeps and stores it).
- K9's band-body tiling (tests/test_torch_mp2_band_tiling.py's windowed
  twin) against the JAX kernel in interpret mode on the same canvases.
- The plain version on the port's narrow canvases of a 2x2 grid: each crop
  bitwise equal to the whole-image K9 iteration's window, and after two
  launches chained on one 16-deep canvas bitwise equal to two whole-image
  iterations (a kernel that copied the halo through would read the
  chunk's first halo in its second launch and differ).
- ``morph_chunk_shard`` / ``gac_chunk_shard`` plain versions bitwise
  against the JAX kernel in interpret mode on the own cells, several pads
  and flags; the argument checks.
- ``cuda``-marked tests hold each mode against its plain version on the
  card, with a second launch bitwise equal to the first, and K9's shard
  mode on its band body against its first body (skipped without a GPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.models import multiphase as jmp
from chan_vese_tpu.ops import pallas_morph, pallas_multiphase, pallas_sweep
from chan_vese_tpu.ops.morph import inverse_gaussian_gradient as j_igg
from chan_vese_tpu_torch.ops import _cuda, fused_kernel, morph_kernel
from chan_vese_tpu_torch.ops import multiphase_kernel as mk
from chan_vese_tpu_torch.parallel import (exchange_halo2d,
                                          exchange_halo2d_batched,
                                          grid_sharding, make_grid_mesh,
                                          shard_grid)
from fixtures import four_regions
from test_torch_mp2_band_tiling import twin as band_twin
from torch_port_helpers import cuda_device, params, to_np, to_torch

F32 = np.float32
MU = 0.003 * 255.0 ** 2
BANDED = dict(rtol=2e-5, atol=2e-3)  # test_torch_kernels_mp2.py's K9 bars
CPU = torch.device("cpu")
EDGES = [(1, 0, 1, 0), (0, 1, 0, 1), (0, 0, 0, 0), (1, 1, 1, 1)]


def _mp_inputs(shape, dtype, seed=0):
    """The four-regions image, init_multiphase's start and its means."""
    u = four_regions(*shape, noise=4.0, seed=seed)[0].astype(dtype)
    phis = np.asarray(jmp.init_multiphase(shape, 2, dtype=jnp.float64),
                      dtype)
    cs = np.asarray(jnp.stack(jmp.phase_means(jnp.asarray(u),
                                              jnp.asarray(phis), 1.0)),
                    dtype)
    return u, phis, cs


@pytest.mark.parametrize("parity", [0, 1])
def test_fused_sweep_parity_matches_pallas(parity):
    rng = np.random.default_rng(parity)
    phi = rng.standard_normal((40, 128)) * 3.0
    f = rng.standard_normal((40, 128)) * 100.0
    pj, pt = params(mu=MU)
    want, wparts = pallas_sweep.fused_sweep(jnp.asarray(phi), jnp.asarray(f),
                                            pj, parity=parity,
                                            interpret=True)
    got, parts = fused_kernel.fused_sweep(to_torch(phi), to_torch(f), pt,
                                          parity=parity)
    want, wparts = np.asarray(want), np.asarray(wparts)
    np.testing.assert_allclose(to_np(got), want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(to_np(parts)[2:], wparts[2:], rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(to_np(parts)[:2], wparts[:2], rtol=1e-8)
    # parity 1 moves the lattice: red cells are (i + j) odd
    same, _ = fused_kernel.fused_sweep(to_torch(phi), to_torch(f), pt)
    assert torch.equal(got, same) == (parity == 0)


@pytest.mark.parametrize("edges,parity",
                         [(e, i % 2) for i, e in enumerate(EDGES)])
def test_mp2_iteration_sharded_matches_pallas(edges, parity):
    """One iteration on a 40x128 canvas (crop (4, 36, 4, 68): the
    reference's lane-padded geometry of a 32x64 shard) at the K9 bars,
    the whole canvas and the crop's partials."""
    u, phis, cs = _mp_inputs((40, 128), F32, seed=parity)
    pj, pt = params(mu=MU)
    crop = (4, 36, 4, 68)
    want, wparts = pallas_multiphase.mp2_iteration_sharded(
        jnp.asarray(phis), jnp.asarray(u), jnp.asarray(cs), pj,
        jnp.asarray(parity), jnp.asarray(edges, F32), crop, interpret=True)
    got, parts = mk.mp2_iteration_sharded(
        to_torch(phis, F32), to_torch(u, F32), to_torch(cs, F32), pt, parity,
        edges, crop)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **BANDED)
    parts, wparts = to_np(parts), np.asarray(wparts)
    assert parts.shape == (16,)
    np.testing.assert_allclose(parts[:8], wparts[:8], rtol=2e-4)
    assert abs(parts[8] - wparts[8]) <= 2
    np.testing.assert_allclose(parts[9], wparts[9], rtol=1e-4)
    np.testing.assert_array_equal(parts[10:], 0.0)


@pytest.mark.parametrize("edges,parity",
                         [(e, i % 2) for i, e in enumerate(EDGES[:2])])
def test_band_twin_matches_pallas_sharded(edges, parity):
    """K9's band-body tiling of a shard canvas, through the plain windowed
    twin of tests/test_torch_mp2_band_tiling.py (unfolded and folded),
    against the JAX kernel in interpret mode at the K9 bars, f32, the
    whole canvas compared: the inputs of
    test_mp2_iteration_sharded_matches_pallas, whose compiled kernel this
    reuses."""
    u, phis, cs = _mp_inputs((40, 128), F32, seed=parity)
    pj, pt = params(mu=MU)
    crop = (4, 36, 4, 68)
    want, _ = pallas_multiphase.mp2_iteration_sharded(
        jnp.asarray(phis), jnp.asarray(u), jnp.asarray(cs), pj,
        jnp.asarray(parity), jnp.asarray(edges, F32), crop, interpret=True)
    shard = _cuda.shard_args(40, 128, 1, parity, crop, edges)
    for fold in (0, 1):
        got = band_twin(to_torch(phis, F32), to_torch(u, F32),
                        to_torch(cs, F32), pt, (8, 32, fold), shard)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **BANDED)


def _narrow_canvases(phis, u, nx, ny, D):
    """The port driver's canvases of every shard of an nx x ny grid of CPU
    devices: (position, (2, h + 2D, w + 2D) level sets, image, parity,
    edges, crop)."""
    mesh = make_grid_mesh(nx, ny, [CPU] * (nx * ny))
    sharding = grid_sharding(mesh)
    per = [shard_grid(phis[m], sharding) for m in range(2)]
    pads = exchange_halo2d_batched(
        [[torch.stack([per[0][ix][iy], per[1][ix][iy]]) for iy in range(ny)]
         for ix in range(nx)], D)
    us = exchange_halo2d(shard_grid(u, sharding), D)
    h, w = u.shape[0] // nx, u.shape[1] // ny
    for ix in range(nx):
        for iy in range(ny):
            yield ((ix, iy), pads[ix][iy], us[ix][iy], (ix * h + iy * w) % 2,
                   (ix == 0, ix == nx - 1, iy == 0, iy == ny - 1),
                   (D, D + h, D, D + w))


@pytest.mark.parametrize("grid", [(2, 2), (3, 3)])
def test_mp2_sharded_crops_equal_the_whole_image(grid):
    """f64: each shard's crop is bitwise the whole-image iteration's
    window, after one launch (D = 4) and after two launches chained on a
    16-deep canvas (the comm_k = 2 chunk); the shards' partials summed are
    the whole image's."""
    nx, ny = grid
    shape = (48 * nx, 128 * ny)
    u, phis, cs = (to_torch(a) for a in _mp_inputs(shape, np.float64))
    _, pt = params(mu=MU)
    one, wparts = mk.mp2_iteration(phis, u, cs, pt)
    two = mk.mp2_iteration(one, u, cs, pt)[0]
    h, w = shape[0] // nx, shape[1] // ny
    for k, whole in ((1, one), (2, two)):
        D = 4 if k == 1 else 8 * k
        total = 0.0
        for (ix, iy), x, uc, par, edges, crop in _narrow_canvases(
                phis, u, nx, ny, D):
            for _ in range(k):
                x, parts = mk.mp2_iteration_sharded(x, uc, cs, pt, par,
                                                    edges, crop)
            total = total + parts
            win = whole[:, ix * h:(ix + 1) * h, iy * w:(iy + 1) * w]
            torch.testing.assert_close(x[:, D:D + h, D:D + w], win, rtol=0,
                                       atol=0)
        if k == 1:
            torch.testing.assert_close(total, wparts, rtol=1e-12,
                                       atol=1e-9)


def _morph_inputs(H=96, W=128):
    """A binary start crossing every edge (a disk cut by the top-left
    corner and a square), the ACWE force of a noisy image, and the GAC
    edge map's (dgx, dgy, mask) stack with a balloon of 1."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[:H, :W]
    ls = (((yy - 8) ** 2 + (xx - 10) ** 2 < 40 ** 2)
          | ((abs(yy - 60) < 20) & (abs(xx - 100) < 30))).astype(np.float64)
    img = np.where(ls > 0, 200.0, 20.0) + rng.normal(0, 30, (H, W))
    f = (img - 180.0) ** 2 - (img - 40.0) ** 2
    g = j_igg(jnp.asarray(img), alpha=5.0, sigma=2.0)
    aux = np.asarray(pallas_morph.gac_aux_stack(g, 1, 0.3))
    return ls, f, aux


MORPH_CASES = [((12, 12, 12, 12), (0, 1, 0, 1), 1),
               ((3, 21, 12, 20), (1, 1, 1, 1), 0),
               ((12, 12, 12, 12), (0, 0, 0, 0), 1)]


@pytest.mark.parametrize("pads,flags,parity0", MORPH_CASES)
def test_morph_shard_kinds_match_pallas(pads, flags, parity0):
    """Bitwise on the own cells, acwe_sh (k = 4) and gac_pre_sh (k = 2);
    the cells outside them come back as they went in."""
    ls, f, aux = _morph_inputs()
    H, W = ls.shape
    pt_, pb, pl, pr = pads
    own = np.s_[pt_:H - pb, pl:W - pr]
    jf = jnp.asarray(flags, jnp.float32).reshape(1, 4)
    want = np.asarray(pallas_morph.morph_chunk_shard(
        jnp.asarray(ls), jnp.asarray(f), jf, pads, k=4, smoothing=1,
        parity0=parity0, interpret=True))
    got = to_np(morph_kernel.morph_chunk_shard(
        to_torch(ls), to_torch(f), flags, pads, k=4, smoothing=1,
        parity0=parity0))
    np.testing.assert_array_equal(got[own], want[own])
    outside = np.ones_like(ls, bool)
    outside[own] = False
    np.testing.assert_array_equal(got[outside], ls[outside])
    want = np.asarray(pallas_morph.gac_chunk_shard(
        jnp.asarray(ls), jnp.asarray(aux), jf, pads, k=2, smoothing=1,
        parity0=parity0, balloon=1, threshold=0.3, interpret=True))
    got = to_np(morph_kernel.gac_chunk_shard(
        to_torch(ls), to_torch(aux), flags, pads, k=2, smoothing=1,
        parity0=parity0, balloon=1, threshold=0.3))
    np.testing.assert_array_equal(got[own], want[own])


def test_shard_wrappers_check_their_arguments():
    ls, f, aux = _morph_inputs(32, 32)
    t = to_torch(ls)
    with pytest.raises(ValueError, match="no replica ring"):
        morph_kernel.morph_chunk_shard(t, to_torch(f), (1, 0, 0, 0),
                                       (0, 4, 4, 4))
    with pytest.raises(ValueError, match="leave no cells"):
        morph_kernel.morph_chunk_shard(t, to_torch(f), (0,) * 4,
                                       (16, 16, 4, 4))
    with pytest.raises(ValueError, match="top, bottom"):
        morph_kernel.gac_chunk_shard(t, to_torch(aux), (1, 0), (4,) * 4)
    with pytest.raises(ValueError, match="expected"):
        morph_kernel.gac_chunk_shard(t, to_torch(f), (0,) * 4, (4,) * 4)
    phis = torch.zeros(2, 24, 32, dtype=torch.float64)
    _, pt = params()
    with pytest.raises(ValueError, match="M = 2"):
        mk.mp2_iteration_sharded(phis[:1], phis[0], torch.ones(4), pt, 0,
                                 None, (4, 20, 4, 28))
    with pytest.raises(ValueError, match="leaves"):
        mk.mp2_iteration_sharded(phis, phis[0], torch.ones(4), pt, 0,
                                 (0, 0, 0, 0), (1, 20, 4, 28))


@pytest.mark.cuda
def test_shard_modes_cuda_match_plain():
    """K9 shard (one launch and two chained), K1 force with parity 1 and
    the K11 shard kinds on the card against their plain versions on the
    same card: K9 and K1 at the K9 bars, K11 bitwise; second launches
    bitwise equal; each launch counted."""
    dev = cuda_device()
    _, pt = params(mu=MU)
    u, phis, cs = (to_torch(a, F32).to(dev)
                   for a in _mp_inputs((96, 256), F32))
    n0 = mk.mp2_iteration_sharded.launches
    for _, x, uc, par, edges, crop in _narrow_canvases(
            phis.cpu(), u.cpu(), 2, 2, 16):
        x, uc = x.to(dev).contiguous(), uc.to(dev).contiguous()
        got, ref = x, x
        for _ in range(2):
            got, gparts = mk.mp2_iteration_sharded(got, uc, cs, pt, par,
                                                   edges, crop)
            ref, _ = mk.mp2_iteration_sharded_reference(ref, uc, cs, pt,
                                                        par, edges, crop)
        again = mk.mp2_iteration_sharded(x, uc, cs, pt, par, edges, crop)
        first = mk.mp2_iteration_sharded(x, uc, cs, pt, par, edges, crop)
        torch.testing.assert_close(got, ref, **BANDED)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])
    assert mk.mp2_iteration_sharded.launches == n0 + 16
    f = torch.randn(96, 256, device=dev) * 100.0
    got = fused_kernel.fused_sweep(phis[0].contiguous(), f, pt, parity=1)
    ref = fused_kernel.fused_sweep_reference(phis[0].contiguous(), f, pt,
                                             parity=1)
    torch.testing.assert_close(got[0], ref[0], **BANDED)
    ls, fm, aux = (to_torch(a, F32).to(dev) for a in _morph_inputs())
    for pads, flags, parity0 in MORPH_CASES:
        for kern, plain, a, kw in (
                (morph_kernel.morph_chunk_shard,
                 morph_kernel.morph_chunk_shard_reference, fm, dict(k=4)),
                (morph_kernel.gac_chunk_shard,
                 morph_kernel.gac_chunk_shard_reference, aux,
                 dict(k=2, balloon=1, threshold=0.3))):
            got = kern(ls, a, flags, pads, parity0=parity0, **kw)
            assert torch.equal(got, plain(ls, a, flags, pads,
                                          parity0=parity0, **kw))
            assert torch.equal(got, kern(ls, a, flags, pads,
                                         parity0=parity0, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("D,k", [(4, 1), (16, 2)])
def test_mp2_shard_band_body_cuda_matches_the_first_body(D, k):
    """K9's shard mode on its band body against the first body's `_v1`
    launcher on every shard of a 2x2 grid, one launch on the D = 4 canvas
    and two chained on a 16-deep one: phi bitwise, the flips equal, the
    other partial sums equal after their f32 rounding; a second launch
    bitwise the first."""
    dev = cuda_device()
    _, pt = params(mu=MU)
    u, phis, cs = (to_torch(a, F32).to(dev)
                   for a in _mp_inputs((96, 256), F32, seed=3))
    n0 = mk.mp2_iteration_sharded.launches
    for _, x, uc, par, edges, crop in _narrow_canvases(
            phis.cpu(), u.cpu(), 2, 2, D):
        x, uc = x.to(dev).contiguous(), uc.to(dev).contiguous()
        shard = _cuda.shard_args(*uc.shape, 1, par, crop, edges)
        got = old = x
        for _ in range(k):
            got, parts = mk.mp2_iteration_sharded(got, uc, cs, pt, par,
                                                  edges, crop)
            old, oparts = _cuda.launch_mp2(old, uc, cs, pt, shard=shard,
                                           v1=True)
        again = mk.mp2_iteration_sharded(x, uc, cs, pt, par, edges, crop)
        first = mk.mp2_iteration_sharded(x, uc, cs, pt, par, edges, crop)
        torch.cuda.synchronize()
        assert torch.equal(got, old), edges
        assert float(parts[8]) == float(oparts[8])
        assert torch.equal(parts, oparts)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])
    assert mk.mp2_iteration_sharded.launches == n0 + 4 * (k + 2)
