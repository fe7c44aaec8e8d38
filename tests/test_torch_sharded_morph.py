"""The port's sharded morphological drivers (parallel/sharded_morph.py:
``segment_morph_sharded_chunked``, ``segment_gac_sharded_chunked``; and
``models.morph.segment_morph_sharded``,
``models.morph_gac.segment_gac_sharded``) against the JAX reference, on
grids of CPU devices (the reference on the conftest's fake CPU devices).

The state is binary and every op is a min, max or select, so the level
sets are held bitwise (f64), with the iteration counts and the flip
metric (within an ulp); the ACWE means at 1e-12 (the shards' sums run in
another order).

- comm_k chunks: GAC at comm_k 4, 3, 5 and 6 (an edge-crossing disk),
  ACWE at comm_k 1 and 4, RGB with per-channel lambdas; tolerance mode
  stopping early; a NaN image aborting; the geometry errors.
- Full chunks through K11's shard kinds (their plain versions on CPU
  devices), the remainder chunk through the plain body, bitwise the
  reference's kernel route in interpret mode; the route's errors.
- The per-iteration wrappers against the reference's wrappers, gray and
  RGB, tolerance mode with its 2-cycle detector; their errors.
- The CLI's ``--mesh`` with ``--morph`` and ``--morph-gac``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu import cli as jcli
from chan_vese_tpu.models import morph as jmorph
from chan_vese_tpu.models import morph_gac as jgac
from chan_vese_tpu.ops.morph import inverse_gaussian_gradient as j_igg
from chan_vese_tpu.parallel import sharded_morph as jsm
from chan_vese_tpu.parallel.mesh import make_grid_mesh as j_grid
from chan_vese_tpu_torch import cli as tcli
from chan_vese_tpu_torch.models import morph as tmorph
from chan_vese_tpu_torch.models import morph_gac as tgac
from chan_vese_tpu_torch.ops import morph_kernel
from chan_vese_tpu_torch.parallel import make_grid_mesh
from chan_vese_tpu_torch.parallel import sharded_morph as tsm
from torch_port_helpers import cuda_device, params, to_np, to_torch

CPU = torch.device("cpu")


def cpu_grid(nx, ny):
    return make_grid_mesh(nx, ny, [CPU] * (nx * ny))


def _disk(H=96, W=128, r=30, noise=5.0, seed=0):
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W))
    yy, xx = np.mgrid[:H, :W]
    img[(yy - H // 2) ** 2 + (xx - W // 2) ** 2 < r ** 2] = 200.0
    return img + rng.normal(0, noise, img.shape)


def _edge_disk(H=96, W=128):
    """A disk over the image's top-left corner: the contour crosses shard
    and image edges."""
    img = np.zeros((H, W))
    yy, xx = np.mgrid[:H, :W]
    img[(yy - 8) ** 2 + (xx - 10) ** 2 < 40 ** 2] = 200.0
    return img + 0.1 * np.arange(W)[None, :]


def _edge_map(img, sigma=3.0):
    return np.asarray(j_igg(jnp.asarray(img), alpha=5.0, sigma=sigma))


def _same(got, want, means=False):
    """Level sets bitwise, iteration counts equal, the flip fraction within
    an ulp (XLA may divide by n_pix through a reciprocal), the means at
    1e-12."""
    np.testing.assert_array_equal(to_np(got.ls), np.asarray(want.ls))
    assert got.iters == int(want.iters)
    np.testing.assert_allclose(float(got.delta), float(want.delta),
                               rtol=1e-15, atol=0)
    if means:
        np.testing.assert_allclose(to_np(got.c1), np.asarray(want.c1),
                                   rtol=1e-12)
        np.testing.assert_allclose(to_np(got.c2), np.asarray(want.c2),
                                   rtol=1e-12)


GAC_CASES = {"comm_k 4 balloon 1": (_disk(), 4, 1, 3.0, (2, 4), 37),
             "comm_k 3": (_disk(), 3, 1, 3.0, (2, 4), 37),
             "comm_k 5 no balloon": (_disk(), 5, 0, 3.0, (2, 4), 37),
             "edge disk comm_k 6": (_edge_disk(), 6, 1, 2.0, (2, 4), 24)}


@pytest.mark.parametrize("case", list(GAC_CASES))
def test_gac_chunked_bitwise(case):
    img, comm_k, balloon, sigma, grid, iters = GAC_CASES[case]
    g = _edge_map(img, sigma)
    pj, pt = params(max_iter=iters, tol=0.0)
    kw = dict(smoothing=1, balloon=balloon, threshold=0.3, comm_k=comm_k)
    want = jsm.segment_gac_sharded_chunked(jnp.asarray(g), pj,
                                           mesh=j_grid(*grid), **kw)
    got = tsm.segment_gac_sharded_chunked(to_torch(g), pt,
                                          mesh=cpu_grid(*grid), **kw)
    _same(got, want)
    assert got.iters == iters
    # trajectory-exact: the unsharded per-iteration run
    ref = tgac.segment_gac_fixed(to_torch(g), pt, iters=iters, smoothing=1,
                                 balloon=balloon, threshold=0.3)
    assert torch.equal(got.ls, ref.ls)


@pytest.mark.parametrize("comm_k", [1, 4])
def test_morph_chunked_bitwise(comm_k):
    u = _disk(seed=3)
    pj, pt = params(max_iter=32, tol=0.0)
    want = jsm.segment_morph_sharded_chunked(jnp.asarray(u), pj,
                                             mesh=j_grid(2, 4), comm_k=comm_k)
    got = tsm.segment_morph_sharded_chunked(to_torch(u), pt,
                                            mesh=cpu_grid(2, 4),
                                            comm_k=comm_k)
    _same(got, want, means=True)
    if comm_k == 4:  # the banded kernel's frozen-means class
        ref = tmorph.segment_morph_iterations(to_torch(u), pt, iters=32, k=4,
                                              use_pallas=True)
        assert torch.equal(got.ls, ref.ls)


def test_morph_chunked_rgb_bitwise():
    rng = np.random.default_rng(5)
    H, W = 96, 128
    img = np.zeros((H, W, 3))
    yy, xx = np.mgrid[:H, :W]
    img[(yy - 48) ** 2 + (xx - 64) ** 2 < 28 ** 2] = (180.0, 120.0, 60.0)
    img += rng.normal(0, 4, img.shape)
    pj, pt = params(max_iter=40, tol=0.0)
    kw = dict(smoothing=1, comm_k=4, lambda1=(1.0, 1.0, 2.0),
              lambda2=(1.0, 1.0, 1.0))
    want = jsm.segment_morph_sharded_chunked(jnp.asarray(img), pj,
                                             mesh=j_grid(2, 2), **kw)
    got = tsm.segment_morph_sharded_chunked(to_torch(img), pt,
                                            mesh=cpu_grid(2, 2),
                                            use_pallas=True, **kw)
    _same(got, want, means=True)


def test_chunked_tolerance_stops_and_nan_aborts():
    g = _edge_map(_disk(noise=0.0))
    pj, pt = params(max_iter=400, tol=1e-4, patience=4, min_iter=8)
    kw = dict(smoothing=1, balloon=1, threshold=0.3, comm_k=4)
    want = jsm.segment_gac_sharded_chunked(jnp.asarray(g), pj,
                                           mesh=j_grid(2, 2), **kw)
    got = tsm.segment_gac_sharded_chunked(to_torch(g), pt,
                                          mesh=cpu_grid(2, 2), **kw)
    _same(got, want)
    assert got.iters < 400 and float(got.delta) < 1e-4
    u = _disk()
    u[10, 10] = np.nan
    pj, pt = params(max_iter=100, tol=1e-4, patience=3)
    want = jsm.segment_morph_sharded_chunked(jnp.asarray(u), pj,
                                             mesh=j_grid(2, 2), comm_k=4)
    got = tsm.segment_morph_sharded_chunked(to_torch(u), pt,
                                            mesh=cpu_grid(2, 2), comm_k=4)
    assert got.iters == int(want.iters) <= 8
    assert not np.isfinite(float(got.delta))


@pytest.mark.parametrize("case", ["acwe", "acwe edge disk", "gac",
                                  "gac remainder"])
def test_kernel_per_shard_bitwise(case):
    """Full chunks through K11's shard kinds (plain versions), the
    remainder through the plain body: bitwise the reference's kernel
    route in interpret mode."""
    if case.startswith("acwe"):
        u = _edge_disk() if "edge" in case else _disk(H=96, W=256)
        grid = (2, 2) if "edge" in case else (2, 4)
        pj, pt = params(max_iter=16 if "edge" in case else 12, tol=0.0)
        want = jsm.segment_morph_sharded_chunked(
            jnp.asarray(u), pj, mesh=j_grid(*grid), comm_k=4,
            use_pallas=True, interpret=True)
        n0 = morph_kernel.morph_chunk_shard.launches
        got = tsm.segment_morph_sharded_chunked(
            to_torch(u), pt, mesh=cpu_grid(*grid), comm_k=4, use_pallas=True)
        assert morph_kernel.morph_chunk_shard.launches == n0
        _same(got, want, means=True)
        return
    g = _edge_map(_disk())
    grid = (2, 2) if "remainder" in case else (2, 4)
    iters = 11 if "remainder" in case else 12
    pj, pt = params(max_iter=iters, tol=0.0)
    kw = dict(smoothing=1, balloon=1, threshold=0.3, comm_k=4,
              use_pallas=True)
    want = jsm.segment_gac_sharded_chunked(jnp.asarray(g), pj,
                                           mesh=j_grid(*grid),
                                           interpret=True, **kw)
    got = tsm.segment_gac_sharded_chunked(to_torch(g), pt,
                                          mesh=cpu_grid(*grid), **kw)
    _same(got, want)


def test_chunked_errors_where_the_reference_raises():
    u = to_torch(_disk(96, 128))
    _, pt = params()
    mesh = cpu_grid(2, 4)
    with pytest.raises(ValueError, match="halo depth"):
        tsm.segment_morph_sharded_chunked(u, pt, mesh=mesh, comm_k=16)
    with pytest.raises(ValueError, match="divisible"):
        tsm.segment_morph_sharded_chunked(u[:95], pt, mesh=mesh, comm_k=2)
    with pytest.raises(ValueError, match="kernel-per-shard"):
        tsm.segment_morph_sharded_chunked(u, pt.replace(max_iter=6),
                                          mesh=mesh, comm_k=3,
                                          use_pallas=True)
    with pytest.raises(ValueError, match="needs a mesh"):
        tsm.segment_gac_sharded_chunked(u, pt)
    with pytest.raises(ValueError, match="needs a mesh"):
        tsm.segment_morph_sharded_chunked(u, pt)


@pytest.mark.parametrize("case", ["morph", "morph rgb", "gac"])
def test_per_iteration_wrappers_match_reference(case):
    """The wrappers' level set, iteration count and delta are the
    reference's (its unsharded drivers on sharded arrays), in tolerance
    mode with the 2-cycle detector."""
    if case == "gac":
        g = _edge_map(_disk(noise=0.0))
        pj, pt = params(max_iter=200, tol=1e-4, patience=4, min_iter=8)
        kw = dict(balloon=1, threshold=0.3)
        want = jgac.segment_gac_sharded(jnp.asarray(g), pj,
                                        mesh=j_grid(2, 4), **kw)
        got = tgac.segment_gac_sharded(to_torch(g), pt, mesh=cpu_grid(2, 4),
                                       **kw)
        _same(got, want)
        assert got.iters < 200
        return
    u = _disk()
    kw = {}
    if case == "morph rgb":
        u = np.stack([u, 0.5 * u + 30.0, 255.0 - u], axis=-1)
        kw = dict(lambda1=(1.0, 2.0, 1.0), lambda2=(1.0, 1.0, 0.5))
    pj, pt = params(max_iter=30)
    want = jmorph.segment_morph_sharded(jnp.asarray(u), pj, mesh=j_grid(2, 2),
                                        **kw)
    got = tmorph.segment_morph_sharded(to_torch(u), pt, mesh=cpu_grid(2, 2),
                                       **kw)
    _same(got, want, means=True)


def test_wrapper_errors():
    u = to_torch(_disk(96, 128))
    _, pt = params()
    with pytest.raises(ValueError, match="needs a mesh"):
        tmorph.segment_morph_sharded(u, pt)
    with pytest.raises(ValueError, match="not divisible"):
        tmorph.segment_morph_sharded(u[:95], pt, mesh=cpu_grid(2, 2))
    with pytest.raises(ValueError, match="edge map .* not divisible"):
        tgac.segment_gac_sharded(u[:, :127], pt, mesh=cpu_grid(2, 2))
    # one iteration's reach (4 at smoothing 1) must fit in a shard
    with pytest.raises(ValueError, match="4-deep halo"):
        tgac.segment_gac_sharded(u[:8], pt, mesh=cpu_grid(4, 1))


@pytest.mark.parametrize("extra", [["--morph"], ["--morph", "--comm-k", "4"],
                                   ["--morph-gac", "--comm-k", "8"]])
def test_cli_mesh_morph_writes_the_reference_mask(extra, tmp_path):
    src = tmp_path / "img.npy"
    np.save(src, _disk(noise=3.0).astype(np.float32))
    args = [str(src), "--mesh", "2", "2", "--max-iter", "40"] + extra
    if "--morph-gac" in extra:
        args += ["--balloon", "1", "--init", "small-disk", "--gac-alpha",
                 "5", "--gac-sigma", "2", "--gac-threshold", "0.3"]
    assert jcli.main(args + ["--quiet", "-o", str(tmp_path / "j.npy")]) == 0
    assert tcli.main(args + ["-o", str(tmp_path / "t.npy"), "--device",
                             "cpu"]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"),
                                  np.load(tmp_path / "j.npy"))


@pytest.mark.cuda
def test_sharded_morph_cuda_matches_cpu():
    """On the card (a 2x2 grid on cuda:0) full chunks launch K11's shard
    kinds once a shard, and the level sets equal the same runs on CPU
    devices bitwise (GAC) and up to mean-order ties (ACWE)."""
    dev = cuda_device()
    u = _disk(192, 256).astype(np.float32)
    g = _edge_map(u).astype(np.float32)
    _, pt = params(max_iter=32, tol=0.0)
    mesh = make_grid_mesh(2, 2, [dev] * 4)
    kw = dict(balloon=1, threshold=0.3, comm_k=8)
    n0 = morph_kernel.gac_chunk_shard.launches
    got = tsm.segment_gac_sharded_chunked(to_torch(g, np.float32).to(dev),
                                          pt, mesh=mesh, **kw)
    assert morph_kernel.gac_chunk_shard.launches == n0 + 16
    ref = tsm.segment_gac_sharded_chunked(to_torch(g, np.float32), pt,
                                          mesh=cpu_grid(2, 2),
                                          use_pallas=True, **kw)
    assert torch.equal(got.ls.cpu(), ref.ls)
    n0 = morph_kernel.morph_chunk_shard.launches
    got = tsm.segment_morph_sharded_chunked(to_torch(u, np.float32).to(dev),
                                            pt, mesh=mesh, comm_k=8)
    assert morph_kernel.morph_chunk_shard.launches == n0 + 16
    ref = tsm.segment_morph_sharded_chunked(to_torch(u, np.float32), pt,
                                            mesh=cpu_grid(2, 2), comm_k=8,
                                            use_pallas=True)
    assert int((got.ls.cpu() != ref.ls).sum()) <= 16


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [["--multiphase", "2", "--mu", "195"],
                                   ["--morph"], ["--morph", "--comm-k", "8"],
                                   ["--morph-gac", "--comm-k", "1"],
                                   ["--morph-gac", "--comm-k", "8"]])
def test_cli_mesh_2x2_runs_on_one_card(extra, tmp_path):
    """``--mesh 2 2`` lays its four shards on the card(s) there are (in
    turn), runs the kernels per shard, and writes the output of the same
    command on CPU devices but for a few cells: the image's edge map and
    the means come from the card's arithmetic and the CPU's (1e-4 of the
    morph masks' cells, 1e-3 of the f32 multiphase labels')."""
    cuda_device()
    src = tmp_path / "img.npy"
    np.save(src, _disk(256, 512, noise=3.0).astype(np.float32))
    args = [str(src), "--mesh", "2", "2", "--max-iter", "60"] + extra
    if "--morph-gac" in extra:
        args += ["--balloon", "1", "--init", "small-disk", "--gac-alpha",
                 "5", "--gac-sigma", "2", "--gac-threshold", "0.3"]
    assert tcli.main(args + ["-o", str(tmp_path / "g.npy")]) == 0
    assert tcli.main(args + ["-o", str(tmp_path / "c.npy"), "--device",
                             "cpu"]) == 0
    got, want = np.load(tmp_path / "g.npy"), np.load(tmp_path / "c.npy")
    assert got.shape == want.shape == (256, 512)
    assert (got != want).mean() <= (1e-3 if "--multiphase" in extra
                                    else 1e-4)
