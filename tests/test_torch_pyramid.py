"""The port's coarse-to-fine drivers (models/pyramid.py) and the CLI's
``--pyramid``, ``--smooth`` and ``--reinit-every`` against the JAX
reference on the CPU.

- ``plan_levels``, ``plan_levels_sharded``, ``downsample2x`` (and its
  odd-shape raise) and ``upsample_ls2x`` exactly; ``upsample_phi2x``
  within 1e-12 in f64, its border rows and columns included (the
  reference's resize renormalizes its triangle weights there, the port's
  bilinear interpolation clamps the source coordinate: both take the
  edge cell).
- ``segment_pyramid`` at two shapes, with equal ``level_iters`` and
  masks. The reference calls ``segment_banded`` without ``interpret``, so
  on the CPU every level takes its per-iteration jnp route, where the
  port's levels take the banded plain versions where the banded envelope
  holds (another trajectory class). At 96 x 160 every level is refused
  the banded and fused routes in both packages (W % 128); at 128 x 512
  the reference's ``segment_banded`` is patched to interpret mode, so
  both take the banded route where it holds (the finer two levels) and
  the fused one below.
- The multiphase, sharded (a 2x4 grid), MorphACWE and MorphGAC pyramids;
  the morphological ones bitwise.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu import cli as jcli
from chan_vese_tpu.models import banded as jbanded
from chan_vese_tpu.models import pyramid as jpyr
from chan_vese_tpu.parallel import mesh as jmesh
from chan_vese_tpu_torch import cli as tcli
from chan_vese_tpu_torch.models import pyramid as tpyr
from chan_vese_tpu_torch.parallel import make_grid_mesh
from fixtures import four_regions, two_disks
from torch_port_helpers import assert_rel, params, to_np, to_torch

CPU = torch.device("cpu")
# the pyramid cell's stopping rule (bench_families.py:166-180)
PYR = dict(init="circle", tol=1e-4, patience=4, min_iter=4, max_iter=300)


@pytest.mark.parametrize("levels", [None, 0, 1, 2, 9, -1])
@pytest.mark.parametrize("min_dim", [16, 128])
def test_plan_levels_matches_reference(levels, min_dim):
    for h, w in ((2160, 3840), (1080, 1920), (96, 160), (130, 512),
                 (64, 64), (31, 64), (512, 512)):
        assert tpyr.plan_levels(h, w, levels, min_dim) \
            == jpyr.plan_levels(h, w, levels, min_dim), (h, w)


@pytest.mark.parametrize("comm_k,halo", [(1, "ppermute"), (4, "ppermute"),
                                         (1, "overlap")])
def test_plan_levels_sharded_matches_reference(comm_k, halo):
    for h, w, nx, ny in ((2160, 3840, 2, 2), (128, 512, 2, 4),
                         (96, 160, 3, 5), (512, 512, 4, 4)):
        for levels in (None, 1, 3):
            assert tpyr.plan_levels_sharded(h, w, nx, ny, levels, 16, comm_k,
                                            halo) \
                == jpyr.plan_levels_sharded(h, w, nx, ny, levels, 16, comm_k,
                                            halo), (h, w, nx, ny, levels)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rgb", [False, True])
def test_downsample2x_is_the_reference_bitwise(dtype, rgb):
    rng = np.random.default_rng(5)
    u = (rng.standard_normal((22, 34, 3) if rgb else (22, 34)) * 97.3
         ).astype(dtype)
    got = tpyr.downsample2x(to_torch(u, dtype))
    want = np.asarray(jpyr.downsample2x(jnp.asarray(u)))
    assert got.dtype == to_torch(u, dtype).dtype
    np.testing.assert_array_equal(to_np(got), want)
    with pytest.raises(ValueError, match="even dims"):
        tpyr.downsample2x(torch.zeros(21, 34))
    with pytest.raises(ValueError, match="even dims"):
        tpyr.downsample2x(torch.zeros(22, 33, 3))


def test_upsample_phi2x_matches_reference_at_the_borders():
    rng = np.random.default_rng(6)
    for h, w in ((13, 17), (8, 8), (1, 5)):
        phi = rng.standard_normal((h, w)) * 31.0
        got = to_np(tpyr.upsample_phi2x(to_torch(phi)))
        want = np.asarray(jpyr.upsample_phi2x(jnp.asarray(phi)))
        assert got.shape == want.shape == (2 * h, 2 * w)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-12 * scale
        # the border rows and columns hold twice the edge cells' values,
        # interpolated along the edge only
        for edge in (got[0], got[-1], got[:, 0], got[:, -1]):
            assert np.isfinite(edge).all()
        assert np.abs(got[0] - want[0]).max() <= 1e-12 * scale
        assert np.abs(got[:, -1] - want[:, -1]).max() <= 1e-12 * scale
        np.testing.assert_allclose(got[0, 0], 2 * phi[0, 0], rtol=1e-15)


def test_upsample_ls2x_is_the_reference():
    ls = (np.random.default_rng(7).random((9, 14)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        to_np(tpyr.upsample_ls2x(to_torch(ls, np.float32))),
        np.asarray(jpyr.upsample_ls2x(jnp.asarray(ls))))


def _pyramid_pair(img, interpret_banded, monkeypatch, **kw):
    pj, pt = params(**PYR)
    if interpret_banded:
        monkeypatch.setattr(jpyr, "segment_banded", functools.partial(
            jbanded.segment_banded, interpret=True))
    want = jpyr.segment_pyramid(jnp.asarray(img), pj, **kw)
    got = tpyr.segment_pyramid(to_torch(img), pt, **kw)
    return got, want


@pytest.mark.parametrize("shape,interpret,min_dim", [
    ((96, 160), False, 16), ((128, 512), True, 32)])
def test_segment_pyramid_matches_reference(shape, interpret, min_dim,
                                           monkeypatch):
    img = two_disks(*shape, noise=5.0)[0]
    got, want = _pyramid_pair(img, interpret, monkeypatch, min_dim=min_dim)
    assert len(got.level_iters) == 3
    assert got.level_iters == want.level_iters
    assert got.iters == int(want.iters) == got.level_iters[-1]
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    # the reference's interpret-mode kernels take the banded means from
    # an f32-accurate Heaviside in f64 (tests/test_torch_packed_band.py)
    assert_rel(got.phi, want.phi, 1e-8 if interpret else 1e-10)
    for name in ("c1", "c2"):
        assert_rel(getattr(got, name), getattr(want, name), 1e-8)


def test_segment_pyramid_start_and_reinit_cadence(monkeypatch):
    """A full-resolution start pooled to the coarsest level, and a reinit
    cadence inside each level (which refuses the banded route in both)."""
    img = two_disks(96, 160, noise=5.0)[0]
    i, j = np.mgrid[0:96, 0:160].astype(np.float64)
    phi0 = 30.0 - np.hypot(i - 40.0, j - 70.0)
    pj, pt = params(reinit_every=4, reinit_steps=6, **PYR)
    want = jpyr.segment_pyramid(jnp.asarray(img), pj, levels=1,
                                phi0=jnp.asarray(phi0), min_dim=16)
    got = tpyr.segment_pyramid(to_torch(img), pt, levels=1,
                               phi0=to_torch(phi0), min_dim=16)
    assert got.level_iters == want.level_iters and len(got.level_iters) == 2
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    assert_rel(got.phi, want.phi, 1e-10)


def test_segment_pyramid_multiphase_matches_reference():
    img = four_regions(64, 64, noise=4.0)[0]
    pj, pt = params(mu=0.003 * 255.0 ** 2, max_iter=200)
    want = jpyr.segment_pyramid_multiphase(jnp.asarray(img), pj, min_dim=16)
    got = tpyr.segment_pyramid_multiphase(to_torch(img), pt, min_dim=16)
    assert got.level_iters == want.level_iters and len(got.level_iters) == 3
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))
    assert_rel(got.phis, want.phis, 1e-10)


def test_segment_pyramid_sharded_matches_reference():
    img = two_disks(64, 128, noise=5.0)[0]
    pj, pt = params(**PYR)
    want = jpyr.segment_pyramid_sharded(jnp.asarray(img), pj,
                                        jmesh.make_grid_mesh(2, 4),
                                        min_dim=16)
    got = tpyr.segment_pyramid_sharded(to_torch(img), pt,
                                       make_grid_mesh(2, 4, [CPU] * 8),
                                       min_dim=16)
    assert got.level_iters == want.level_iters and len(got.level_iters) == 3
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    # the shards' sums are added in another order than the reference's
    # psum, and some 40 iterations a level grow those ulps
    assert_rel(got.phi, want.phi, 1e-8)
    with pytest.raises(ValueError, match="needs a mesh"):
        tpyr.segment_pyramid_sharded(to_torch(img), pt)


@pytest.mark.parametrize("seeded", [False, True])
def test_segment_pyramid_morph_is_the_reference_bitwise(seeded):
    img = two_disks(64, 96, noise=6.0)[0]
    pj, pt = params(max_iter=200)
    ls0 = two_disks(64, 96)[1] if seeded else None
    want = jpyr.segment_pyramid_morph(
        jnp.asarray(img), pj, min_dim=16,
        ls0=None if ls0 is None else jnp.asarray(ls0))
    got = tpyr.segment_pyramid_morph(
        to_torch(img), pt, min_dim=16,
        ls0=None if ls0 is None else torch.from_numpy(ls0))
    assert got.level_iters == want.level_iters and len(got.level_iters) == 3
    np.testing.assert_array_equal(to_np(got.ls), np.asarray(want.ls))


def test_segment_pyramid_gac_is_the_reference_bitwise():
    img = two_disks(64, 96, noise=3.0)[0]
    i, j = np.mgrid[0:64, 0:96]
    seed = (np.hypot(i - 32, j - 48) < 10).astype(np.float64)
    pj, pt = params(max_iter=150)
    kw = dict(min_dim=16, balloon=1, threshold=0.3, gac_alpha=5.0,
              gac_sigma=2.0)
    want = jpyr.segment_pyramid_gac(jnp.asarray(img), pj,
                                    ls0=jnp.asarray(seed), **kw)
    got = tpyr.segment_pyramid_gac(to_torch(img), pt, ls0=to_torch(seed),
                                   **kw)
    assert got.level_iters == want.level_iters and len(got.level_iters) == 3
    np.testing.assert_array_equal(to_np(got.ls), np.asarray(want.ls))


@pytest.mark.parametrize("flags", [
    ["--pyramid", "-1", "--smooth", "3", "--reinit-every", "5"],
    ["--pyramid", "1", "--smooth", "2", "--smooth-kappa", "15"],
    ["--reinit-every", "4", "--iters", "12"],
])
def test_cli_flags_write_the_reference_mask(tmp_path, flags):
    """At 256 x 360 (W % 128: the plain route at every level in both
    packages) the CLI's pyramid, pre-smoothing and reinit flags write the
    reference CLI's mask."""
    img = two_disks(256, 360, noise=5.0)[0]
    src = tmp_path / "img.npy"
    np.save(src, img)
    args = [str(src), "--init", "circle", "--tol", "1e-4"] + flags
    assert jcli.main(args + ["-o", str(tmp_path / "j.npy")]) == 0
    assert tcli.main(args + ["-o", str(tmp_path / "t.npy"),
                             "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"),
                                  np.load(tmp_path / "j.npy"))


def test_cli_pyramid_drops_where_the_reference_drops(tmp_path, capsys):
    img = two_disks(64, 128, noise=5.0)[0]
    src = tmp_path / "img.npy"
    np.save(src, img)
    for extra, path in ((["--iters", "3"], "fixed-iteration"),
                        (["--mesh", "2", "2", "--morph"],
                         "sharded morphological")):
        assert tcli.main([str(src), "--pyramid", "1", "--device", "cpu"]
                         + extra) == 0
        assert f"--pyramid not supported on the {path}" \
            in capsys.readouterr().err
