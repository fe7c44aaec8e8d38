"""The port's MorphGAC path (models/morph_gac.py) against the JAX package on
the CPU in float64: the loop invariants, the tolerance and fixed drivers
and the lean driver with ``pre_dg`` on and off, on the plain route and on
the kernel route (the port's plain kernel versions against the JAX
kernels in interpret mode). GAC has no reduction in its loop, so every
route is held bit for bit on the level set, with equal iteration counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from chan_vese_tpu.models import morph_gac as jg
from chan_vese_tpu_torch.models import morph_gac as tg
from fixtures import iou
from torch_port_helpers import params, to_np, to_torch


def _edge_map(shape, seed):
    return np.random.default_rng(seed).uniform(0.05, 1.0, shape)


def _ls(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=shape) > 0.5).astype(np.float64)


def _disk_image(h, w, r):
    """A bright disk on a dark background, its edge map (the recipe of
    tests/test_morph_gac.py) and a disk seed 4 px larger."""
    from chan_vese_tpu.ops.morph import inverse_gaussian_gradient

    i, j = np.mgrid[0:h, 0:w]
    d = np.hypot(i - h / 2, j - w / 2)
    img = np.where(d < r, 200.0, 30.0)
    g = np.array(inverse_gaussian_gradient(jnp.asarray(img), 5.0, 2.0))
    return g, d < r, (d < r + 4).astype(np.float64)


@pytest.mark.parametrize("balloon,threshold", [(-1, 0.4), (0, 0.4),
                                               (2, 0.7)])
def test_prep_matches_reference(balloon, threshold):
    g = _edge_map((40, 52), 0)
    want = jg._prep(jnp.asarray(g), balloon, threshold)
    got = tg._prep(to_torch(g), balloon, threshold)
    for w, x in zip(want, got):
        np.testing.assert_array_equal(to_np(x), np.asarray(w))


@pytest.mark.parametrize("route", [False, True])
@pytest.mark.parametrize("balloon", [-1, 1])
def test_segment_gac_matches_reference(route, balloon):
    g, truth, seed = _disk_image(64, 128, 20)
    ls0 = seed if balloon < 0 else (
        np.hypot(*np.mgrid[-32:32, -64:64]) < 8).astype(np.float64)
    pj, pt = params(max_iter=150)
    kw = dict(balloon=balloon, threshold=0.3, use_pallas=route)
    want = jg.segment_gac(jnp.asarray(g), pj, ls0=jnp.asarray(ls0),
                          interpret=route, **kw)
    got = tg.segment_gac(to_torch(g), pt, ls0=to_torch(ls0), **kw)
    np.testing.assert_array_equal(to_np(got.ls), np.asarray(want.ls))
    assert got.iters == int(want.iters) < 150
    np.testing.assert_allclose(float(got.delta), float(want.delta),
                               rtol=1e-14)
    assert iou(to_np(got.mask), truth) >= 0.95


@pytest.mark.parametrize("smoothing,start", [(1, 0), (2, 3), (0, 1)])
def test_segment_gac_fixed_matches_reference(smoothing, start):
    g = _edge_map((48, 64), 1)
    ls0 = _ls((48, 64), 2)
    pj, pt = params()
    kw = dict(iters=9, smoothing=smoothing, balloon=1, threshold=0.45,
              start_iter=start)
    want = jg.segment_gac_fixed(jnp.asarray(g), pj, ls0=jnp.asarray(ls0),
                                **kw)
    got = tg.segment_gac_fixed(to_torch(g), pt, ls0=to_torch(ls0), **kw)
    np.testing.assert_array_equal(to_np(got.ls), np.asarray(want.ls))
    # flip fractions: count / N, divided in another way by XLA (1 ulp)
    np.testing.assert_allclose(to_np(got.delta), np.asarray(want.delta),
                               rtol=1e-14)


@pytest.mark.parametrize("route", [False, True])
@pytest.mark.parametrize("pre_dg", [True, False])
def test_segment_gac_iterations_matches_reference(route, pre_dg):
    """19 iterations from start_iter 1: k = 4 chunks and a remainder of 3
    on the kernel route."""
    g = _edge_map((96, 128), 3)
    ls0 = _ls((96, 128), 4)
    pj, pt = params()
    kw = dict(iters=19, smoothing=1, balloon=1, threshold=0.35,
              start_iter=1, pre_dg=pre_dg)
    want = jg.segment_gac_iterations(jnp.asarray(g), pj,
                                     ls0=jnp.asarray(ls0), use_pallas=route,
                                     interpret=route, **kw)
    got = tg.segment_gac_iterations(to_torch(g), pt, ls0=to_torch(ls0),
                                    use_pallas=route, **kw)
    np.testing.assert_array_equal(to_np(got.ls), np.asarray(want.ls))
    assert got.iters == int(want.iters) == 19
    fixed = tg.segment_gac_fixed(to_torch(g), pt, ls0=to_torch(ls0),
                                 iters=19, smoothing=1, balloon=1,
                                 threshold=0.35, start_iter=1)
    np.testing.assert_array_equal(to_np(got.ls), to_np(fixed.ls))


def test_nan_edge_map_aborts():
    g = _edge_map((64, 128), 5)
    g[10, 10] = np.nan
    for route in (False, True):
        pj, pt = params(max_iter=200)
        want = jg.segment_gac(jnp.asarray(g), pj, balloon=1, threshold=0.3,
                              use_pallas=route, interpret=route)
        got = tg.segment_gac(to_torch(g), pt, balloon=1, threshold=0.3,
                             use_pallas=route)
        assert got.iters == int(want.iters) < 200
        assert not np.isfinite(float(got.delta))


def test_route_rejects_unsupported_geometry():
    g = to_torch(_edge_map((30, 100), 6))
    with pytest.raises(ValueError, match="unsupported"):
        tg.segment_gac_iterations(g, params()[1], iters=8, use_pallas=True)
    with pytest.raises(ValueError, match="unsupported"):
        tg.segment_gac(g, params()[1], use_pallas=True)
    # auto on a CPU tensor: the plain path, as the reference off its TPU
    assert tg._route_kernel((96, 128), None, 1, "gac_pre", None,
                            False) == (False, 4)
    assert tg._route_kernel((96, 128), None, 1, "gac_pre", None,
                            True) == (True, 4)


def test_cli_morph_gac(tmp_path):
    """``--morph-gac`` with ``--device cpu``: the edge map of the image,
    the 40th-percentile threshold by default, segment_gac's mask in
    tolerance mode and segment_gac_fixed's with ``--iters``."""
    from chan_vese_tpu_torch import cli
    from chan_vese_tpu_torch.ops.morph import inverse_gaussian_gradient

    i, j = np.mgrid[0:96, 0:96]
    truth = np.hypot(i - 48, j - 48) < 28
    img = np.where(truth, 220.0, 20.0).astype(np.float32)
    src, out = tmp_path / "in.npy", tmp_path / "mask.npy"
    np.save(src, img)
    pt = params(init="disk")[1]
    g = inverse_gaussian_gradient(to_torch(img, np.float32), 5.0, 2.0)
    assert cli.main([str(src), "--morph-gac", "--balloon", "-1",
                     "--gac-alpha", "5", "--gac-sigma", "2",
                     "--gac-threshold", "0.3", "--init", "disk", "-o",
                     str(out), "--device", "cpu"]) == 0
    want = tg.segment_gac(g, pt, balloon=-1, threshold=0.3)
    np.testing.assert_array_equal(np.load(out) > 127, to_np(want.mask))
    g = inverse_gaussian_gradient(to_torch(img, np.float32))
    thr = float(np.percentile(to_np(g), 40))
    assert cli.main([str(src), "--morph-gac", "--iters", "9", "-o",
                     str(out), "--device", "cpu"]) == 0
    want = tg.segment_gac_fixed(g, params()[1], iters=9, threshold=thr)
    np.testing.assert_array_equal(np.load(out) > 127, to_np(want.mask))
