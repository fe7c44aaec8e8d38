"""The port's scikit-image compatible front ends (compat.py) against
``chan_vese_tpu.compat`` on the CPU (``device="cpu"``; both work in
float32 as the reference does).

The morphological functions return int8 level sets, held bit for bit
(binary state; the f32 means of the two packages may differ in the last
ulp, which could flip a cell only at an exact force-sign tie). The edge map
is held at 5e-7 relative: both blur in float32 with the same weights, and
about 1% of the cells differ, by at most 1.5e-7 (two ulps). ``chan_vese`` runs the plain f32 driver in
both packages: masks and iteration counts equal, phi by its sign (from the
checkerboard start the f32 trajectory amplifies last-ulp differences).
"""

import numpy as np
import pytest
import torch

from chan_vese_tpu import compat as jc
from chan_vese_tpu_torch import compat as tc
from fixtures import iou, two_disks

CPU = dict(device="cpu")


def _disk_scene(h=64, w=96, r=18):
    i, j = np.mgrid[0:h, 0:w]
    d = np.hypot(i - h / 2, j - w / 2)
    return np.where(d < r, 200.0, 30.0).astype(np.float32), d < r


@pytest.mark.parametrize("shape,kw", [((10, 12), {}),
                                      ((33, 47), dict(square_size=3)),
                                      ((64, 64), {})])
def test_level_set_helpers_match_reference(shape, kw):
    a, b = tc.checkerboard_level_set(shape, **kw), \
        jc.checkerboard_level_set(shape, **kw)
    assert a.dtype == b.dtype == np.int8
    np.testing.assert_array_equal(a, b)
    for dkw in ({}, dict(center=(10, 20), radius=7.5)):
        a, b = tc.disk_level_set(shape, **dkw), jc.disk_level_set(shape,
                                                                  **dkw)
        assert a.dtype == np.int8
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rgb", [False, True])
def test_chan_vese_matches_reference(rgb):
    img, gt = two_disks(48, 64, noise=6.0)
    if rgb:
        img = np.stack([img, 0.5 * img + 30.0, 255.0 - img], axis=-1)
    kw = dict(max_num_iter=60, lambda1=(1.0, 1.0, 1.0) if rgb else 1.0)
    want_mask, want_phi, want = jc.chan_vese(img, extended_output=True, **kw)
    mask, phi, res = tc.chan_vese(img, extended_output=True, **kw, **CPU)
    assert mask.dtype == bool and mask.shape == (48, 64)
    np.testing.assert_array_equal(mask, np.asarray(want_mask))
    assert res.iters == int(want.iters)
    # in f32 the checkerboard start's trajectory is ill-conditioned (ulps
    # grow to ~1 on a phi of ~40, PERF.md): phi is held by its sign
    np.testing.assert_array_equal(phi >= 0, mask)
    assert max(iou(mask, gt), iou(~mask, gt)) >= 0.98
    # [0, 1] inputs are rescaled; a custom phi0 array is used as is
    np.testing.assert_array_equal(
        tc.chan_vese(img / 255.0, max_num_iter=5, **CPU),
        jc.chan_vese(img / 255.0, max_num_iter=5))
    phi0 = np.where(gt, 1.0, -1.0)
    np.testing.assert_array_equal(
        tc.chan_vese(img, max_num_iter=5, init_level_set=phi0, **CPU),
        jc.chan_vese(img, max_num_iter=5, init_level_set=phi0))


def test_chan_vese_errors_match_reference():
    img = np.zeros((16, 16), np.float32)
    for kw in (dict(lambda1=(1.0, 2.0)), dict(init_level_set=np.zeros((3,
                                                                       3)))):
        with pytest.raises(ValueError):
            jc.chan_vese(img, **kw)
        with pytest.raises(ValueError):
            tc.chan_vese(img, **kw, **CPU)


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((16, 16), np.float32)
    for fn, args in ((tc.chan_vese, (img,)),
                     (tc.morphological_chan_vese, (img, 2)),
                     (tc.inverse_gaussian_gradient, (img,)),
                     (tc.morphological_geodesic_active_contour, (img, 2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)


@pytest.mark.parametrize("rgb,smoothing,init", [
    (False, 1, "checkerboard"), (False, 2, "disk"), (True, 1, "circle")])
def test_morphological_chan_vese_matches_reference(rgb, smoothing, init):
    img = np.random.default_rng(6).uniform(0, 255, (30, 35))
    kw = dict(smoothing=smoothing, init_level_set=init)
    if rgb:
        img = np.stack([img, 0.5 * img + 30.0, 255.0 - img], axis=-1)
        kw.update(lambda1=(1.0, 0.5, 2.0), lambda2=2.0)
    want = jc.morphological_chan_vese(img, 9, **kw)
    got = tc.morphological_chan_vese(img, 9, **kw, **CPU)
    assert got.dtype == np.int8 and got.shape == (30, 35)
    np.testing.assert_array_equal(got, want)


def test_morphological_chan_vese_callback_and_errors():
    img, gt = two_disks(48, 48, noise=5.0)
    want, got = [], []
    a = jc.morphological_chan_vese(img, 7, iter_callback=want.append)
    b = tc.morphological_chan_vese(img, 7, iter_callback=got.append, **CPU)
    assert len(got) == len(want) == 8  # the start and one per iteration
    for x, y in zip(got, want):
        assert x.dtype == np.int8
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(b, tc.morphological_chan_vese(img, 7,
                                                                **CPU))
    seeded = tc.morphological_chan_vese(
        img, 60, init_level_set=tc.disk_level_set(img.shape), **CPU)
    assert iou(seeded > 0, gt) >= 0.98
    for bad in (np.zeros((3, 3)), "blob"):
        with pytest.raises(ValueError):
            jc.morphological_chan_vese(img, 5, init_level_set=bad)
        with pytest.raises(ValueError):
            tc.morphological_chan_vese(img, 5, init_level_set=bad, **CPU)


@pytest.mark.parametrize("rgb", [False, True])
def test_inverse_gaussian_gradient_matches_reference(rgb):
    img = np.random.default_rng(7).uniform(0, 255, (40, 52))
    if rgb:
        img = np.stack([img, 255.0 - img, 0.3 * img], axis=-1)
    for alpha, sigma in ((100.0, 5.0), (5.0, 2.0)):
        want = jc.inverse_gaussian_gradient(img, alpha, sigma)
        got = tc.inverse_gaussian_gradient(img, alpha, sigma, **CPU)
        assert got.dtype == np.float32 and got.shape == (40, 52)
        np.testing.assert_allclose(got, want, rtol=5e-7)


@pytest.mark.parametrize("balloon,threshold,init", [
    (-1, 0.3, "disk"), (1, "auto", "checkerboard"), (0, "auto", "circle")])
def test_morphological_gac_matches_reference(balloon, threshold, init):
    img, truth = _disk_scene()
    g = jc.inverse_gaussian_gradient(img, 5.0, 2.0)
    kw = dict(smoothing=1, threshold=threshold, balloon=balloon,
              init_level_set=init)
    want = jc.morphological_geodesic_active_contour(g, 40, **kw)
    got = tc.morphological_geodesic_active_contour(g, 40, **kw, **CPU)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    if balloon < 0:
        assert iou(got > 0, truth) >= 0.95


def test_morphological_gac_callback_and_errors():
    img, _ = _disk_scene()
    g = jc.inverse_gaussian_gradient(img, 5.0, 2.0)
    want, got = [], []
    a = jc.morphological_geodesic_active_contour(
        g, 6, balloon=-1, threshold=0.3, iter_callback=want.append)
    b = tc.morphological_geodesic_active_contour(
        g, 6, balloon=-1, threshold=0.3, iter_callback=got.append, **CPU)
    assert len(got) == len(want) == 7
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(b, a)
    for args, kw in (((np.zeros((4, 4, 3)), 3), {}),
                     ((g, 3), dict(init_level_set=np.zeros((3, 3)))),
                     ((g, 3), dict(init_level_set="blob"))):
        with pytest.raises(ValueError):
            jc.morphological_geodesic_active_contour(*args, **kw)
        with pytest.raises(ValueError):
            tc.morphological_geodesic_active_contour(*args, **kw, **CPU)
