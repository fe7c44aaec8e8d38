"""The port's MorphACWE path (ops/morph.py, models/morph.py) against the
JAX package on the CPU in float64.

The state is binary and every operator is a shift, min/max, compare or
select, so the level sets are held bit for bit: the operators and
``acwe_step`` on the same inputs, the drivers on the same images and
starts. ``binary_means`` is bitwise on integer-valued images (exact
sums); on continuous ones the two packages sum in other orders, so it is
held at 1e-13 and the drivers' traces at 1e-10. The kernel route runs the
port's plain kernel versions (``use_pallas=True`` on a CPU tensor) against
the JAX kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.models import morph as jm
from chan_vese_tpu.ops import morph as jo
from chan_vese_tpu.params import CVParams as JParams
from chan_vese_tpu.utils.init_phi import init_phi as jinit_phi
from chan_vese_tpu_torch.models import morph as tm
from chan_vese_tpu_torch.models.morph_gac import _init_ls
from chan_vese_tpu_torch.ops import morph as to
from fixtures import iou, two_disks
from torch_port_helpers import params, to_np, to_torch

L1, L2 = (1.0, 0.5, 2.0), (2.0, 1.0, 0.25)


def _img(shape, seed=0, hi=255.0):
    return np.random.default_rng(seed).uniform(0, hi, shape)


def _ls(shape, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=shape) > 0.5).astype(np.float64)


def _rgb(img):
    """The reference's RGB recipe (tests/test_morph.py)."""
    return np.stack([img, 0.5 * img + 30.0, 255.0 - img], axis=-1)


# operators --------------------------------------------------------------

@pytest.mark.parametrize("name", ["sup_inf", "inf_sup", "dilate8", "erode8",
                                  "_neighbors8"])
def test_binary_operators_bitwise(name):
    u = _ls((40, 56), seed=2)
    want = getattr(jo, name)(jnp.asarray(u))
    got = getattr(to, name)(to_torch(u))
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


@pytest.mark.parametrize("k,s", [(0, 1), (1, 1), (3, 2), (2, 0)])
def test_cycle_and_smooth_bitwise(k, s):
    u = _ls((33, 47), seed=3)
    np.testing.assert_array_equal(
        to_np(to.cycle_op(to_torch(u), k)),
        np.asarray(jo.cycle_op(jnp.asarray(u), k)))
    np.testing.assert_array_equal(
        to_np(to.smooth(to_torch(u), k, s)),
        np.asarray(jo.smooth(jnp.asarray(u), k, s)))


@pytest.mark.parametrize("rgb", [False, True])
def test_binary_means(rgb):
    u = _ls((30, 44), seed=4)
    base = np.round(_img((30, 44), seed=5))
    ints = _rgb(base) if rgb else base
    want = jo.binary_means(jnp.asarray(ints), jnp.asarray(u))
    got = to.binary_means(to_torch(ints), to_torch(u))
    for g, w in zip(got, want):  # integer values: exact sums, bitwise
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    cont = _rgb(_img((30, 44), seed=6)) if rgb else _img((30, 44), seed=6)
    want = jo.binary_means(jnp.asarray(cont), jnp.asarray(u))
    got = to.binary_means(to_torch(cont), to_torch(u))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-13)
    # an empty region stays finite
    g = to.binary_means(to_torch(cont), torch.zeros(30, 44,
                                                    dtype=torch.float64))
    assert all(bool(torch.isfinite(x).all()) for x in g)


@pytest.mark.parametrize("rgb", [False, True])
def test_acwe_step_and_energy(rgb):
    u = _ls((36, 52), seed=7)
    img = _rgb(_img((36, 52), seed=8)) if rgb else _img((36, 52), seed=8)
    c_in, c_out = (np.array([90.0, 60.0, 150.0]), np.array([140.0, 90.0,
                                                             110.0])) \
        if rgb else (np.float64(110.0), np.float64(140.0))
    l1, l2 = (np.array(L1), np.array(L2)) if rgb else (1.3, 0.7)
    want = jo.acwe_step(jnp.asarray(u), jnp.asarray(img), jnp.asarray(c_in),
                        jnp.asarray(c_out), jnp.asarray(l1),
                        jnp.asarray(l2))
    tl1, tl2 = (torch.as_tensor(v, dtype=torch.float64) for v in (l1, l2))
    got = to.acwe_step(to_torch(u), to_torch(img), torch.as_tensor(c_in),
                       torch.as_tensor(c_out), tl1, tl2)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    we = jo.acwe_energy(jnp.asarray(img), jnp.asarray(u), jnp.asarray(c_in),
                        jnp.asarray(c_out), jnp.asarray(l1), jnp.asarray(l2))
    ge = to.acwe_energy(to_torch(img), to_torch(u), torch.as_tensor(c_in),
                        torch.as_tensor(c_out), tl1, tl2)
    np.testing.assert_allclose(float(ge), float(we), rtol=1e-13)


@pytest.mark.parametrize("sigma", [0.0, 1.0, 2.5, 5.0])
def test_gaussian_blur(sigma):
    img = _img((40, 52), seed=9)
    np.testing.assert_allclose(
        to_np(to.gaussian_blur(to_torch(img), sigma)),
        np.asarray(jo.gaussian_blur(jnp.asarray(img), sigma)), rtol=1e-12)


@pytest.mark.parametrize("rgb", [False, True])
def test_inverse_gaussian_gradient(rgb):
    img = _rgb(_img((40, 52), seed=10)) if rgb else _img((40, 52), seed=10)
    for alpha, sigma in ((100.0, 5.0), (5.0, 2.0)):
        np.testing.assert_allclose(
            to_np(to.inverse_gaussian_gradient(to_torch(img), alpha, sigma)),
            np.asarray(jo.inverse_gaussian_gradient(jnp.asarray(img), alpha,
                                                    sigma)), rtol=1e-12)


@pytest.mark.parametrize("balloon", [-1, 0, 1])
def test_gac_step_bitwise(balloon):
    u = _ls((36, 52), seed=11)
    g = _img((36, 52), seed=12, hi=1.0)
    dgx, dgy = 0.5 * (np.roll(g, -1, 0) - np.roll(g, 1, 0)), g - 0.5
    mask = (g > 0.4).astype(np.float64)
    want = jo.gac_step(*(jnp.asarray(a) for a in (u, dgx, dgy, mask)),
                       balloon)
    got = to.gac_step(*(to_torch(a) for a in (u, dgx, dgy, mask)), balloon)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("kind", ["checkerboard", "circle", "small disk",
                                  "rect"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_binary_start_matches_reference(kind, dtype):
    shape = (97, 130)
    want = np.asarray(jinit_phi(shape, kind, getattr(jnp, dtype)) >= 0)
    u = torch.zeros(shape, dtype=getattr(torch, dtype))
    got = _init_ls(u, params(init=kind)[1], None)
    assert got.dtype == u.dtype
    np.testing.assert_array_equal(to_np(got), want.astype(dtype))
    ls0 = _ls(shape, seed=13) * 0.7 + 0.2   # >= 0.5 threshold
    np.testing.assert_array_equal(
        to_np(_init_ls(u, params()[1], torch.from_numpy(ls0))),
        (ls0 >= 0.5).astype(dtype))


# drivers ----------------------------------------------------------------

def _gray_rgb(rgb, shape=(48, 64), seed=14):
    img = _img(shape, seed=seed)
    return (_rgb(img), dict(lambda1=L1, lambda2=L2)) if rgb else (img, {})


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("smoothing,start", [(0, 0), (1, 3), (2, 0)])
def test_segment_morph_fixed_matches_reference(rgb, smoothing, start):
    img, lam = _gray_rgb(rgb)
    ls0 = _ls(img.shape[:2], seed=15)
    pj, pt = params()
    want = jm.segment_morph_fixed(jnp.asarray(img), pj, iters=9,
                                  ls0=jnp.asarray(ls0), smoothing=smoothing,
                                  start_iter=start, **lam)
    got = tm.segment_morph_fixed(to_torch(img), pt, iters=9,
                                 ls0=to_torch(ls0), smoothing=smoothing,
                                 start_iter=start, **lam)
    np.testing.assert_array_equal(to_np(got.ls), np.asarray(want.ls))
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    for field in ("energy", "delta", "c1", "c2"):
        np.testing.assert_allclose(to_np(getattr(got, field)),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("route", [False, True])
def test_segment_morph_matches_reference(rgb, route):
    """Tolerance mode on both routes: the plain per-iteration path, and the
    k = 8 chunked kernel route (the port's plain kernel versions against
    the JAX kernel in interpret mode)."""
    img, gt = two_disks(64, 128, noise=8.0)
    img, lam = (_rgb(img), dict(lambda1=(1.0, 1.0, 1.0))) if rgb \
        else (img, {})
    pj, pt = params(max_iter=60)
    kw = dict(use_pallas=True, interpret=True) if route else {}
    want = jm.segment_morph(jnp.asarray(img), pj, **kw, **lam)
    got = tm.segment_morph(to_torch(img), pt, use_pallas=route or None,
                           **lam)
    np.testing.assert_array_equal(to_np(got.ls), np.asarray(want.ls))
    assert got.iters == int(want.iters) < 60
    np.testing.assert_allclose(float(got.delta), float(want.delta),
                               rtol=1e-14)
    np.testing.assert_allclose(to_np(got.c1), np.asarray(want.c1),
                               rtol=1e-10)
    m = to_np(got.mask)
    assert max(iou(m, gt), iou(~m, gt)) >= 0.98


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("route", [False, True])
def test_segment_morph_iterations_matches_reference(rgb, route):
    """19 iterations from an odd start_iter: k = 4 chunks plus a remainder
    of 3 on the kernel route."""
    img, lam = _gray_rgb(rgb, shape=(64, 128), seed=16)
    pj, pt = params()
    kw = dict(iters=19, start_iter=3, k=4)
    want = jm.segment_morph_iterations(
        jnp.asarray(img), pj, use_pallas=route, interpret=route, **kw, **lam)
    got = tm.segment_morph_iterations(to_torch(img), pt, use_pallas=route,
                                      **kw, **lam)
    np.testing.assert_array_equal(to_np(got.ls), np.asarray(want.ls))
    assert got.iters == int(want.iters) == 19
    np.testing.assert_allclose(to_np(got.c2), np.asarray(want.c2),
                               rtol=1e-10)


def test_segment_morph_iterations_fuse_force_matches_reference():
    img = _img((64, 128), seed=17)
    pj, pt = params()
    kw = dict(iters=19, k=4)
    want = jm.segment_morph_iterations(jnp.asarray(img), pj, use_pallas=True,
                                       interpret=True, fuse_force=True, **kw)
    got = tm.segment_morph_iterations(to_torch(img), pt, use_pallas=True,
                                      fuse_force=True, **kw)
    np.testing.assert_array_equal(to_np(got.ls), np.asarray(want.ls))
    unfused = tm.segment_morph_iterations(to_torch(img), pt, use_pallas=True,
                                          **kw)
    np.testing.assert_array_equal(to_np(got.ls), to_np(unfused.ls))


def test_fuse_force_rgb_raises():
    """Intended difference: the reference ignores fuse_force=True for an
    (H, W, C) image (chan_vese_tpu/models/morph.py:339); the port
    raises."""
    img = _rgb(_img((64, 128), seed=18))
    want = jm.segment_morph_iterations(jnp.asarray(img), JParams(), iters=3,
                                       fuse_force=True)
    assert np.asarray(want.ls).shape == (64, 128)
    with pytest.raises(ValueError, match="fuse_force"):
        tm.segment_morph_iterations(to_torch(img), params()[1], iters=3,
                                    fuse_force=True)


def test_nan_image_aborts_and_constant_image_is_finite():
    img = np.full((64, 128), 100.0)
    img[3, 3] = np.nan
    for route in (False, True):
        pj, pt = params(max_iter=500)
        kw = dict(use_pallas=True, interpret=True) if route else {}
        want = jm.segment_morph(jnp.asarray(img), pj, **kw)
        got = tm.segment_morph(to_torch(img), pt, use_pallas=route or None)
        assert got.iters == int(want.iters) < 500
        assert not np.isfinite(float(got.delta))
    const = np.full((32, 32), 127.0)
    pj, pt = params(max_iter=50)
    want = jm.segment_morph(jnp.asarray(const), pj)
    got = tm.segment_morph(to_torch(const), pt)
    assert got.iters == int(want.iters)
    assert np.isfinite(to_np(got.c1)).all() and np.isfinite(float(got.delta))


def test_start_iter_chunking_equals_one_run():
    img = _img((24, 24), seed=5)
    ls0 = _ls((24, 24), seed=6)
    pt = params()[1]
    a = tm.segment_morph_fixed(to_torch(img), pt, iters=1, ls0=to_torch(ls0),
                               start_iter=0)
    b = tm.segment_morph_fixed(to_torch(img), pt, iters=1, ls0=to_torch(ls0),
                               start_iter=1)
    assert bool((a.ls != b.ls).any())  # the alternation matters
    two = tm.segment_morph_fixed(to_torch(img), pt, iters=1, ls0=a.ls,
                                 start_iter=1)
    whole = tm.segment_morph_fixed(to_torch(img), pt, iters=2,
                                   ls0=to_torch(ls0))
    np.testing.assert_array_equal(to_np(two.ls), to_np(whole.ls))
    lean = tm.segment_morph_iterations(to_torch(img), pt, iters=11,
                                       start_iter=3)
    traced = tm.segment_morph_fixed(to_torch(img), pt, iters=11,
                                    start_iter=3)
    np.testing.assert_array_equal(to_np(lean.ls), to_np(traced.ls))


def test_auto_route_is_plain_on_cpu_and_explicit_route_checks_geometry():
    img = _img((30, 100), seed=19)
    with pytest.raises(ValueError, match="unsupported"):
        tm.segment_morph(to_torch(img), params()[1], use_pallas=True)
    with pytest.raises(ValueError, match="unsupported"):
        tm.segment_morph_iterations(to_torch(_img((64, 128))), params()[1],
                                    iters=4, use_pallas=True, k=3)
    from chan_vese_tpu_torch.models.morph_gac import _route_kernel
    assert _route_kernel((64, 128), None, 1, "acwe", None, False) == (False,
                                                                     8)
    assert _route_kernel((64, 128), None, 1, "acwe", None, True) == (True, 8)
    assert _route_kernel((64, 128), 3, 1, "acwe", None, True) == (False, 3)


def test_cli_morph(tmp_path, capsys):
    """``--morph`` with ``--device cpu``: the tolerance run writes
    segment_morph's mask, ``--iters`` segment_morph_fixed's, ``--color``
    takes per-channel lambdas, ``--multiphase`` drops the flag with a
    warning, and a NaN image exits 1 without output."""
    from chan_vese_tpu_torch import cli

    img, gt = two_disks(96, 96, noise=6.0)
    src, out = tmp_path / "in.npy", tmp_path / "mask.npy"
    np.save(src, img.astype(np.float32))
    u = torch.from_numpy(img.astype(np.float32))
    pt = params()[1]
    assert cli.main([str(src), "--morph", "-o", str(out), "--device",
                     "cpu"]) == 0
    np.testing.assert_array_equal(np.load(out) > 127,
                                  to_np(tm.segment_morph(u, pt).mask))
    assert cli.main([str(src), "--morph", "--iters", "7",
                     "--morph-smoothing", "2", "-o", str(out), "--device",
                     "cpu"]) == 0
    np.testing.assert_array_equal(
        np.load(out) > 127,
        to_np(tm.segment_morph_fixed(u, pt, iters=7, smoothing=2).mask))
    src_rgb = tmp_path / "rgb.npy"
    np.save(src_rgb, _rgb(img).astype(np.float32))
    assert cli.main([str(src_rgb), "--morph", "--color", "--lambda1", "1",
                     "1", "1", "-o", str(out), "--device", "cpu"]) == 0
    m = np.load(out) > 127
    assert max(iou(m, gt), iou(~m, gt)) >= 0.97
    capsys.readouterr()
    assert cli.main([str(src), "--morph", "--multiphase", "2", "-o",
                     str(out), "--device", "cpu"]) == 0
    assert "--morph not supported on the multiphase path" in \
        capsys.readouterr().err
    bad = img.copy()
    bad[3, 3] = np.nan
    np.save(src, bad.astype(np.float32))
    out.unlink()
    assert cli.main([str(src), "--morph", "-o", str(out), "--device",
                     "cpu"]) == 1
    assert not out.exists()
