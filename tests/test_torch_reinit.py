"""The port's redistancing (ops/reinit.py), Perona-Malik pre-smoothing
(ops/diffusion.py) and the reinit hooks of the fused and banded drivers
against the JAX reference on the CPU, in f64.

- ``reinit`` (steps 1, 5, 20; odd and non-square shapes; exact zeros; a
  steep level set whose subcell estimate hits the +-1.5 h clip; a stack,
  each frame on its own), ``_godunov_grad`` and ``maybe_reinit`` (2-D and
  3-D, the cadence and its shift) within 1e-10 of the level set's scale,
  signs identical.
- ``perona_malik``: both conductances, gray and RGB, within 1e-12; an
  unknown conductance raises.
- The fused drivers with a cadence against the reference's kernel route
  (interpret mode): the means taken anew on every iteration, the metric
  from before the redistance; the banded driver refuses the banded route
  under a cadence and runs the fused one, as the reference.

Kernel R1 itself is held against ``reinit_reference`` on the card in
tests/test_torch_kernels_reinit.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.models import banded as jbanded
from chan_vese_tpu.models import fused as jfused
from chan_vese_tpu_torch.models import banded as tbanded
from chan_vese_tpu_torch.models import fused as tfused
from fixtures import colored_squares, two_disks
from torch_port_helpers import assert_rel, params, to_np, to_torch

# the ops packages export the functions under the modules' names
jreinit = importlib.import_module("chan_vese_tpu.ops.reinit")
jdiff = importlib.import_module("chan_vese_tpu.ops.diffusion")
treinit = importlib.import_module("chan_vese_tpu_torch.ops.reinit")
tdiff = importlib.import_module("chan_vese_tpu_torch.ops.diffusion")

TOL = 1e-10


def level_set(h, w, kind, seed=0):
    """A noisy disk SDF with exact zeros, or a steep one (slope 40) whose
    crossing cells' central gradient nearly vanishes at a ridge."""
    rng = np.random.default_rng(seed)
    i, j = np.mgrid[0:h, 0:w].astype(np.float64)
    r = np.hypot(i - 0.45 * h, j - 0.4 * w)
    if kind == "steep":
        phi = 40.0 * (0.3 * min(h, w) - r)
        phi[h // 2, :] = 40.0 * np.where(np.arange(w) % 2, 1.0, -1.0)
        return phi
    phi = 0.3 * min(h, w) - r + 0.7 * rng.standard_normal((h, w))
    phi[2, 3] = 0.0
    phi[h // 2, : w // 3] = 0.0
    return phi


def _same_signs(got, want):
    np.testing.assert_array_equal(np.sign(to_np(got)),
                                  np.sign(np.asarray(want)))


@pytest.mark.parametrize("shape", [(17, 23), (24, 24), (9, 40)])
@pytest.mark.parametrize("kind", ["disk", "steep"])
@pytest.mark.parametrize("steps", [1, 5, 20])
def test_reinit_matches_reference(shape, kind, steps):
    phi = level_set(*shape, kind)
    want = jreinit.reinit(jnp.asarray(phi), steps)
    got = treinit.reinit(to_torch(phi), steps)
    assert_rel(got, want, TOL)
    _same_signs(got, want)


def test_steep_level_set_hits_the_clip():
    """The subcell estimate h phi0 / |grad phi0| exceeds 1.5 h on the
    steep set's ridge: the clipped value is what both packages use."""
    phi = level_set(24, 32, "steep")
    t = to_torch(phi)
    gx = 0.5 * (treinit._down(t) - treinit._up(t))
    gy = 0.5 * (treinit._right(t) - treinit._left(t))
    raw = t / torch.sqrt(gx * gx + gy * gy).clamp(min=1e-12)
    assert float(raw.abs().max()) > 1.5
    for dtau, h in ((0.5, 1.0), (0.3, 0.5)):
        want = jreinit.reinit(jnp.asarray(phi), 3, dtau, h)
        got = treinit.reinit(t, 3, dtau, h)
        assert_rel(got, want, TOL)


def test_godunov_grad_matches_reference():
    psi = level_set(19, 26, "disk", seed=3)
    sgn = level_set(19, 26, "disk", seed=4)
    want = jreinit._godunov_grad(jnp.asarray(psi), jnp.asarray(sgn))
    got = treinit._godunov_grad(to_torch(psi), to_torch(sgn))
    assert_rel(got, want, TOL)


def test_reinit_stack_is_per_frame():
    frames = np.stack([level_set(20, 28, "disk", seed=s) for s in range(3)])
    got = treinit.reinit(to_torch(frames), 7)
    for m in range(3):
        want = jreinit.reinit(jnp.asarray(frames[m]), 7)
        assert_rel(got[m], want, TOL)
        torch.testing.assert_close(got[m], treinit.reinit(to_torch(frames[m]),
                                                          7), rtol=0, atol=0)


@pytest.mark.parametrize("n", [0, 3, 4, 9])
@pytest.mark.parametrize("stack", [False, True])
def test_maybe_reinit_cadence(n, stack):
    pj, pt = params(reinit_every=5, reinit_steps=6)
    x = (np.stack([level_set(16, 21, "disk", seed=s) for s in range(2)])
         if stack else level_set(16, 21, "disk"))
    want = jreinit.maybe_reinit(jnp.asarray(x), n, pj)
    got = treinit.maybe_reinit(to_torch(x), n, pt)
    assert_rel(got, want, TOL)
    fired = (n + 1) % 5 == 0
    assert np.array_equal(to_np(got), x) != fired
    off = treinit.maybe_reinit(to_torch(x), n, pt.replace(reinit_every=0))
    assert np.array_equal(to_np(off), x)


@pytest.mark.parametrize("kind", ["exp", "frac"])
@pytest.mark.parametrize("rgb", [False, True])
def test_perona_malik_matches_reference(kind, rgb):
    u = (colored_squares(24, 40, noise=12.0)[0] if rgb
         else two_disks(24, 40, noise=12.0)[0])
    want = jdiff.perona_malik(jnp.asarray(u), 7, 12.0, 0.2, kind)
    got = tdiff.perona_malik(to_torch(u), 7, 12.0, 0.2, kind)
    assert got.shape == u.shape
    assert_rel(got, want, 1e-12)


def test_perona_malik_unknown_conductance_raises():
    with pytest.raises(ValueError, match="unknown conductance"):
        tdiff.perona_malik(torch.zeros(8, 8), 3, conductance="tanh")
    with pytest.raises(ValueError, match="unknown conductance"):
        tdiff.perona_malik(torch.zeros(8, 8, 3), 0, conductance="tanh")


# the drivers' hooks --------------------------------------------------------

@pytest.fixture(scope="module")
def gray():
    return two_disks(32, 128, noise=8.0)[0]


@pytest.mark.parametrize("fixed", [False, True])
def test_segment_fused_reinit_matches_reference(gray, fixed):
    """The kernel route (the plain version on the CPU, interpret mode in
    the reference) with the means taken anew every iteration."""
    pj, pt = params(init="circle", reinit_every=3, reinit_steps=5,
                    max_iter=40)
    if fixed:
        want = jfused.segment_fused_fixed(jnp.asarray(gray), pj, iters=11,
                                          interpret=True)
        got = tfused.segment_fused_fixed(to_torch(gray), pt, iters=11)
        assert_rel(got[0], want[0], TOL)
        np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
        return
    want = jfused.segment_fused(jnp.asarray(gray), pj, interpret=True)
    got = tfused.segment_fused(to_torch(gray), pt)
    assert got.iters == int(want.iters)
    assert_rel(got.phi, want.phi, TOL)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    for name in ("c1", "c2", "delta"):
        assert_rel(getattr(got, name), getattr(want, name), TOL)


def test_segment_fused_reinit_off_envelope_matches_reference():
    """Off the fused envelope (W % 128) the plain driver with its
    cadence, gray fixed and RGB tolerance mode."""
    pj, pt = params(init="circle", reinit_every=4, reinit_steps=5,
                    max_iter=30)
    img = two_disks(24, 40, noise=8.0)[0]
    want = jfused.segment_fused_fixed(jnp.asarray(img), pj, iters=9)
    got = tfused.segment_fused_fixed(to_torch(img), pt, iters=9)
    assert_rel(got[0], want[0], TOL)
    rgb = colored_squares(24, 40, noise=8.0)[0]
    want = jfused.segment_fused(jnp.asarray(rgb), pj)
    got = tfused.segment_fused(to_torch(rgb), pt)
    assert got.iters == int(want.iters)
    assert_rel(got.phi, want.phi, TOL)


def test_segment_banded_refuses_the_banded_route_under_reinit(gray,
                                                              monkeypatch):
    pj, pt = params(init="circle", reinit_every=3, reinit_steps=5)
    u = to_torch(gray)
    assert tbanded._supported(u, pt.replace(reinit_every=0), 2)
    for k in (2, 8):
        assert not tbanded._supported(u, pt, k)
        assert not jbanded._supported(jnp.asarray(gray), pj, k)
    launched = []
    monkeypatch.setattr(tbanded.banded_kernel, "banded_chunk",
                        lambda *a, **k: launched.append(1))
    got = tbanded.segment_banded_fixed(u, pt, iters=7, k=2)
    want = jbanded.segment_banded_fixed(jnp.asarray(gray), pj, iters=7,
                                        k=2, interpret=True)
    assert not launched
    assert_rel(got[0], want[0], TOL)


def test_every_caller_reaches_the_redistance_through_the_module(
        gray, monkeypatch):
    """The cadence of the drivers, the pyramid's level boundaries and the
    sharded cadence all call ``ops.reinit.reinit`` through the module,
    where one patch reaches them, and fire on ``reinit_fires``."""
    from chan_vese_tpu_torch.models.pyramid import segment_pyramid
    from chan_vese_tpu_torch.parallel import make_grid_mesh, segment_sharded

    seen = []
    real = treinit.reinit

    def counted(phi, *args, **kw):
        seen.append(tuple(phi.shape))
        return real(phi, *args, **kw)

    monkeypatch.setattr(treinit, "reinit", counted)
    pt = params(init="circle", reinit_every=3, reinit_steps=4)[1]
    assert [n for n in range(9) if treinit.reinit_fires(n, pt)] == [2, 5, 8]
    assert not treinit.reinit_fires(2, pt.replace(reinit_every=0))
    u = to_torch(gray)
    tfused.segment_fused_fixed(u, pt, iters=7)
    assert seen == [(32, 128)] * 2
    seen.clear()
    mesh = make_grid_mesh(2, 2, [torch.device("cpu")] * 4)
    segment_sharded(u, pt, mesh, fixed=True, max_iter=3, use_pallas=False)
    assert seen == [(16 + 8, 64 + 8)] * 4  # a 4-deep halo round each shard
    seen.clear()
    segment_pyramid(u, pt.replace(reinit_every=0, max_iter=6), levels=1,
                    min_dim=16)
    assert seen == [(32, 128)]  # the level boundary's redistance
