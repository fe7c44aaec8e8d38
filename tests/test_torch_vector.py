"""The vector-valued (RGB) slice of the port against the JAX reference.

- The vector data term, energy and step, and the plain vector drivers
  (models/vector.py), in f64 against the jnp functions to 1e-10.
- The mc drivers of models/fused.py (K4) and models/banded.py (K5, K6) in
  f32 against the JAX drivers with the Pallas kernels in interpret mode,
  flat and packed: identical masks and equal iteration counts, phi at
  tests/test_banded.py's driver bar (rtol 3e-5 / atol 3e-4) except over
  the fused tolerance run (see its test).
- auto_config_mc, the fallback routes and the CLI's --color route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu import cli as jcli
from chan_vese_tpu.models import banded as jbanded
from chan_vese_tpu.models import fused as jfused
from chan_vese_tpu.models import scalar as jscalar
from chan_vese_tpu.models import vector as jvector
from chan_vese_tpu.ops import reductions as jr
from chan_vese_tpu_torch import cli
from chan_vese_tpu_torch.models import banded as tbanded
from chan_vese_tpu_torch.models import fused as tfused
from chan_vese_tpu_torch.models import scalar as tscalar
from chan_vese_tpu_torch.models import vector as tvector
from chan_vese_tpu_torch.ops import (banded_kernel, fused_kernel_mc,
                                     packed_kernel)
from chan_vese_tpu_torch.ops import reductions as tr
from fixtures import colored_squares, iou
from torch_port_helpers import assert_rel, cuda_device, params, to_np, \
    to_torch

LAM = (1.0, 1.2, 0.8)
# The drivers take LAM inside and outside. With lambda1 != lambda2 in a
# channel the force does not vanish where c1 = c2, and from the symmetric
# checkerboard start last-ulp differences between two evaluation orders
# grow by orders of magnitude per iteration (5e-8 relative in f64 after 30
# iterations, 0.2 of phi's 22 in f32 after 11); a circle start is as
# sensitive in f32 for this image. Single steps take lambda2 = 1.
LAMS = dict(lambda1=LAM, lambda2=LAM)
RTOL = 1e-10
SHAPE = (96, 256)
TOL = dict(rtol=3e-5, atol=3e-4)
KW = dict(tol=1e-4, max_iter=200, min_iter=10)
MC_KERNELS = (fused_kernel_mc.fused_iteration_mc,
              banded_kernel.banded_chunk_mc,
              packed_kernel.packed_banded_chunk_mc)


@pytest.fixture(scope="module")
def small():
    """(24, 40, 3) f64 image and a level set through it."""
    img, _ = colored_squares(24, 40, noise=8.0)
    rng = np.random.default_rng(5)
    return img, rng.standard_normal((24, 40)) * 3.0


# f64: the vector numerics and the plain drivers ---------------------------

@pytest.mark.parametrize("lam", [LAM, None])
def test_vector_data_term_energy_step_f64(small, lam):
    img, phi = small
    pj, pt = params(nu=2.0)
    ju, jp = jnp.asarray(img), jnp.asarray(phi)
    tu, tp = to_torch(img), to_torch(phi)
    jc1, jc2 = jr.region_means(ju, jp, 1.0)
    tc1, tc2 = tr.region_means(tu, tp, 1.0)
    assert tuple(tc1.shape) == (3,)
    assert_rel(tc1, jc1, RTOL)
    assert_rel(tc2, jc2, RTOL)
    l1 = pt.lambda1 if lam is None else lam
    assert_rel(tr.data_term(tu, tc1, tc2, 2.0, l1, 1.0),
               jr.data_term(ju, jc1, jc2, 2.0, l1, 1.0), RTOL)
    assert_rel(tr.energy(tu, tp, tc1, tc2, pt, lam, lam),
               jr.energy(ju, jp, jc1, jc2, pj, lam, lam), RTOL)
    want = jscalar.step(jp, ju, pj, lam, lam)
    got = tscalar.step(tp, tu, pt, lam, lam)
    for g, w in zip(got, want):
        assert_rel(g, w, RTOL)


@pytest.mark.parametrize("init,iters", [("checkerboard", 30),
                                        ("circle", 12)])
def test_segment_vector_fixed_energy_trace_f64(init, iters):
    img, _ = colored_squares(48, 64, noise=5.0)
    pj, pt = params(init=init)
    want = jvector.segment_vector_fixed(jnp.asarray(img), pj, iters=iters,
                                        **LAMS)
    got = tvector.segment_vector_fixed(to_torch(img), pt, iters=iters,
                                       **LAMS)
    rel = np.abs(to_np(got.energy) - np.asarray(want.energy)) \
        / np.abs(np.asarray(want.energy))
    assert float(rel.max()) <= RTOL, rel.max()
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    for name in ("delta", "c1", "c2", "phi"):
        assert_rel(getattr(got, name), getattr(want, name), 1e-7)


def test_segment_vector_tolerance_mode_f64():
    img, gt = colored_squares(48, 64, noise=5.0)
    pj, pt = params(init="circle")
    want = jvector.segment_vector(jnp.asarray(img), pj, **LAMS)
    got = tvector.segment_vector(to_torch(img), pt, **LAMS)
    assert got.iters == int(want.iters) < pt.max_iter
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    for name in ("phi", "delta", "c1", "c2"):
        assert_rel(getattr(got, name), getattr(want, name), 1e-7)
    assert iou(to_np(got.mask), gt) >= 0.98


def test_segment_vector_argument_errors():
    _, pt = params()
    with pytest.raises(ValueError, match="H, W, C"):
        tvector.segment_vector(torch.zeros(8, 8), pt)
    with pytest.raises(ValueError, match="length 3"):
        tvector.segment_vector_fixed(torch.zeros(8, 8, 3), pt, iters=1,
                                     lambda1=(1.0, 2.0))


# f32: the mc kernel drivers against the JAX drivers ------------------------

@pytest.fixture(scope="module")
def image():
    """An image on which the f32 runs of both packages stay apart from
    the ill-conditioned regime above: from the checkerboard start most of
    phi hovers near 0 for tens of iterations, and other noise draws at
    this size flip single cells or shift the stop by a chunk between two
    evaluation orders (the JAX flat and packed drivers among them)."""
    img, gt = colored_squares(*SHAPE, noise=8.0, seed=3)
    return img.astype(np.float32), gt


@pytest.fixture(scope="module")
def jax_runs(image):
    """JAX interpret-mode results of the mc drivers, flat and packed."""
    u0 = jnp.asarray(image[0])
    pj, _ = params(**KW)
    out = {}
    for packed in (False, True):
        out["fixed", packed] = jbanded.segment_banded_fixed(
            u0, pj, iters=11, k=4, packed=packed, **LAMS,
            interpret=True)
        out["tol", packed] = jbanded.segment_banded(
            u0, pj, k=4, packed=packed, **LAMS, interpret=True)
    out["fused"] = jfused.segment_fused(u0, pj, **LAMS, interpret=True)
    out["fused_fixed"] = jfused.segment_fused_fixed(u0, pj, iters=11,
                                                    **LAMS,
                                                    interpret=True)
    return out


def _launches():
    return [f.launches for f in MC_KERNELS]


@pytest.mark.parametrize("packed", [False, True])
def test_segment_banded_fixed_rgb_matches_reference(image, jax_runs, packed):
    """k=4, 11 iterations: two full chunks and a remainder chunk of 3."""
    _, pt = params(**KW)
    phi, mask = tbanded.segment_banded_fixed(to_torch(image[0], np.float32),
                                             pt, iters=11, k=4,
                                             packed=packed, **LAMS)
    want_phi, want_mask = jax_runs["fixed", packed]
    np.testing.assert_allclose(to_np(phi), np.asarray(want_phi), **TOL)
    np.testing.assert_array_equal(to_np(mask), np.asarray(want_mask))


@pytest.mark.parametrize("packed", [False, True])
def test_segment_banded_rgb_matches_reference(image, jax_runs, packed):
    _, pt = params(**KW)
    res = tbanded.segment_banded(to_torch(image[0], np.float32), pt, k=4,
                                 packed=packed, **LAMS)
    want = jax_runs["tol", packed]
    assert res.iters == int(want.iters) < KW["max_iter"]
    np.testing.assert_array_equal(to_np(res.mask), np.asarray(want.mask))
    np.testing.assert_allclose(to_np(res.phi), np.asarray(want.phi), **TOL)
    np.testing.assert_allclose(to_np(res.c1), np.asarray(want.c1),
                               rtol=1e-5)
    np.testing.assert_allclose(float(res.delta), float(want.delta),
                               rtol=1e-5, atol=1e-6)
    # two-phase Chan-Vese is label-symmetric: the checkerboard start may
    # put the squares on either side of the contour
    mask = to_np(res.mask)
    assert max(iou(mask, image[1]), iou(~mask, image[1])) > 0.95


def test_segment_fused_rgb_matches_reference(image, jax_runs):
    """The tolerance run (42 iterations) keeps phi within 0.003 of its
    0.27 scale, not within the elementwise bar: phi stays near 0 where the
    checkerboard was, so its iteration count, mask and means are held; the
    11-iteration fixed run is held at the driver bar."""
    _, pt = params(**KW)
    u0 = to_torch(image[0], np.float32)
    res = tfused.segment_fused(u0, pt, **LAMS)
    want = jax_runs["fused"]
    assert res.iters == int(want.iters) < KW["max_iter"]
    assert tuple(res.c1.shape) == (3,)
    np.testing.assert_array_equal(to_np(res.mask), np.asarray(want.mask))
    np.testing.assert_allclose(to_np(res.c1), np.asarray(want.c1),
                               rtol=1e-5)
    np.testing.assert_allclose(to_np(res.c2), np.asarray(want.c2),
                               rtol=1e-5)
    assert_rel(res.phi, want.phi, 0.01)
    phi, mask = tfused.segment_fused_fixed(u0, pt, iters=11, **LAMS)
    np.testing.assert_allclose(to_np(phi), np.asarray(jax_runs["fused_fixed"]
                                                      [0]), **TOL)
    np.testing.assert_array_equal(to_np(mask),
                                  np.asarray(jax_runs["fused_fixed"][1]))


@pytest.mark.parametrize("case", ["wavefront", "width100"])
def test_rgb_fallback_routes_match_reference(case):
    """Off the mc envelopes both packages take the same route: the
    wavefront order and a width that is not a multiple of 128 run the
    plain vector driver, in the port without a kernel launch (f64)."""
    img, _ = colored_squares(40, 100 if case == "width100" else 128,
                             noise=6.0)
    kw = dict(max_iter=6, tol=-1.0, min_iter=0)
    if case == "wavefront":
        kw["order"] = "wavefront"
    pj, pt = params(**kw)
    want = jbanded.segment_banded(jnp.asarray(img), pj, k=4, **LAMS,
                                  interpret=True)
    before = _launches()
    got = tbanded.segment_banded(to_torch(img), pt, k=4, **LAMS)
    assert _launches() == before
    assert got.iters == int(want.iters) == kw["max_iter"]
    assert_rel(got.phi, want.phi, RTOL)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))


def test_auto_config_mc_routes_like_reference():
    assert tbanded.auto_config_mc(2160, 3840, 3) == (8, 4, True, True)
    assert tbanded.auto_config_mc(1080, 1920, 3)[2] is False
    for h, w in ((2160, 3840), (1080, 1920), SHAPE):
        assert tbanded.auto_config_mc(h, w, 3) \
            == jbanded.auto_config_mc(h, w, 3)


def test_unported_reinit_raises_for_rgb():
    """An RGB image with a reinit cadence (M10, once unported) is refused
    the banded route and runs the fused one (K4's plain version here; the
    reference's kernel in interpret mode), with the means taken anew every
    iteration: 6 fixed iterations within 1e-10 in f64, the tolerance run's
    iterations and mask equal (phi's last-ulp differences grow fast on
    this image, with or without a cadence)."""
    rgb = colored_squares(32, 128, noise=8.0, seed=3)[0]
    pj, pt = params(init="circle", reinit_every=2, reinit_steps=5,
                    max_iter=40)
    u = to_torch(rgb)
    assert tbanded._supported_mc(u, pt.replace(reinit_every=0), 1)
    assert not tbanded._supported_mc(u, pt, 1)
    want = jbanded.segment_banded_fixed(jnp.asarray(rgb), pj, iters=6, k=1,
                                        interpret=True)
    got = tbanded.segment_banded_fixed(u, pt, iters=6, k=1)
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
    assert_rel(got[0], want[0], 1e-10)
    want = jbanded.segment_banded(jnp.asarray(rgb), pj, k=1, interpret=True)
    got = tbanded.segment_banded(u, pt, k=1)
    assert got.iters == int(want.iters)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))


# the CLI's colour route ---------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--iters", "8"]])
def test_cli_color_matches_reference_cli(tmp_path, extra):
    img, _ = colored_squares(32, 48, noise=5.0)
    np.save(tmp_path / "rgb.npy", img)
    flags = ["--color", "--init", "circle", "--lambda1", "1", "1.2", "0.8",
             *extra]
    assert jcli.main([str(tmp_path / "rgb.npy"), "-o",
                      str(tmp_path / "want.png"), *flags]) == 0
    assert cli.main([str(tmp_path / "rgb.npy"), "-o",
                     str(tmp_path / "got.npy"), "--device", "cpu",
                     *flags]) == 0
    from PIL import Image
    want = np.asarray(Image.open(tmp_path / "want.png")) > 0
    np.testing.assert_array_equal(np.load(tmp_path / "got.npy") > 0, want)


def test_cli_per_channel_lambda_needs_color(tmp_path):
    np.save(tmp_path / "rgb.npy", np.zeros((8, 8, 3)))
    assert cli.main([str(tmp_path / "rgb.npy"), "--device", "cpu",
                     "--lambda1", "1", "2", "3"]) == 2


# on the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_segment_banded_rgb_cuda_matches_plain_route(image):
    """On the card the mc driver goes through K6 and lands on the plain
    route's mask (the CPU run of the same driver)."""
    dev = cuda_device()
    _, pt = params(**KW)
    u0 = to_torch(image[0], np.float32)
    n = packed_kernel.packed_banded_chunk_mc.launches
    res = tbanded.segment_banded(u0.to(dev), pt, k=4, packed=True,
                                 **LAMS)
    assert packed_kernel.packed_banded_chunk_mc.launches > n
    ref = tbanded.segment_banded(u0, pt, k=4, packed=True, **LAMS)
    assert iou(to_np(res.mask), to_np(ref.mask)) >= 0.999
    assert abs(res.iters - ref.iters) <= 4
    assert torch.isfinite(res.phi).all()
