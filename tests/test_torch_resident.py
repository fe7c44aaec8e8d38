"""The exact-means resident slice of the port (K7 flat, K8 parity planes;
models/resident.py, models/batched.py) against the JAX reference.

- The routing predicates equal the reference's over a grid of shapes.
- The plain K7 in f64 equals the jnp per-iteration driver
  (``segment_fixed``) to 1e-10: both recompute the means every iteration.
- The plain K7/K8 in f32 against the Pallas kernels in interpret mode:
  iteration 1 at rtol 1e-6 / atol 1e-5 (tests/test_resident.py's bar),
  identical masks at 40 iterations, partials rows at rtol 1e-5; batch and
  mc modes (mc at tests/test_resident.py's rtol 3e-5 / atol 3e-4).
- The three drivers against their JAX counterparts: the route taken,
  identical masks, chunk-aligned and exact-max_iter iteration counts,
  divergence, argument errors and the fallbacks.
- ``cuda``-marked twins hold each kernel mode against its plain version on
  the card (skipped without a GPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.models import batched as jbatched
from chan_vese_tpu.models import resident as jres
from chan_vese_tpu.models import scalar as jscalar
from chan_vese_tpu.ops import pallas_packed, pallas_resident
from chan_vese_tpu.utils.init_phi import init_phi as j_init_phi
from chan_vese_tpu_torch.models import batched as tbatched
from chan_vese_tpu_torch.models import fused as tfused
from chan_vese_tpu_torch.models import resident as tres
from chan_vese_tpu_torch.models import scalar as tscalar
from chan_vese_tpu_torch.ops import packed_kernel, resident_kernel
from fixtures import colored_squares, iou, two_disks
from torch_port_helpers import assert_rel, cuda_device, params, to_np, \
    to_torch

FIRST = dict(rtol=1e-6, atol=1e-5)
PARTS = dict(rtol=1e-5, atol=0.0)
TOL = dict(rtol=3e-5, atol=3e-4)
LAM = (1.0, 1.2, 0.8)
F32 = np.float32
# per layout: an image and a start from which the run converges to the two
# disks (tests/test_resident.py's flat case, and a packed-aligned one);
# once converged the f32 reduction-order drift between the two packages
# leaves the mask identical
CASES = {"flat": dict(shape=(64, 128), init="circle", mu=0.01 * 255.0 ** 2),
         "packed": dict(shape=(64, 256), init="checkerboard",
                        mu=0.001 * 255.0 ** 2)}


def _case(layout, seed=0):
    """(image f32, truth, phi0 f32, JAX params, port params)."""
    c = CASES[layout]
    img, gt = two_disks(*c["shape"], noise=6.0, seed=seed)
    phi = np.asarray(j_init_phi(c["shape"], c["init"], jnp.float32))
    return (img.astype(F32), gt, phi) + params(init=c["init"], mu=c["mu"])


def _jax_op(layout, mode=""):
    mod = pallas_resident if layout == "flat" else pallas_packed
    pre = "resident" if layout == "flat" else "packed_resident"
    return getattr(mod, f"{pre}_iterations{mode}")


def _port_op(layout, mode=""):
    mod = resident_kernel if layout == "flat" else packed_kernel
    pre = "resident" if layout == "flat" else "packed_resident"
    return getattr(mod, f"{pre}_iterations{mode}")


def _same_mask(got, want):
    np.testing.assert_array_equal(to_np(got) >= 0, np.asarray(want) >= 0)


def _check_rows(got, want, means_rtol, norms_rtol):
    """Partials rows: the means sums (s_uH, s_H) at ``means_rtol``, the
    zero pad exactly, the flips count within one cell; s_dphi2 and
    s_absdphi sum per-cell updates that shrink toward the ulp of phi as
    the run settles, so the f32 drift between the packages weighs more
    there: they are held at ``norms_rtol``."""
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)

    def rel(cols):
        return np.max(np.abs(got[:, cols] - want[:, cols])
                      / np.abs(want[:, cols]))
    # shown with pytest -s: the measured differences beside their bars
    print(f"rows {got.shape}: means rel {rel([0, 1]):.3e} (bar "
          f"{means_rtol}), norms rel {rel([2, 4]):.3e} (bar {norms_rtol})")
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=means_rtol)
    np.testing.assert_array_equal(got[:, 5:], want[:, 5:])
    np.testing.assert_allclose(got[:, 3], want[:, 3], atol=1.0)
    np.testing.assert_allclose(got[:, [2, 4]], want[:, [2, 4]],
                               rtol=norms_rtol)


class Spy:
    """Counts the calls of a module attribute while delegating to it."""

    def __init__(self, monkeypatch, module, name):
        self.calls = []
        fn = getattr(module, name)

        def spy(*args, **kw):
            self.calls.append(kw.get("unroll", 1))
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, spy)


# routing ---------------------------------------------------------------

def test_routing_predicates_match_reference():
    for h in (8, 16, 24, 32, 63, 64, 256, 512, 1024, 1040, 2048):
        for w in (100, 128, 256, 384, 512, 896, 1024, 2048):
            assert resident_kernel.supports_resident(h, w) \
                == pallas_resident.supports_resident(h, w), (h, w)
            assert packed_kernel.supports_packed_resident(h, w) \
                == pallas_packed.supports_packed_resident(h, w), (h, w)
            for c in (0, 1, 3, 8, 9):
                assert resident_kernel.supports_resident_mc(h, w, c) \
                    == pallas_resident.supports_resident_mc(h, w, c)
                assert packed_kernel.supports_packed_resident_mc(h, w, c) \
                    == pallas_packed.supports_packed_resident_mc(h, w, c)
    for iters in (1, 2, 3, 4, 6, 8, 12, 100):
        assert tres._auto_unroll(iters) == jres._auto_unroll(iters)


# the plain kernels -------------------------------------------------------

def test_plain_k7_f64_equals_per_iteration_driver():
    """Exact means every iteration: 20 plain K7 iterations in f64 are the
    jnp driver's trajectory (and bitwise the port's plain one), and each
    row's means are the ones it used."""
    img, _ = two_disks(32, 128, noise=8.0)
    pj, pt = params()
    want = jscalar.segment_fixed(jnp.asarray(img), pj, iters=20)
    phi0 = to_torch(np.asarray(j_init_phi((32, 128), "checkerboard",
                                          jnp.float64)))
    u = to_torch(img)
    got, parts = resident_kernel.resident_iterations(phi0, u, pt, 20)
    assert_rel(got, want.phi, 1e-10)
    np.testing.assert_array_equal(to_np(got >= 0), np.asarray(want.mask))
    torch.testing.assert_close(got, tscalar.segment_fixed(u, pt, 20).phi,
                               rtol=0, atol=0)
    c1 = parts[:, 0] / parts[:, 1]
    c2 = (u.sum() - parts[:, 0]) / (u.numel() - parts[:, 1])
    assert_rel(c1, want.c1, 1e-10)
    assert_rel(c2, want.c2, 1e-10)


@pytest.fixture(scope="module")
def interp():
    """The JAX kernels in interpret mode, f32, per layout: 8 iterations at
    unroll 2 (and the first iteration) on a (32, W) image from the
    checkerboard start at the default parameters, and 40 iterations at
    unroll 2 on the layout's case."""
    out = {}
    pj0, pt0 = params()
    for layout in CASES:
        img, gt, phi, pj, pt = _case(layout)
        op = _jax_op(layout)
        small = two_disks(32, img.shape[1], noise=6.0)[0].astype(F32)
        start = np.asarray(j_init_phi(small.shape, "checkerboard",
                                      jnp.float32))
        out[layout] = dict(
            img=img, gt=gt, phi=phi, pt=pt, small=small, start=start,
            pt0=pt0,
            one=op(jnp.asarray(start), jnp.asarray(small), pj0, 1,
                   interpret=True),
            eight=op(jnp.asarray(start), jnp.asarray(small), pj0, 8,
                     unroll=2, interpret=True),
            forty=op(jnp.asarray(phi), jnp.asarray(img), pj, 40, unroll=2,
                     interpret=True))
    return out


@pytest.mark.parametrize("layout", ["flat", "packed"])
def test_plain_first_iterations_match_pallas(interp, layout):
    case = interp[layout]
    args = (to_torch(case["start"], F32), to_torch(case["small"], F32),
            case["pt0"])
    got, parts = _port_op(layout)(*args, 1)
    want, wparts = case["one"]
    np.testing.assert_allclose(to_np(got), np.asarray(want), **FIRST)
    assert tuple(parts.shape) == (1, 8)
    _check_rows(parts, np.asarray(wparts)[:1], 1e-5, 1e-4)
    # unroll 2: four rows, each the last iteration of its pair
    got, parts = _port_op(layout)(*args, 8, unroll=2)
    want, wparts = case["eight"]
    assert tuple(parts.shape) == (4, 8)
    _check_rows(parts, np.asarray(wparts)[:4], 1e-5, 1e-4)


@pytest.mark.parametrize("layout", ["flat", "packed"])
def test_plain_forty_iterations_match_pallas(interp, layout):
    """Unroll 2: 20 rows, each the last iteration of its pair. The level
    sets drift apart at the f32 reduction-order level; the mask is
    identical and the rows agree (``_check_rows``)."""
    case = interp[layout]
    got, parts = _port_op(layout)(to_torch(case["phi"], F32),
                                  to_torch(case["img"], F32), case["pt"], 40,
                                  unroll=2)
    want, wparts = case["forty"]
    _same_mask(got, want)
    assert iou(to_np(got >= 0), case["gt"]) > 0.95
    assert tuple(parts.shape) == (20, 8)
    _check_rows(parts, np.asarray(wparts)[:20], 5e-4, 5e-3)


def test_unroll_changes_only_the_rows():
    img, _, phi, _, pt = _case("flat")
    args = (to_torch(phi, F32), to_torch(img, F32), pt, 8)
    a, pa = resident_kernel.resident_iterations(*args)
    b, pb = resident_kernel.resident_iterations(*args, unroll=4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(pa[3::4], pb, rtol=0, atol=0)


def _frames(layout):
    """Two frames (the case's image and its mirror) with one start each."""
    img, _, phi, pj, pt = _case(layout)
    return (np.stack([img, img[:, ::-1]]), np.stack([phi, phi]), pj, pt)


@pytest.mark.parametrize("layout", ["flat", "packed"])
def test_plain_batch_matches_pallas(layout):
    imgs, phis, pj, pt = _frames(layout)
    want, wparts = _jax_op(layout, "_batch")(
        jnp.asarray(phis), jnp.asarray(imgs), pj, 40, unroll=2,
        interpret=True)
    got, parts = _port_op(layout, "_batch")(
        to_torch(phis, F32), to_torch(imgs, F32), pt, 40, unroll=2)
    _same_mask(got, want)
    assert tuple(parts.shape) == (2, 8)
    _check_rows(parts, wparts, 5e-4, 5e-3)
    single, sparts = _port_op(layout)(to_torch(phis[1], F32),
                                      to_torch(imgs[1], F32), pt, 40)
    torch.testing.assert_close(got[1], single, rtol=0, atol=0)
    torch.testing.assert_close(parts[1], sparts[-1], rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["flat", "packed"])
def test_plain_mc_matches_pallas(layout):
    h, w = CASES[layout]["shape"]
    h //= 2
    rng = np.random.default_rng(7)
    u0 = rng.uniform(0, 255, (3, h, w)).astype(F32)
    phi = (rng.standard_normal((h, w)) * 3).astype(F32)
    pj, pt = params()
    want, wparts = _jax_op(layout, "_mc")(
        jnp.asarray(phi), jnp.asarray(u0), pj, 5, lambda1=LAM,
        interpret=True)
    got, parts = _port_op(layout, "_mc")(to_torch(phi, F32),
                                         to_torch(u0, F32), pt, 5,
                                         lambda1=LAM)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert tuple(parts.shape) == (5, 3 + 4)
    np.testing.assert_allclose(to_np(parts)[:, :4], np.asarray(wparts)[:, :4],
                               rtol=1e-5)


def test_wrappers_validate_arguments():
    _, pt = params()
    phi = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="iters"):
        resident_kernel.resident_iterations(phi, phi, pt, 0)
    with pytest.raises(ValueError, match="unroll"):
        packed_kernel.packed_resident_iterations(phi, phi, pt, 6, unroll=4)
    with pytest.raises(ValueError, match="unroll"):
        resident_kernel.resident_iterations_mc(phi, torch.zeros(3, 8, 16),
                                               pt, 4, unroll=0)
    with pytest.raises(ValueError, match="one"):
        resident_kernel.resident_iterations(phi, torch.zeros(8, 8), pt, 1)
    with pytest.raises(ValueError, match="N, H, W"):
        packed_kernel.packed_resident_iterations_batch(phi, phi, pt, 1)
    with pytest.raises(ValueError, match="channels"):
        packed_kernel.packed_resident_iterations_mc(
            phi, torch.zeros(9, 8, 16), pt, 1)


# the drivers -------------------------------------------------------------

def _module(layout):
    return resident_kernel if layout == "flat" else packed_kernel


@pytest.mark.parametrize("layout,op,unroll", [
    ("flat", "resident_iterations", 4),
    ("packed", "packed_resident_iterations", 4)])
def test_fixed_driver_gray_matches_reference(monkeypatch, layout, op,
                                             unroll):
    """Routes and unroll as the reference: packed at W % 256 == 0, flat
    otherwise, both with _auto_unroll at up to 256^2."""
    img, gt, _, pj, pt = _case(layout)
    spy = Spy(monkeypatch, _module(layout), op)
    want, _ = jres.segment_resident_fixed(jnp.asarray(img), pj, iters=40,
                                          interpret=True)
    got, mask = tres.segment_resident_fixed(to_torch(img, F32), pt,
                                            iters=40)
    assert spy.calls == [unroll]
    _same_mask(got, want)
    assert iou(to_np(mask), gt) > 0.95


@pytest.mark.parametrize("layout,op,unroll", [
    ("flat", "resident_iterations_mc", 1),
    ("packed", "packed_resident_iterations_mc", 2)])
def test_fixed_driver_rgb_matches_reference(monkeypatch, layout, op,
                                            unroll):
    """8 iterations from the checkerboard start, where phi is still near
    zero: held at the mc bar, masks where |phi| is above its atol."""
    img, _ = colored_squares(32, CASES[layout]["shape"][1], noise=8.0,
                             seed=3)
    img = img.astype(F32)
    pj, pt = params()
    spy = Spy(monkeypatch, _module(layout), op)
    want, _ = jres.segment_resident_fixed(jnp.asarray(img), pj, iters=8,
                                          lambda1=LAM, lambda2=LAM,
                                          interpret=True)
    got, mask = tres.segment_resident_fixed(to_torch(img, F32), pt, iters=8,
                                            lambda1=LAM, lambda2=LAM)
    assert spy.calls == [unroll]
    want = np.asarray(want)
    np.testing.assert_allclose(to_np(got), want, **TOL)
    sure = np.abs(want) > TOL["atol"]
    np.testing.assert_array_equal(to_np(mask)[sure], (want >= 0)[sure])


@pytest.mark.parametrize("layout", ["flat", "packed"])
def test_tolerance_driver_matches_reference(monkeypatch, layout):
    img, gt, _, pj, pt = _case(layout)
    spy = Spy(monkeypatch, _module(layout),
              "resident_iterations" if layout == "flat"
              else "packed_resident_iterations")
    want = jres.segment_resident(jnp.asarray(img), pj, chunk=8,
                                 interpret=True)
    got = tres.segment_resident(to_torch(img, F32), pt, chunk=8)
    assert got.iters == int(want.iters) < pt.max_iter
    assert got.iters % 8 == 0 and spy.calls == [1] * (got.iters // 8)
    _same_mask(got.phi, want.phi)
    np.testing.assert_allclose(to_np(got.c1), np.asarray(want.c1), rtol=1e-4)
    np.testing.assert_allclose(to_np(got.c2), np.asarray(want.c2), rtol=1e-4)
    assert float(got.delta) < pt.tol
    assert iou(to_np(got.mask), gt) > 0.95


@pytest.mark.parametrize("max_iter,chunk", [(100, 16), (10, 16), (32, 16),
                                            (7, 4)])
def test_tolerance_driver_stops_exactly_at_max_iter(max_iter, chunk):
    """tol = 0 never converges: full chunks plus the remainder chunk run
    exactly max_iter iterations (tests/test_resident.py's cases)."""
    img, _, _, _, _ = _case("flat")
    _, pt = params(init="circle", tol=0.0, max_iter=max_iter)
    res = tres.segment_resident(to_torch(img, F32), pt, chunk=chunk)
    assert res.iters == max_iter


def test_tolerance_driver_divergence_and_validation():
    _, pt = params(conv_norm="rms", max_iter=100)
    bad = torch.full((64, 128), float("nan"))
    res = tres.segment_resident(bad, pt, chunk=8)
    assert res.iters <= 8
    assert not bool(torch.isfinite(res.delta))
    img = to_torch(_case("flat")[0], F32)
    with pytest.raises(ValueError, match="conv_norm"):
        tres.segment_resident(img, params(conv_norm="nope")[1])
    with pytest.raises(ValueError, match="chunk"):
        tres.segment_resident(img, params()[1], chunk=0)


def test_fallbacks_match_reference():
    img, _, _, _, _ = _case("flat")
    # another sweep order runs the fused driver's plain fallback
    pj, pt = params(init="circle", order="jacobi")
    got, _ = tres.segment_resident_fixed(to_torch(img, F32), pt, iters=10)
    want, _ = jres.segment_resident_fixed(jnp.asarray(img), pj, iters=10,
                                          interpret=True)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    torch.testing.assert_close(
        got, tfused.segment_fused_fixed(to_torch(img, F32), pt, 10)[0],
        rtol=0, atol=0)
    # off the envelope (W % 128): the fused tolerance driver
    odd, _ = two_disks(64, 100, noise=6.0)
    odd = odd.astype(F32)
    pj, pt = params(init="circle")
    got = tres.segment_resident(to_torch(odd, F32), pt)
    want = jres.segment_resident(jnp.asarray(odd), pj, interpret=True)
    assert got.iters == int(want.iters)
    _same_mask(got.phi, want.phi)
    # RGB tolerance mode runs segment_fused, as in the reference
    rgb, _ = colored_squares(32, 128, noise=8.0, seed=3)
    rgb = rgb.astype(F32)
    got = tres.segment_resident(to_torch(rgb, F32), pt, lambda1=LAM,
                                lambda2=LAM)
    ref = tfused.segment_fused(to_torch(rgb, F32), pt, lambda1=LAM,
                               lambda2=LAM)
    assert got.iters == ref.iters
    torch.testing.assert_close(got.phi, ref.phi, rtol=0, atol=0)


def test_reinit_raises_in_every_driver(monkeypatch):
    """With a reinit cadence (M10, once unported) every resident driver
    falls through to its fused driver, as the reference's do (the cadence
    runs between launches): the same result bitwise, no resident
    launch."""
    _, pt = params(init="circle", reinit_every=3, reinit_steps=5,
                   max_iter=20)
    img = two_disks(32, 128, noise=8.0)[0]
    u = to_torch(img)
    rgb = to_torch(colored_squares(32, 128, noise=8.0, seed=3)[0])
    assert resident_kernel.supports_resident(32, 128)
    assert resident_kernel.supports_resident_mc(32, 128, 3)
    for name in ("resident_iterations", "resident_iterations_mc",
                 "resident_iterations_batch"):
        monkeypatch.setattr(tres.resident_kernel, name,
                            lambda *a, **k: pytest.fail("resident launch"))
    for name in ("packed_resident_iterations",
                 "packed_resident_iterations_mc",
                 "packed_resident_iterations_batch"):
        monkeypatch.setattr(tres.packed_kernel, name,
                            lambda *a, **k: pytest.fail("resident launch"))
    got = tres.segment_resident(u, pt)
    ref = tfused.segment_fused(u, pt)
    assert got.iters == ref.iters
    torch.testing.assert_close(got.phi, ref.phi, rtol=0, atol=0)
    for x in (u, rgb):
        got = tres.segment_resident_fixed(x, pt, iters=7)[0]
        ref = tfused.segment_fused_fixed(x, pt, iters=7)[0]
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    stack = torch.stack([u, u.flip(1)])
    got = tres.segment_stack_resident_fixed(stack, pt, iters=7)[0]
    ref = tbatched.segment_stack_fused_fixed(stack, pt, iters=7)[0]
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("layout,op,unroll", [
    ("flat", "resident_iterations_batch", 1),
    ("packed", "packed_resident_iterations_batch", 2)])
def test_stack_driver_matches_reference(monkeypatch, layout, op, unroll):
    imgs, _, pj, pt = _frames(layout)
    spy = Spy(monkeypatch, _module(layout), op)
    want, _ = jres.segment_stack_resident_fixed(jnp.asarray(imgs), pj,
                                                iters=40, interpret=True)
    got, masks = tres.segment_stack_resident_fixed(to_torch(imgs, F32), pt,
                                                   iters=40)
    assert spy.calls == [unroll]
    _same_mask(got, want)


def test_stack_fallbacks_match_reference():
    """Jacobi order and a shape off both envelopes run the plain stack
    loop."""
    imgs = np.stack([two_disks(32, 128, noise=6.0, seed=s)[0]
                     for s in (0, 2)]).astype(F32)
    pj, pt = params(init="circle", order="jacobi")
    got, _ = tres.segment_stack_resident_fixed(to_torch(imgs, F32), pt,
                                               iters=6)
    want, _ = jbatched.segment_stack_fixed(jnp.asarray(imgs), pj, iters=6)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    odd = np.stack([two_disks(24, 100, noise=6.0)[0]] * 2).astype(F32)
    pj, pt = params(init="circle")
    got, _ = tres.segment_stack_resident_fixed(to_torch(odd, F32), pt,
                                               iters=6)
    want, _ = jbatched.segment_stack_fixed(jnp.asarray(odd), pj, iters=6)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_stack_fused_driver_matches_reference():
    imgs = np.stack([two_disks(32, 128, noise=6.0, seed=s)[0]
                     for s in (0, 3)]).astype(F32)
    pj, pt = params(init="circle")
    want, _ = jbatched.segment_stack_fused_fixed(jnp.asarray(imgs), pj,
                                                 iters=6, interpret=True)
    got, masks = tbatched.segment_stack_fused_fixed(to_torch(imgs, F32), pt,
                                                    iters=6)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    _same_mask(got, want)


def test_stack_fixed_f64_matches_reference():
    imgs = np.stack([two_disks(24, 40, noise=5.0, seed=s)[0]
                     for s in (0, 1)])
    pj, pt = params()
    want, _ = jbatched.segment_stack_fixed(jnp.asarray(imgs), pj, iters=10)
    got, _ = tbatched.segment_stack_fixed(to_torch(imgs), pt, iters=10)
    assert_rel(got, want, 1e-10)


# on the card: each kernel mode against its plain version -----------------

CARD_MODES = [(layout, mode) for layout in ("flat", "packed")
              for mode in ("", "_batch", "_mc")]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,mode", CARD_MODES)
def test_resident_modes_cuda_match_plain(layout, mode):
    dev = cuda_device()
    h, w = 200, 300
    rng = np.random.default_rng(4)
    _, pt = params()
    phi = torch.from_numpy(np.asarray(
        j_init_phi((h, w), "checkerboard", jnp.float32))).to(dev)
    img = torch.from_numpy(two_disks(h, w, noise=6.0)[0].astype(F32)).to(dev)
    if mode == "_batch":
        args = (phi.expand(3, h, w).contiguous(),
                torch.stack([img, img.flip(0), img.flip(1)]))
    elif mode == "_mc":
        args = (phi, torch.from_numpy(
            rng.uniform(0, 255, (3, h, w)).astype(F32)).to(dev))
    else:
        args = (phi, img)
    fn = _port_op(layout, mode)
    plain = getattr(packed_kernel if layout == "packed" else resident_kernel,
                    fn.__name__ + "_reference")
    n = fn.launches
    for iters in (1, 4):
        got = fn(*args, pt, iters)
        want = plain(*args, pt, iters)
        torch.cuda.synchronize()
        np.testing.assert_allclose(to_np(got[0]), to_np(want[0]), rtol=1e-4,
                                   atol=1e-4)
        assert tuple(got[1].shape) == tuple(want[1].shape)
        np.testing.assert_allclose(to_np(got[1]), to_np(want[1]), rtol=1e-4,
                                   atol=16.0)
    assert fn.launches == n + 2
