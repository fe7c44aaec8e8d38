"""The multiphase slice of the port (models/multiphase.py, the CLI's
--multiphase, save_labels) against the JAX reference.

- The plain functions in f64 equal the jnp ones to 1e-10 at M = 1, 2, 3,
  on gray and RGB images; labels_from_phis and init_multiphase bitwise.
- The plain drivers (``use_pallas=False``) in f64: identical labels and
  iteration counts, energy traces within 1e-10.
- The routing: ``_mp2_route`` and the four ``supports_*`` predicates equal
  the reference's.
- The kernel routes on the CPU (each kernel's plain version) against JAX's
  ``use_pallas=True, interpret=True``: labels within 1%, exact fixed
  iteration counts, the divergence stop.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.models import multiphase as jmp
from chan_vese_tpu.ops import pallas_multiphase, pallas_packed
from chan_vese_tpu_torch import cli
from chan_vese_tpu_torch.models import multiphase as tmp
from chan_vese_tpu_torch.ops import multiphase_kernel, packed_kernel
from fixtures import four_regions
from torch_port_helpers import assert_rel, params, to_np, to_torch

RTOL = 1e-10
# level sets at the end of a multi-iteration f64 run: reduction-order ulps
# grow in the settled regions over the run (measured 2.3e-9 of the scale
# at M = 3 after 23 iterations, 1.6e-10 for RGB, 1.3e-11 for M = 2 gray)
PHIS_RTOL = 1e-8
F32 = np.float32
MU = 0.003 * 255.0 ** 2


def _rgb_four_regions(h=32, w=64, noise=3.0, seed=0):
    """tests/test_multiphase_vector.py's RGB image."""
    rng = np.random.default_rng(seed)
    colors = np.array([[220.0, 40.0, 40.0], [40.0, 220.0, 40.0],
                       [40.0, 40.0, 220.0], [200.0, 200.0, 200.0]])
    labels = np.zeros((h, w), np.int32)
    labels[: h // 2, w // 2:] = 1
    labels[h // 2:, : w // 2] = 2
    labels[h // 2:, w // 2:] = 3
    return colors[labels] + noise * rng.standard_normal((h, w, 3)), labels


def _image(rgb, h=32, w=64):
    if rgb:
        return _rgb_four_regions(h, w)[0]
    return four_regions(h, w, noise=4.0)[0]


def _best_accuracy(pred, gt):
    return max(float((np.asarray(perm)[pred] == gt).mean())
               for perm in itertools.permutations(range(4)))


# plain functions ---------------------------------------------------------

@pytest.mark.parametrize("m_sets,rgb", [(1, False), (2, False), (3, False),
                                        (1, True), (2, True), (3, True)])
def test_plain_functions_f64_match_reference(m_sets, rgb):
    img = _image(rgb)
    rng = np.random.default_rng(m_sets)
    phis = rng.standard_normal((m_sets,) + img.shape[:2]) * 4
    pj, pt = params(mu=MU, nu=3.0)
    uj, ut = jnp.asarray(img), to_torch(img)
    pjx, ptx = jnp.asarray(phis), to_torch(phis)
    for got, want in zip(tmp.phase_weights(ptx, pt.eps),
                         jmp.phase_weights(pjx, pj.eps)):
        assert_rel(got, want, RTOL)
    cs_t = tmp.phase_means(ut, ptx, pt.eps)
    cs_j = jmp.phase_means(uj, pjx, pj.eps)
    assert_rel(torch.stack(cs_t), jnp.stack(cs_j), RTOL)
    for m in range(m_sets):
        assert_rel(tmp._coupling_term(ut, ptx, cs_t, m, pt),
                   jmp._coupling_term(uj, pjx, cs_j, m, pj), RTOL)
    got, got_cs = tmp.multiphase_step(ptx, ut, pt)
    want, want_cs = jmp.multiphase_step(pjx, uj, pj)
    assert_rel(got, want, RTOL)
    assert_rel(torch.stack(got_cs), jnp.stack(want_cs), RTOL)
    assert_rel(tmp.multiphase_energy(ut, ptx, pt),
               jmp.multiphase_energy(uj, pjx, pj), RTOL)


def test_labels_bitwise():
    rng = np.random.default_rng(5)
    phis = rng.standard_normal((3, 17, 23))
    phis[0, 0, :4] = 0.0
    np.testing.assert_array_equal(
        to_np(tmp.labels_from_phis(to_torch(phis))),
        np.asarray(jmp.labels_from_phis(jnp.asarray(phis))))


@pytest.mark.parametrize("kind", ["checkerboard", "circles"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_multiphase_bitwise(kind, dtype):
    for shape, m_sets in (((64, 128), 2), ((37, 50), 3), ((512, 512), 4)):
        want = np.asarray(jmp.init_multiphase(shape, m_sets, kind,
                                              getattr(jnp, dtype)))
        got = tmp.init_multiphase(shape, m_sets, kind, getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(to_np(got), want)
    with pytest.raises(ValueError, match="unknown"):
        tmp.init_multiphase((8, 8), 2, "rings")


# plain drivers -----------------------------------------------------------

@pytest.mark.parametrize("m_sets,rgb", [(2, False), (3, False), (2, True)])
def test_plain_drivers_f64_match_reference(m_sets, rgb):
    img = _image(rgb)
    pj, pt = params(mu=MU, max_iter=60)
    uj, ut = jnp.asarray(img), to_torch(img)
    want = jmp.segment_multiphase(uj, pj, m_sets=m_sets, use_pallas=False)
    got = tmp.segment_multiphase(ut, pt, m_sets=m_sets, use_pallas=False)
    assert got.iters == int(want.iters) < pt.max_iter
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))
    assert_rel(got.phis, want.phis, PHIS_RTOL)
    assert_rel(got.cs, want.cs, RTOL)
    assert float(got.delta) == float(want.delta)
    # fixed mode runs exactly max_iter
    want = jmp.segment_multiphase(uj, pj, m_sets=m_sets, use_pallas=False,
                                  fixed=True, max_iter=9)
    got = tmp.segment_multiphase(ut, pt, m_sets=m_sets, use_pallas=False,
                                 fixed=True, max_iter=9)
    assert got.iters == int(want.iters) == 9
    assert_rel(got.phis, want.phis, PHIS_RTOL)
    # the trace: energy and flips of every iteration
    want = jmp.segment_multiphase_fixed(uj, pj, iters=12, m_sets=m_sets,
                                        use_pallas=False)
    got = tmp.segment_multiphase_fixed(ut, pt, iters=12, m_sets=m_sets,
                                       use_pallas=False)
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))
    assert_rel(got.energy, want.energy, RTOL)
    np.testing.assert_array_equal(to_np(got.delta), np.asarray(want.delta))


def test_plain_driver_circles_start_and_phis0():
    img, gt = four_regions(32, 64, noise=4.0)
    pj, pt = params(mu=MU, max_iter=80)
    phis0 = np.asarray(jmp.init_multiphase((32, 64), 2, "circles",
                                           jnp.float64))
    want = jmp.segment_multiphase(jnp.asarray(img), pj, m_sets=2,
                                  phis0=jnp.asarray(phis0), use_pallas=False)
    got = tmp.segment_multiphase(to_torch(img), pt, m_sets=2,
                                 phis0=to_torch(phis0), use_pallas=False)
    assert got.iters == int(want.iters)
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))


# routing -------------------------------------------------------------------

def test_route_matches_reference():
    for shape in ((64, 128), (64, 100), (24, 128), (32, 256), (512, 512),
                  (1024, 1024), (1024, 1152), (2048, 3840), (2160, 3840),
                  (64, 128, 3), (64, 100, 3)):
        uj, ut = jnp.zeros(shape, F32), torch.zeros(shape)
        for m_sets, reinit, order, allow in itertools.product(
                (1, 2, 3), (0, 10), ("redblack", "jacobi"), (True, False)):
            pj, pt = params(reinit_every=reinit, order=order)
            for up in (True, False):
                try:
                    want = jmp._mp2_route(uj, pj, m_sets, up, allow)
                except ValueError:
                    with pytest.raises(ValueError):
                        tmp._mp2_route(ut, pt, m_sets, up, allow)
                    continue
                assert tmp._mp2_route(ut, pt, m_sets, up, allow) == want, \
                    (shape, m_sets, reinit, order, allow, up)
            # auto on a CPU tensor: the plain path, as the reference off TPU
            assert tmp._mp2_route(ut, pt, m_sets, None, allow) is None
    with pytest.raises(ValueError):
        tmp._mp2_route(torch.zeros(64, 100), params()[1], 2, True)


def test_supports_predicates_match_reference():
    for h in (8, 16, 24, 32, 48, 64, 256, 512, 520, 1024, 1040, 2160):
        for w in (100, 128, 256, 384, 512, 1024, 1152, 2048, 3840):
            assert multiphase_kernel.band_rows_mp2(h, w) \
                == pallas_multiphase.band_rows_mp2(h, w)
            assert multiphase_kernel.supports_mp2(h, w) \
                == pallas_multiphase.supports_mp2(h, w), (h, w)
            assert multiphase_kernel.supports_mp2_resident(h, w) \
                == pallas_multiphase.supports_mp2_resident(h, w), (h, w)
            assert packed_kernel.supports_packed_mp2_resident(h, w) \
                == pallas_packed.supports_packed_mp2_resident(h, w), (h, w)


def test_reinit_raises_in_every_driver():
    """A reinit cadence (M10, once unported) runs in every multiphase
    driver against the reference in f64: the plain route (tolerance and
    the fixed trace, the energy before the redistance) and K9's banded
    route (its plain version), whose next means come from the redistanced
    level sets, both against the reference's plain route (its K9 in
    interpret mode takes an f32-accurate atan in f64); the resident route
    is refused, as the reference's. Six fixed iterations at the file's
    bars, the tolerance runs' iterations and labels equal."""
    img = four_regions(32, 128, noise=4.0)[0]
    pj, pt = params(mu=0.003 * 255.0 ** 2, reinit_every=2, reinit_steps=5,
                    max_iter=30)
    u = to_torch(img)
    assert tmp._mp2_route(u, pt, 2, True) == "banded"
    assert jmp._mp2_route(jnp.asarray(img), pj, 2, True) == "banded"
    want = jmp.segment_multiphase(jnp.asarray(img), pj, use_pallas=False)
    want_fixed = jmp.segment_multiphase_fixed(jnp.asarray(img), pj, iters=6,
                                              use_pallas=False)
    for use_pallas in (False, True):
        got = tmp.segment_multiphase(u, pt, use_pallas=use_pallas)
        assert got.iters == int(want.iters)
        np.testing.assert_array_equal(to_np(got.labels),
                                      np.asarray(want.labels))
        got = tmp.segment_multiphase_fixed(u, pt, iters=6,
                                           use_pallas=use_pallas)
        np.testing.assert_array_equal(to_np(got.labels),
                                      np.asarray(want_fixed.labels))
        assert_rel(got.phis, want_fixed.phis, PHIS_RTOL)
        assert_rel(got.energy, want_fixed.energy, RTOL)


# the kernel routes on the CPU ---------------------------------------------

@pytest.fixture(scope="module")
def four():
    img, gt = four_regions(64, 128, noise=4.0)
    return img.astype(F32), gt


def test_kernel_routes_match_reference_labels(four):
    """Resident route (tolerance mode) and the banded loop against JAX's
    kernels in interpret mode and the plain route: labels within 1%."""
    img, gt = four
    pj, pt = params(mu=MU, max_iter=40)
    u = to_torch(img, F32)
    plain = jmp.segment_multiphase(jnp.asarray(img), pj, m_sets=2,
                                   use_pallas=False)
    want = jmp.segment_multiphase(jnp.asarray(img), pj, m_sets=2,
                                  use_pallas=True, interpret=True)
    assert tmp._mp2_route(u, pt, 2, True) == "resident"
    got = tmp.segment_multiphase(u, pt, m_sets=2, use_pallas=True)
    assert got.iters == int(want.iters)
    for ref in (want.labels, plain.labels):
        assert (to_np(got.labels) != np.asarray(ref)).mean() < 0.01
    assert _best_accuracy(to_np(got.labels), gt) >= 0.98
    phis0 = tmp.init_multiphase((64, 128), 2)
    phis, n, _ = tmp._mp2_banded_loop(u, pt, phis0, False, pt.max_iter)
    assert n < pt.max_iter
    assert (to_np(tmp.labels_from_phis(phis))
            != np.asarray(plain.labels)).mean() < 0.01


def test_kernel_fixed_trace_matches_reference(four):
    """The banded route's trace. In f64 its plain version follows the jnp
    route's trajectory: energy within 1e-10 (measured 5.8e-12). In f32 the
    early transient from the checkerboard start amplifies last-ulp
    differences: against the JAX kernel in interpret mode the energy
    differs by up to 1.3e-3 at iteration 5 (the JAX kernel against its own
    jnp route: 1.3e-4), so f32 is held on the labels (at most 5 cells, the
    reference's bar)."""
    img, _ = four
    pj, pt = params(mu=MU)
    u = to_torch(img, F32)
    assert tmp._mp2_route(u, pt, 2, True, allow_resident=False) == "banded"
    want = jmp.segment_multiphase_fixed(jnp.asarray(img, jnp.float64), pj,
                                        iters=20, m_sets=2, use_pallas=False)
    got = tmp.segment_multiphase_fixed(to_torch(img), pt, iters=20,
                                       m_sets=2, use_pallas=True)
    assert_rel(got.energy, want.energy, RTOL)
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))
    want = jmp.segment_multiphase_fixed(jnp.asarray(img), pj, iters=20,
                                        m_sets=2, use_pallas=True,
                                        interpret=True)
    got = tmp.segment_multiphase_fixed(u, pt, iters=20, m_sets=2,
                                       use_pallas=True)
    assert (to_np(got.labels) != np.asarray(want.labels)).sum() <= 5


@pytest.mark.parametrize("shape", [(64, 128), (32, 256)])
def test_kernel_fixed_mode_exact_iters(monkeypatch, shape):
    """Flat resident at (64, 128), packed at (32, 256): exactly max_iter in
    one launch; the fixed mode's unroll 2 reaches only the packed kernel
    (the reference's flat call drops it)."""
    img = four_regions(*shape, noise=4.0)[0].astype(F32)
    _, pt = params(mu=MU)
    calls = []
    for mod, name in ((multiphase_kernel, "mp2_resident_iterations"),
                      (packed_kernel, "packed_mp2_resident_iterations")):
        fn = getattr(mod, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls.append((_name, args[3], kw.get("unroll", 1)))
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    res = tmp.segment_multiphase(to_torch(img, F32), pt, m_sets=2,
                                 use_pallas=True, fixed=True, max_iter=17)
    assert res.iters == 17
    res = tmp.segment_multiphase(to_torch(img, F32), pt, m_sets=2,
                                 use_pallas=True, fixed=True, max_iter=18)
    assert res.iters == 18
    if shape == (64, 128):
        assert calls == [("mp2_resident_iterations", 17, 1),
                         ("mp2_resident_iterations", 18, 1)]
    else:
        assert calls == [("packed_mp2_resident_iterations", 17, 1),
                         ("packed_mp2_resident_iterations", 18, 2)]


@pytest.mark.parametrize("max_iter,chunks", [(40, [32, 8]), (70, [32, 32, 6])])
def test_resident_tolerance_chunks(monkeypatch, max_iter, chunks):
    """tol = 0 never converges: full chunks of 32, then the remainder,
    exactly max_iter iterations."""
    img = four_regions(64, 128, noise=4.0)[0].astype(F32)
    _, pt = params(mu=MU, tol=0.0, max_iter=max_iter)
    sizes = []
    fn = multiphase_kernel.mp2_resident_iterations

    def spy(*args, **kw):
        sizes.append(args[3])
        return fn(*args, **kw)
    monkeypatch.setattr(multiphase_kernel, "mp2_resident_iterations", spy)
    res = tmp.segment_multiphase(to_torch(img, F32), pt, use_pallas=True)
    assert res.iters == max_iter and sizes == chunks


def test_divergence_stops():
    """mu = dt = 1e30 sends the level sets non-finite: the resident route
    stops at its first chunk as the reference's does, the banded loop
    after its first non-finite iteration; both well before max_iter."""
    rng = np.random.default_rng(3)
    u0 = rng.uniform(0, 255, (64, 128)).astype(F32)
    phis = (rng.standard_normal((2, 64, 128)) * 5).astype(F32)
    pj, pt = params(mu=1e30, dt=1e30, tol=1e-12, max_iter=300, min_iter=0)
    want = jmp.segment_multiphase(jnp.asarray(u0), pj, m_sets=2,
                                  phis0=jnp.asarray(phis), use_pallas=True,
                                  interpret=True)
    got = tmp.segment_multiphase(to_torch(u0, F32), pt, m_sets=2,
                                 phis0=to_torch(phis, F32), use_pallas=True)
    assert got.iters == int(want.iters) < 300
    _, n, delta = tmp._mp2_banded_loop(to_torch(u0, F32), pt,
                                       to_torch(phis, F32), False, 300)
    assert n < 300 and not bool(torch.isfinite(delta))


def test_sweeps_route_matches_reference():
    """M = 3 gray and M = 2 RGB take K1's force mode per level set."""
    for img, m_sets in ((four_regions(64, 128, noise=4.0)[0], 3),
                        (_rgb_four_regions(64, 128)[0], 2)):
        img = img.astype(F32)
        pj, pt = params(mu=MU, max_iter=30)
        assert tmp._mp2_route(to_torch(img, F32), pt, m_sets, True) \
            == "sweeps"
        want = jmp.segment_multiphase(jnp.asarray(img), pj, m_sets=m_sets,
                                      use_pallas=True, interpret=True)
        got = tmp.segment_multiphase(to_torch(img, F32), pt, m_sets=m_sets,
                                     use_pallas=True)
        assert abs(got.iters - int(want.iters)) <= 1
        assert (to_np(got.labels) != np.asarray(want.labels)).mean() < 0.01


# CLI -----------------------------------------------------------------------

def test_cli_multiphase_writes_four_labels(tmp_path, capsys):
    img, gt = four_regions(64, 128, noise=4.0)
    src, out = tmp_path / "four.npy", tmp_path / "labels.npy"
    np.save(src, img)
    rc = cli.main([str(src), "-o", str(out), "--multiphase", "2",
                   "--device", "cpu", "--mu", str(MU)])
    assert rc == 0
    lab = np.load(out)
    assert lab.dtype == np.uint8
    np.testing.assert_array_equal(np.unique(lab), [0, 85, 170, 255])
    assert _best_accuracy(lab // 85, gt) >= 0.98
    assert "4 phases" in capsys.readouterr().err
    # --iters runs segment_multiphase_fixed
    rc = cli.main([str(src), "-o", str(out), "--multiphase", "2",
                   "--device", "cpu", "--iters", "3"])
    assert rc == 0 and np.load(out).shape == (64, 128)


def test_cli_multiphase_divergence_writes_nothing(tmp_path):
    src, out = tmp_path / "bad.npy", tmp_path / "labels.npy"
    np.save(src, np.full((32, 128), np.nan, np.float32))
    rc = cli.main([str(src), "-o", str(out), "--multiphase", "2",
                   "--device", "cpu"])
    assert rc == 1 and not out.exists()
