"""PyTorch port vs the JAX reference: the plain scalar drivers
(models/scalar.py) in f64, and the wavefront parity mode against the
stored C-baseline goldens."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.models import scalar as jscalar
from chan_vese_tpu.utils.trace import read_energy_csv
from chan_vese_tpu_torch.models import scalar as tscalar
from fixtures import colored_squares, two_disks
from torch_port_helpers import assert_rel, params, to_np, to_torch

GOLD = Path(__file__).resolve().parents[1] / "goldens"


@pytest.fixture(scope="module")
def image():
    img, _ = two_disks(64, 64, noise=8.0)
    return img


@pytest.mark.parametrize("init,iters", [("checkerboard", 60), ("circle", 12)])
def test_segment_fixed_energy_trace_f64(image, init, iters):
    pj, pt = params(init=init)
    want = jscalar.segment_fixed(jnp.asarray(image), pj, iters=iters)
    got = tscalar.segment_fixed(to_torch(image), pt, iters=iters)
    rel = np.abs(to_np(got.energy) - np.asarray(want.energy)) \
        / np.abs(np.asarray(want.energy))
    assert float(rel.max()) <= 1e-10, rel.max()
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    # phi itself carries the grown ulp differences (~1e-8 of its scale)
    for name in ("delta", "c1", "c2", "phi"):
        assert_rel(getattr(got, name), getattr(want, name), 1e-7)


def test_circle_init_long_trace_stays_within_parity_bar(image):
    """After the circle-init contour settles (0 flips from iteration 4),
    ulp-level differences in the reduction order grow about 3x per
    iteration along the drifting phi (1e-10 at iteration 14, 4e-6 at 60);
    masks stay identical and the trace stays inside BASELINE's 1e-5."""
    pj, pt = params(init="circle")
    want = jscalar.segment_fixed(jnp.asarray(image), pj, iters=60)
    got = tscalar.segment_fixed(to_torch(image), pt, iters=60)
    rel = np.abs(to_np(got.energy) - np.asarray(want.energy)) \
        / np.abs(np.asarray(want.energy))
    assert float(rel.max()) <= 1e-5, rel.max()
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))


@pytest.mark.parametrize("kw", [dict(), dict(init="circle", tol=1e-4),
                                dict(conv_norm="rms", tol=1e-2,
                                     max_iter=60)])
def test_segment_tolerance_mode_f64(image, kw):
    pj, pt = params(**kw)
    want = jscalar.segment(jnp.asarray(image), pj)
    got = tscalar.segment(to_torch(image), pt)
    assert got.iters == int(want.iters)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    for name in ("phi", "delta", "c1", "c2"):
        assert_rel(getattr(got, name), getattr(want, name), 1e-7)


def test_segment_divergence_aborts_like_reference():
    """A NaN pixel poisons the means, phi and the flips metric: both
    drivers stop after the first iteration instead of running to cap."""
    rng = np.random.default_rng(4)
    u0 = rng.uniform(0, 255, (16, 24))
    u0[5, 7] = np.nan
    pj, pt = params(max_iter=50, min_iter=0)
    want = jscalar.segment(jnp.asarray(u0), pj)
    got = tscalar.segment(to_torch(u0), pt)
    assert got.iters == int(want.iters) == 1
    assert not np.isfinite(float(got.delta))


def test_unported_inputs_raise_with_roadmap_item(image):
    """Reinitialization (M10, once unported) runs in the plain drivers, gray
    and RGB, against the reference in f64: segment_fixed's trace with the
    cadence shifted by start_iter (the energy before the redistance), and
    segment on an RGB image (its iterations and mask: phi's last-ulp
    differences grow fast there, with or without a cadence); RGB images
    run without a cadence too (M6, tests/test_torch_vector.py)."""
    pj, pt = params(init="circle", reinit_every=2, reinit_steps=6)
    for start in (0, 1):
        want = jscalar.segment_fixed(jnp.asarray(image), pj, iters=6,
                                     start_iter=start)
        got = tscalar.segment_fixed(to_torch(image), pt, iters=6,
                                    start_iter=start)
        np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
        for name in ("phi", "energy", "delta", "c1", "c2"):
            assert_rel(getattr(got, name), getattr(want, name), 1e-10)
    rgb = colored_squares(32, 48, noise=8.0)[0]
    want = jscalar.segment(jnp.asarray(rgb), pj.replace(max_iter=60))
    got = tscalar.segment(to_torch(rgb), pt.replace(max_iter=60))
    assert got.iters == int(want.iters)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    res = tscalar.segment(torch.zeros(8, 8, 3), pt.replace(max_iter=2,
                                                           reinit_every=0))
    assert res.iters == 2 and tuple(res.c1.shape) == (3,)


@pytest.mark.parametrize("init", ["checkerboard", "circle"])
def test_wavefront_matches_stored_golden(image, init):
    """The parity mode (exact raster Gauss-Seidel) against the C-baseline
    f64 goldens, at the reference's own bar."""
    _, pt = params(order="wavefront", init=init)
    tr = tscalar.segment_fixed(to_torch(image), pt, iters=60)
    gold = read_energy_csv(GOLD / f"config1_64_{init}_f64.csv")
    rel = np.abs(to_np(tr.energy) - gold["energy"]) / np.abs(gold["energy"])
    assert float(rel.max()) < 1e-5, rel.max()
