"""The slice end to end: the port's banded drivers (models/banded.py, the
scalar main path) against the JAX drivers with the Pallas kernels in
interpret mode, flat and packed, plus the fallback routes.

Bars are tests/test_banded.py's driver bar (phi rtol 3e-5 / atol 3e-4),
equal iteration counts and identical masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.models import banded as jbanded
from chan_vese_tpu_torch.models import banded as tbanded
from chan_vese_tpu_torch.ops import banded_kernel, fused_kernel, packed_kernel
from fixtures import iou, two_disks
from torch_port_helpers import assert_rel, cuda_device, params, to_np, \
    to_torch

SHAPE = (64, 256)
TOL = dict(rtol=3e-5, atol=3e-4)
KW = dict(tol=1e-4, max_iter=200, min_iter=10)


@pytest.fixture(scope="module")
def image():
    img, gt = two_disks(*SHAPE, noise=6.0)
    return img.astype(np.float32), gt


@pytest.fixture(scope="module")
def jax_runs(image):
    """JAX interpret-mode results of both drivers, flat and packed."""
    u0 = jnp.asarray(image[0])
    pj, _ = params(**KW)
    out = {}
    for packed in (False, True):
        out["fixed", packed] = jbanded.segment_banded_fixed(
            u0, pj, iters=11, k=4, packed=packed, interpret=True)
        out["tol", packed] = jbanded.segment_banded(
            u0, pj, k=4, packed=packed, interpret=True)
    return out


@pytest.mark.parametrize("packed", [False, True])
def test_segment_banded_fixed_matches_reference(image, jax_runs, packed):
    """k=4, 11 iterations: two full chunks and a remainder chunk of 3."""
    _, pt = params(**KW)
    phi, mask = tbanded.segment_banded_fixed(to_torch(image[0], np.float32),
                                             pt, iters=11, k=4, packed=packed)
    want_phi, want_mask = jax_runs["fixed", packed]
    np.testing.assert_allclose(to_np(phi), np.asarray(want_phi), **TOL)
    np.testing.assert_array_equal(to_np(mask), np.asarray(want_mask))


@pytest.mark.parametrize("packed", [False, True])
def test_segment_banded_matches_reference(image, jax_runs, packed):
    _, pt = params(**KW)
    res = tbanded.segment_banded(to_torch(image[0], np.float32), pt, k=4,
                                 packed=packed)
    want = jax_runs["tol", packed]
    assert res.iters == int(want.iters) < KW["max_iter"]
    np.testing.assert_array_equal(to_np(res.mask), np.asarray(want.mask))
    np.testing.assert_allclose(to_np(res.phi), np.asarray(want.phi), **TOL)
    np.testing.assert_allclose(float(res.delta), float(want.delta),
                               rtol=1e-5, atol=1e-6)
    assert iou(to_np(res.mask), image[1]) > 0.7


def test_max_iter_is_exact_and_divergence_aborts(image):
    u0 = to_torch(image[0], np.float32)
    _, pt = params(tol=-1.0, max_iter=10, min_iter=0)
    assert tbanded.segment_banded(u0, pt, k=4).iters == 10
    bad = u0.clone()
    bad[3, 5] = float("nan")
    res = tbanded.segment_banded(bad, pt.replace(max_iter=40), k=4)
    assert res.iters == 4
    assert not np.isfinite(float(res.delta))


@pytest.mark.parametrize("case", ["wavefront", "width100"])
def test_fallback_routes_match_reference(case):
    """Off the banded envelope both packages take the same route: the
    wavefront order runs the plain path, a width that is not a multiple
    of 128 runs the fused driver's plain fallback (f64, to 1e-10)."""
    if case == "wavefront":
        img, _ = two_disks(24, 32, noise=6.0)
        kw = dict(order="wavefront", max_iter=4, tol=-1.0, min_iter=0)
    else:
        img, _ = two_disks(40, 100, noise=6.0)
        kw = dict(max_iter=8, tol=-1.0, min_iter=0)
    pj, pt = params(**kw)
    want = jbanded.segment_banded(jnp.asarray(img), pj, k=4, interpret=True)
    launches = (banded_kernel.banded_chunk, packed_kernel.packed_banded_chunk,
                fused_kernel.fused_iteration)
    before = [f.launches for f in launches]
    got = tbanded.segment_banded(to_torch(img), pt, k=4)
    assert [f.launches for f in launches] == before
    assert got.iters == int(want.iters) == kw["max_iter"]
    assert_rel(got.phi, want.phi, 1e-10)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))


def test_auto_config_routes_4k_to_packed_k8():
    assert tbanded.auto_config(2160, 3840) == (8, 4, True, True)
    assert tbanded.auto_config(*SHAPE)[:3] == (8, 4, False)


@pytest.mark.cuda
def test_segment_banded_cuda_matches_plain_route(image):
    """On the card the driver goes through K3 and lands on the plain
    route's mask (the CPU run of the same driver)."""
    dev = cuda_device()
    _, pt = params(**KW)
    u0 = to_torch(image[0], np.float32)
    n = packed_kernel.packed_banded_chunk.launches
    res = tbanded.segment_banded(u0.to(dev), pt, k=4, packed=True)
    assert packed_kernel.packed_banded_chunk.launches > n
    ref = tbanded.segment_banded(u0, pt, k=4, packed=True)
    assert iou(to_np(res.mask), to_np(ref.mask)) >= 0.999
    assert abs(res.iters - ref.iters) <= 4
    assert torch.isfinite(res.phi).all()
