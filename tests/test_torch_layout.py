"""The layout kernels of the port against the JAX reference: K13
(``packed_chunk``, flat and packed) and the parity pack and unpack
(K15/K16: ``pack_planes`` and ``unpack_planes``, through which every
packed route packs).

- ``packed_chunk``'s plain version against ``pallas_packed.packed_chunk(
  interpret=True)`` in both layouts at k = 1, 3, 8: f64 at 1e-10 (the
  Heaviside partial sums at 1e-8: the reference's Cephes atan is only
  f32-accurate), f32 at tests/test_packed.py's bars.
- ``supports_packed`` equals the reference's predicate; off-envelope
  shapes and an ``unroll`` that does not divide k raise, as there.
- The plain pack and unpack are bitwise the reference's ``_pack``,
  ``_unpack``, ``_pack_n`` and ``_unpack_n`` on f64 inputs, round trips are
  the identity, odd shapes raise, and the packed routes pack through the
  module's ``pack_planes``/``unpack_planes``. The reference's MXU pack
  turns -0.0 into +0.0 and flushes denormals; the port keeps both.
- ``cuda``-marked twins hold K13 (both layouts) and K15/K16 against their
  plain versions on the card (skipped without a GPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.ops import pallas_packed
from chan_vese_tpu.ops.reductions import region_means as j_region_means
from chan_vese_tpu_torch.models import banded as tbanded
from chan_vese_tpu_torch.ops import banded_kernel, packed_kernel
from torch_port_helpers import assert_rel, cuda_device, params, to_np, \
    to_torch

F32 = np.float32
SHAPE = (64, 256)
PHI_TOL = dict(rtol=2e-6, atol=2e-5)
PARTS_TOL = dict(rtol=2e-5, atol=0.5)


def _chunk_inputs(dtype, shape=SHAPE, seed=0):
    """(phi, u0, c1, c2) numpy: tests/test_packed.py's random case, the
    means from the reference."""
    rng = np.random.default_rng(seed)
    u0 = rng.uniform(0, 255, shape).astype(dtype)
    phi = (rng.standard_normal(shape) * 5).astype(dtype)
    c1, c2 = j_region_means(jnp.asarray(u0), jnp.asarray(phi), 1.0)
    return phi, u0, dtype(c1), dtype(c2)


@pytest.fixture(scope="module")
def pallas_chunks():
    """The reference's packed_chunk in interpret mode, per (dtype, k,
    packed)."""
    pj, _ = params()
    out = {}
    for dt in (np.float64, F32):
        args = [jnp.asarray(a) for a in _chunk_inputs(dt)]
        for k in (1, 3, 8):
            for packed in (True, False):
                out[dt, k, packed] = pallas_packed.packed_chunk(
                    *args, pj, k, packed=packed, interpret=True)
    return out


# K13 ---------------------------------------------------------------------

@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_packed_chunk_f64_matches_pallas(pallas_chunks, k, packed):
    _, pt = params()
    args = [to_torch(a) for a in _chunk_inputs(np.float64)]
    got, parts = packed_kernel.packed_chunk(*args, pt, k, packed=packed)
    want, wparts = (np.asarray(a) for a in pallas_chunks[np.float64, k,
                                                          packed])
    assert tuple(got.shape) == SHAPE and tuple(parts.shape) == (8,)
    assert_rel(got, want, 1e-10)
    assert_rel(parts[:2], wparts[:2], 1e-8)
    assert_rel(parts[2:], wparts[2:], 1e-10)
    # the plain version is the frozen-means chunk of either layout
    ref, rparts = packed_kernel.packed_chunk_reference(*args, pt, k)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(parts, rparts, rtol=0, atol=0)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_packed_chunk_f32_matches_pallas(pallas_chunks, k, packed):
    _, pt = params()
    args = [to_torch(a, F32) for a in _chunk_inputs(F32)]
    got, parts = packed_kernel.packed_chunk(*args, pt, k, packed=packed)
    want, wparts = (np.asarray(a) for a in pallas_chunks[F32, k, packed])
    np.testing.assert_allclose(to_np(got), want, **PHI_TOL)
    np.testing.assert_allclose(to_np(parts)[:5], wparts[:5], **PARTS_TOL)
    np.testing.assert_array_equal(to_np(parts)[5:], 0.0)


def test_packed_chunk_equals_banded_chunk_plain():
    """The banded_chunk contract: the same k-chunk and the same partials."""
    _, pt = params()
    args = [to_torch(a) for a in _chunk_inputs(np.float64, (96, 256), 1)]
    for k in (1, 4):
        got = packed_kernel.packed_chunk(*args, pt, k, unroll=k)
        want = banded_kernel.banded_chunk_reference(*args, pt, k)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_supports_packed_matches_reference():
    for h in (8, 16, 32, 48, 64, 512, 720, 1024, 1040, 2048):
        for w in (128, 256, 384, 512, 1024, 1280, 2048):
            assert packed_kernel.supports_packed(h, w) \
                == pallas_packed.supports_packed(h, w), (h, w)


def test_packed_chunk_validates_arguments():
    _, pt = params()
    phi, u0, c1, c2 = (to_torch(a) for a in _chunk_inputs(np.float64))
    with pytest.raises(ValueError, match="unroll"):
        packed_kernel.packed_chunk(phi, u0, c1, c2, pt, 8, unroll=3)
    with pytest.raises(ValueError, match="unroll"):
        packed_kernel.packed_chunk(phi, u0, c1, c2, pt, 8, unroll=0)
    with pytest.raises(ValueError, match="k must"):
        packed_kernel.packed_chunk(phi, u0, c1, c2, pt, 0)
    with pytest.raises(ValueError, match="unsupported"):
        packed_kernel.packed_chunk(phi[:, :128], u0[:, :128], c1, c2, pt)
    with pytest.raises(ValueError, match="unsupported"):
        packed_kernel.packed_chunk(phi[:56], u0[:56], c1, c2, pt)
    with pytest.raises(ValueError, match="one"):
        packed_kernel.packed_chunk(phi, u0[:32], c1, c2, pt)
    # unroll changes nothing
    a = packed_kernel.packed_chunk(phi, u0, c1, c2, pt, 8, unroll=4)
    b = packed_kernel.packed_chunk(phi, u0, c1, c2, pt, 8)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# K15 / K16 -------------------------------------------------------------------

PACK_SHAPES = [(32, 512), (16, 120), (6, 10)]


def _values(shape, seed=7):
    return np.random.default_rng(seed).uniform(-300, 300, shape)


@pytest.mark.parametrize("shape", PACK_SHAPES)
def test_pack_plain_bitwise_equals_reference(shape):
    """Both of the reference's formulations: the MXU lane deinterleave at
    W % 256 == 0 and the reshape + transpose otherwise."""
    x = _values(shape)
    planes = packed_kernel.pack_planes_reference(to_torch(x))
    np.testing.assert_array_equal(to_np(planes),
                                  np.asarray(pallas_packed._pack(
                                      jnp.asarray(x))))
    np.testing.assert_array_equal(
        to_np(packed_kernel.unpack_planes_reference(planes)),
        np.asarray(pallas_packed._unpack(jnp.asarray(to_np(planes)))))
    xn = _values((3, *shape), seed=8)
    planes_n = packed_kernel.pack_planes_reference(to_torch(xn))
    np.testing.assert_array_equal(to_np(planes_n),
                                  np.asarray(pallas_packed._pack_n(
                                      jnp.asarray(xn))))
    np.testing.assert_array_equal(
        to_np(packed_kernel.unpack_planes_reference(planes_n)),
        np.asarray(pallas_packed._unpack_n(jnp.asarray(to_np(planes_n)))))


@pytest.mark.parametrize("shape", PACK_SHAPES)
def test_pack_round_trip_and_names(shape):
    """A stack packs frame by frame as the single images do; round trips
    are the identity."""
    x = to_torch(_values((2, *shape)))
    planes = packed_kernel.pack_planes(x)
    assert tuple(planes.shape) == (2, 2, 2, shape[0] // 2, shape[1] // 2)
    assert planes.is_contiguous()
    torch.testing.assert_close(planes[1, 1, 0], x[1, 1::2, 0::2], rtol=0,
                               atol=0)
    torch.testing.assert_close(packed_kernel.unpack_planes(planes), x,
                               rtol=0, atol=0)
    one = packed_kernel.pack_planes(x[0])
    torch.testing.assert_close(one, planes[0], rtol=0, atol=0)
    torch.testing.assert_close(packed_kernel.unpack_planes(one), x[0],
                               rtol=0, atol=0)


def test_pack_names_follow_the_module_pack(monkeypatch):
    """The packed banded routes (gray K3, RGB K6) pack phi and the image
    and unpack the result through whatever pack_planes and unpack_planes
    the module holds at the call (chip_smoke.py's plain route swaps them
    for their plain versions)."""
    calls = []

    def spy(name, fn):
        return lambda x: calls.append((name, tuple(x.shape))) or fn(x)

    monkeypatch.setattr(packed_kernel, "pack_planes",
                        spy("pack", packed_kernel.pack_planes_reference))
    monkeypatch.setattr(packed_kernel, "unpack_planes",
                        spy("unpack", packed_kernel.unpack_planes_reference))
    _, pt = params()
    for shape, image in (((64, 256), (64, 256)),
                         ((64, 256, 3), (3, 64, 256))):
        calls.clear()
        u0 = to_torch(_values(shape, seed=9) % 255.0)
        tbanded.segment_banded_fixed(u0, pt, iters=3, k=2, packed=True)
        assert calls == [("pack", (64, 256)), ("pack", image),
                         ("unpack", (2, 2, 32, 128))], shape


def test_pack_keeps_signed_zeros_and_denormals():
    """An intended difference: the reference's MXU pack sums x * 1 with
    zeros, which turns -0.0 into +0.0 (and flushes denormals on the TPU);
    the port's pack is a copy."""
    x = np.tile([-0.0, 1e-310, 2.0, -3.0, -1e-320, 0.0, 5.0, -0.0],
                (4, 32))
    planes = packed_kernel.pack_planes(to_torch(x))
    back = packed_kernel.unpack_planes(planes)
    assert np.array_equal(np.signbit(to_np(back)), np.signbit(x))
    np.testing.assert_array_equal(to_np(back), x)
    assert not np.signbit(np.asarray(pallas_packed._pack(jnp.asarray(x)))
                          ).ravel()[0]


def test_pack_validates_shapes():
    with pytest.raises(ValueError, match="even"):
        packed_kernel.pack_planes(torch.zeros(5, 8))
    with pytest.raises(ValueError, match="even"):
        packed_kernel.pack_planes(torch.zeros(2, 8, 7))
    with pytest.raises(ValueError, match="H, W"):
        packed_kernel.pack_planes(torch.zeros(8))
    with pytest.raises(ValueError, match="planes"):
        packed_kernel.unpack_planes(torch.zeros(3, 2, 4, 4))
    with pytest.raises(ValueError, match="planes"):
        packed_kernel.unpack_planes(torch.zeros(2, 2, 2, 4, 4, 1))


# on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
def test_packed_chunk_cuda_matches_plain(packed):
    """K13 against its plain version at the K2/K3 bars of chip_smoke.py
    (phi rtol 1e-4 / atol 1e-4, partials rtol 1e-4 / atol 16) and against
    banded_chunk on the card; a second launch is bitwise the first."""
    dev = cuda_device()
    _, pt = params()
    args = [to_torch(a, F32).to(dev)
            for a in _chunk_inputs(F32, (128, 256), 2)]
    counts = dict(packed_kernel.packed_chunk.launches)
    for k in (1, 3, 8):
        got, parts = packed_kernel.packed_chunk(*args, pt, k, packed=packed)
        again, aparts = packed_kernel.packed_chunk(*args, pt, k,
                                                   packed=packed)
        want, wparts = packed_kernel.packed_chunk_reference(*args, pt, k)
        band, bparts = banded_kernel.banded_chunk(*args, pt, k)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(parts, aparts)
        for ref, rparts in ((want, wparts), (band, bparts)):
            np.testing.assert_allclose(to_np(got), to_np(ref), rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(to_np(parts), to_np(rparts),
                                       rtol=1e-4, atol=16.0)
    layout = "packed" if packed else "flat"
    assert packed_kernel.packed_chunk.launches[layout] \
        == counts[layout] + 6


@pytest.mark.cuda
def test_pack_cuda_bitwise_equals_plain():
    dev = cuda_device()
    n0 = packed_kernel.pack_planes.launches
    m0 = packed_kernel.unpack_planes.launches
    for shape in ((64, 512), (3, 30, 46), (2, 100, 2)):
        x = torch.from_numpy(_values(shape).astype(F32)).to(dev)
        planes = packed_kernel.pack_planes(x)
        back = packed_kernel.unpack_planes(planes)
        torch.cuda.synchronize()
        assert torch.equal(planes, packed_kernel.pack_planes_reference(x))
        assert torch.equal(back, x)
    # views at an offset of one float and of a frame, a transposed input
    y = torch.from_numpy(_values((5, 16, 64)).astype(F32)).to(dev)
    for view in (y.reshape(-1)[1:1 + 2 * 16 * 30].reshape(2, 16, 30),
                 y[2:], y.transpose(1, 2)):
        assert torch.equal(packed_kernel.pack_planes(view),
                           packed_kernel.pack_planes_reference(view))
    assert packed_kernel.pack_planes.launches == n0 + 6
    assert packed_kernel.unpack_planes.launches == m0 + 3
    with pytest.raises(TypeError, match="float32"):
        packed_kernel.pack_planes(x.double())
