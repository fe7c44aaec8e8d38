"""The three red-black kernels of the port (K1 fused, K2 banded, K3
packed): their plain PyTorch versions against the JAX Pallas kernels in
interpret mode (f32), and the CUDA kernels against the plain versions on
the card (``cuda``-marked; skipped without a GPU).

Tolerances are tests/test_banded.py's: phi rtol 2e-6 / atol 2e-5,
partials rtol 2e-5 / atol 0.5. The JAX kernels compute atan with a
Cephes polynomial that is only f32-accurate, so these comparisons are in
f32; f64 comparisons are held against the jnp functions
(test_torch_core.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.ops import pallas_banded, pallas_packed, pallas_sweep
from chan_vese_tpu.ops.reductions import region_means as j_region_means
from chan_vese_tpu_torch.ops import _cuda, banded_kernel, fused_kernel, \
    packed_kernel
from chan_vese_tpu_torch.ops._cuda import tile_geometry
from chan_vese_tpu_torch.ops.reductions import region_means
from torch_port_helpers import cuda_device, params, to_np, to_torch

PHI_TOL = dict(rtol=2e-6, atol=2e-5)
PARTS_TOL = dict(rtol=2e-5, atol=0.5)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    u0 = rng.uniform(0, 255, shape).astype(np.float32)
    phi = rng.standard_normal(shape).astype(np.float32)
    return u0, phi


def _means(u0, phi):
    """c1/c2 from the reference (f32), handed to both sides."""
    c1, c2 = j_region_means(jnp.asarray(u0), jnp.asarray(phi), 1.0)
    return np.float32(c1), np.float32(c2)


def _check(got, want):
    np.testing.assert_allclose(to_np(got[0]), np.asarray(want[0]),
                               **PHI_TOL)
    np.testing.assert_allclose(to_np(got[1]), np.asarray(want[1]),
                               **PARTS_TOL)


@pytest.fixture(scope="module")
def flat_case():
    """(96, 256) inputs and the JAX interpret-mode kernel outputs."""
    u0, phi = _inputs((96, 256), 0)
    c1, c2 = _means(u0, phi)
    pj, pt = params()
    ju, jp = jnp.asarray(u0), jnp.asarray(phi)
    want = {"fused": pallas_sweep.fused_iteration(jp, ju, c1, c2, pj,
                                                  interpret=True)}
    for k in (1, 3, 8):
        want[k] = pallas_banded.banded_chunk(jp, ju, c1, c2, pj, k,
                                             interpret=True)
    return u0, phi, c1, c2, pt, want


def test_fused_iteration_plain_matches_pallas(flat_case):
    u0, phi, c1, c2, pt, want = flat_case
    got = fused_kernel.fused_iteration(to_torch(phi, np.float32),
                                       to_torch(u0, np.float32),
                                       torch.tensor(c1), torch.tensor(c2), pt)
    _check(got, want["fused"])


@pytest.mark.parametrize("k", [1, 3, 8])
def test_banded_chunk_plain_matches_pallas(flat_case, k):
    u0, phi, c1, c2, pt, want = flat_case
    got = banded_kernel.banded_chunk(to_torch(phi, np.float32),
                                     to_torch(u0, np.float32),
                                     torch.tensor(c1), torch.tensor(c2), pt,
                                     k)
    _check(got, want[k])


def test_banded_k1_equals_fused(flat_case):
    u0, phi, c1, c2, pt, _ = flat_case
    args = (to_torch(phi, np.float32), to_torch(u0, np.float32),
            torch.tensor(c1), torch.tensor(c2), pt)
    a = banded_kernel.banded_chunk(*args, 1)
    b = fused_kernel.fused_iteration(*args)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)


@pytest.mark.parametrize("k", [4, 8])
def test_packed_banded_chunk_plain_matches_pallas(k):
    u0, phi = _inputs((64, 256), 1)
    c1, c2 = _means(u0, phi)
    pj, pt = params()
    want = pallas_packed.packed_banded_chunk(
        pallas_packed._pack(jnp.asarray(phi)),
        pallas_packed._pack(jnp.asarray(u0)), c1, c2, pj, k, interpret=True)
    got = packed_kernel.packed_banded_chunk(
        packed_kernel.pack_planes(to_torch(phi, np.float32)),
        packed_kernel.pack_planes(to_torch(u0, np.float32)),
        torch.tensor(c1), torch.tensor(c2), pt, k)
    _check(got, want)


def test_wrappers_validate_arguments():
    _, pt = params()
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="unroll"):
        banded_kernel.banded_chunk(x, x, 0.0, 0.0, pt, 8, unroll=3)
    with pytest.raises(ValueError, match="planes"):
        packed_kernel.packed_banded_chunk(x, x, 0.0, 0.0, pt, 4)
    # the tile fits the 227 KB of shared memory for the driver's k, and
    # a k too deep for any tile is refused before launch
    th, tw, cap = tile_geometry(2160, 3840, 8)
    assert (th, tw) == (64, 128) and 10 * cap <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        tile_geometry(2160, 3840, 40)


# On the card: each kernel against its plain version ----------------------

def _card_case(dev, shape, seed):
    u0, phi = _inputs(shape, seed)
    u0_t = to_torch(u0, np.float32).to(dev)
    phi_t = to_torch(phi, np.float32).to(dev)
    c1, c2 = region_means(u0_t, phi_t, 1.0)
    return phi_t, u0_t, c1, c2


def _check_card(got, want):
    """The kernel's rsqrtf, atanf and FMA contraction differ from PyTorch's
    CUDA ops in the last ulps; over k iterations that stays below
    1e-5 relative / 1e-4 absolute in phi."""
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_np(got[0]), to_np(want[0]), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(got[1]), to_np(want[1]), **PARTS_TOL)


@pytest.mark.cuda
def test_fused_iteration_cuda_matches_plain():
    phi, u0, c1, c2 = _card_case(cuda_device(), (200, 300), 2)
    _, pt = params()
    n = fused_kernel.fused_iteration.launches
    got = fused_kernel.fused_iteration(phi, u0, c1, c2, pt)
    assert fused_kernel.fused_iteration.launches == n + 1
    _check_card(got, fused_kernel.fused_iteration_reference(phi, u0, c1, c2,
                                                            pt))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8])
def test_banded_chunk_cuda_matches_plain(k):
    phi, u0, c1, c2 = _card_case(cuda_device(), (200, 300), 3)
    _, pt = params()
    got = banded_kernel.banded_chunk(phi, u0, c1, c2, pt, k)
    _check_card(got, banded_kernel.banded_chunk_reference(phi, u0, c1, c2,
                                                          pt, k))


@pytest.mark.cuda
def test_packed_banded_chunk_cuda_matches_plain():
    phi, u0, c1, c2 = _card_case(cuda_device(), (200, 300), 4)
    _, pt = params()
    pp, up = packed_kernel.pack_planes(phi), packed_kernel.pack_planes(u0)
    got = packed_kernel.packed_banded_chunk(pp, up, c1, c2, pt, 8)
    _check_card(got, packed_kernel.packed_banded_chunk_reference(
        pp, up, c1, c2, pt, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8, 21])
@pytest.mark.parametrize("shape", [(200, 300), (1000, 1500)])
def test_banded_chunk_cuda_is_bitwise_the_first_body(shape, k):
    """K2 on csrc/band.cuh against the first body (redblack.cuh, the
    `_v1` launcher): the level set bitwise, the flips exactly, the other
    sums at the plain bars; a second launch bitwise the first."""
    phi, u0, c1, c2 = _card_case(cuda_device(), shape, 5)
    _, pt = params()
    n = banded_kernel.banded_chunk.launches
    got = banded_kernel.banded_chunk(phi, u0, c1, c2, pt, k)
    again = banded_kernel.banded_chunk(phi, u0, c1, c2, pt, k)
    old = _cuda.launch_chunk("cv_banded_chunk_v1", phi, u0, c1, c2, pt, k,
                             *shape)
    torch.cuda.synchronize()
    assert banded_kernel.banded_chunk.launches == n + 2
    assert torch.equal(got[0], old[0])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert float(got[1][3]) == float(old[1][3])
    np.testing.assert_allclose(to_np(got[1]), to_np(old[1]), **PARTS_TOL)



@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 21])
@pytest.mark.parametrize("shape", [(200, 300), (1000, 1500)])
def test_packed_banded_chunk_cuda_is_bitwise_the_first_body(shape, k):
    """K3 on csrc/band.cuh against the first body (the `_v1` launcher on
    the planes): the level set bitwise, the flips exactly, the other sums
    at the plain bars; a second launch bitwise the first."""
    phi, u0, c1, c2 = _card_case(cuda_device(), shape, 7)
    _, pt = params()
    pp, up = packed_kernel.pack_planes(phi), packed_kernel.pack_planes(u0)
    n = packed_kernel.packed_banded_chunk.launches
    got = packed_kernel.packed_banded_chunk(pp, up, c1, c2, pt, k)
    again = packed_kernel.packed_banded_chunk(pp, up, c1, c2, pt, k)
    old = _cuda.launch_chunk("cv_packed_banded_chunk_v1", pp, up, c1, c2,
                             pt, k, *shape)
    torch.cuda.synchronize()
    assert packed_kernel.packed_banded_chunk.launches == n + 2
    assert torch.equal(got[0], old[0])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert float(got[1][3]) == float(old[1][3])
    np.testing.assert_allclose(to_np(got[1]), to_np(old[1]), **PARTS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 21])
@pytest.mark.parametrize("shape", [(200, 300), (1000, 1500)])
def test_packed_banded_chunk_cuda_is_the_flat_band_packed(shape, k):
    """K3 is K2's band launch on the unpacked image, packed: phi and every
    partial slot bitwise (the same tiles, cell order and sums)."""
    phi, u0, c1, c2 = _card_case(cuda_device(), shape, 8)
    _, pt = params()
    pp, up = packed_kernel.pack_planes(phi), packed_kernel.pack_planes(u0)
    got = packed_kernel.packed_banded_chunk(pp, up, c1, c2, pt, k)
    flat = banded_kernel.banded_chunk(phi, u0, c1, c2, pt, k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], packed_kernel.pack_planes(flat[0]))
    assert torch.equal(got[1], flat[1])
