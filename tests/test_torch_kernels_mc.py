"""The three multichannel red-black kernels of the port (K4 fused, K5
banded, K6 packed) on a C-channel image: their plain PyTorch versions
against the JAX Pallas kernels in interpret mode (f32, per-channel
lambdas), the partials layouts, argument validation, the reference's mc
routing predicates, and the CUDA kernels against the plain versions on
the card (``cuda``-marked; skipped without a GPU).

Tolerances are tests/test_torch_kernels.py's (tests/test_banded.py's):
phi rtol 2e-6 / atol 2e-5, partials rtol 2e-5 / atol 0.5, in f32 because
the JAX kernels compute atan with an f32-accurate Cephes polynomial.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.models import banded as jbanded
from chan_vese_tpu.ops import pallas_banded, pallas_packed, pallas_sweep_mc
from chan_vese_tpu.ops.reductions import region_means as j_region_means
from chan_vese_tpu_torch.models import banded as tbanded
from chan_vese_tpu_torch.ops import (banded_kernel, fused_kernel_mc,
                                     packed_kernel)
from chan_vese_tpu_torch.ops.reductions import region_means
from torch_port_helpers import assert_digest, cuda_device, params, to_np, \
    to_torch

PHI_TOL = dict(rtol=2e-6, atol=2e-5)
PARTS_TOL = dict(rtol=2e-5, atol=0.5)
LAM = dict(lambda1=(1.0, 1.2, 0.8), lambda2=(0.9, 1.0, 1.1))
# With lambda1 != lambda2 in a channel the force does not vanish where
# c1 = c2, and over deep chunks from a random phi the last-ulp differences
# between two f32 evaluation orders grow past the bar (5e-5 at k = 8);
# deep chunks take per-channel weights equal inside and outside.
LAM_DEEP = dict(lambda1=(1.0, 1.2, 0.8), lambda2=(1.0, 1.2, 0.8))


def _lam(k):
    return LAM if k <= 3 else LAM_DEEP


def _inputs(shape, seed):
    """u0 (C, H, W) channels-first, phi (H, W), and the reference's f32
    per-channel means handed to both sides."""
    rng = np.random.default_rng(seed)
    c, h, w = shape
    ucf = rng.uniform(0, 255, shape).astype(np.float32)
    phi = rng.standard_normal((h, w)).astype(np.float32)
    c1, c2 = j_region_means(jnp.asarray(np.moveaxis(ucf, 0, -1)),
                            jnp.asarray(phi), 1.0)
    return ucf, phi, np.asarray(c1, np.float32), np.asarray(c2, np.float32)


def _torch(ucf, phi, c1, c2):
    return (to_torch(phi, np.float32), to_torch(ucf, np.float32),
            to_torch(c1, np.float32), to_torch(c2, np.float32))


def _check(got, want):
    np.testing.assert_allclose(to_np(got[0]), np.asarray(want[0]),
                               **PHI_TOL)
    assert tuple(got[1].shape) == tuple(want[1].shape)
    np.testing.assert_allclose(to_np(got[1]), np.asarray(want[1]),
                               **PARTS_TOL)


@pytest.fixture(scope="module")
def flat_case():
    """(3, 96, 256) inputs and the JAX interpret-mode kernel outputs."""
    ucf, phi, c1, c2 = _inputs((3, 96, 256), 0)
    pj, pt = params()
    ju, jp = jnp.asarray(ucf), jnp.asarray(phi)
    want = {"fused": pallas_sweep_mc.fused_iteration_mc(
        jp, ju, c1, c2, pj, **LAM, interpret=True)}
    for k in (1, 3, 8):
        want[k] = pallas_banded.banded_chunk_mc(jp, ju, c1, c2, pj, k,
                                                **_lam(k), interpret=True)
    return (ucf, phi, c1, c2), pt, want


def test_fused_iteration_mc_plain_matches_pallas(flat_case):
    inputs, pt, want = flat_case
    got = fused_kernel_mc.fused_iteration_mc(*_torch(*inputs), pt, **LAM)
    assert tuple(got[1].shape) == (3 + 4,)
    _check(got, want["fused"])


@pytest.mark.parametrize("k", [1, 3, 8])
def test_banded_chunk_mc_plain_matches_pallas(flat_case, k):
    inputs, pt, want = flat_case
    got = banded_kernel.banded_chunk_mc(*_torch(*inputs), pt, k, **_lam(k))
    assert tuple(got[1].shape) == (16,)
    _check(got, want[k])


def test_banded_mc_k1_equals_fused_mc(flat_case):
    inputs, pt, _ = flat_case
    args = (*_torch(*inputs), pt)
    a = banded_kernel.banded_chunk_mc(*args, 1, **LAM)
    b = fused_kernel_mc.fused_iteration_mc(*args, **LAM)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[1][:7], b[1], rtol=0, atol=0)
    assert not a[1][7:].any()


@pytest.mark.parametrize("k", [4, 8])
def test_packed_banded_chunk_mc_plain_matches_pallas(k):
    ucf, phi, c1, c2 = _inputs((3, 64, 256), 1)
    pj, pt = params()
    want = pallas_packed.packed_banded_chunk_mc(
        pallas_packed._pack(jnp.asarray(phi)),
        pallas_packed._pack_mc(jnp.asarray(ucf)), c1, c2, pj, k, **_lam(k),
        interpret=True)
    phi_t, u_t, c1_t, c2_t = _torch(ucf, phi, c1, c2)
    got = packed_kernel.packed_banded_chunk_mc(
        packed_kernel.pack_planes(phi_t), packed_kernel.pack_planes(u_t), c1_t, c2_t,
        pt, k, **_lam(k))
    assert tuple(got[1].shape) == (16,)
    _check(got, want)


@pytest.mark.parametrize("nchan", [1, 2, 5])
def test_partials_layout_per_channel_count(nchan):
    """s_uH per channel, then s_H, s_dphi2, flips, s_absdphi: C + 4 slots
    from K4, padded with zeros to 16 from K5."""
    ucf, phi, c1, c2 = _inputs((nchan, 32, 128), 2)
    _, pt = params()
    args = (*_torch(ucf, phi, c1, c2), pt)
    _, fused = fused_kernel_mc.fused_iteration_mc(*args)
    phi_new, banded = banded_kernel.banded_chunk_mc(*args, 1)
    assert tuple(fused.shape) == (nchan + 4,)
    assert tuple(banded.shape) == (16,)
    assert not banded[nchan + 4:].any()
    h = 0.5 + torch.atan(phi_new) / np.pi
    want_uh = (to_torch(ucf, np.float32) * h).sum(dim=(1, 2))
    torch.testing.assert_close(fused[:nchan], want_uh, rtol=1e-5, atol=0.5)
    torch.testing.assert_close(fused[nchan], h.sum(), rtol=1e-5, atol=0.5)


def test_pack_n_unpack_n_bitwise_against_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 32, 512)).astype(np.float32)
    want = np.asarray(pallas_packed._pack_mc(jnp.asarray(x)))
    got = packed_kernel.pack_planes(to_torch(x, np.float32))
    np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(to_np(packed_kernel.unpack_planes(got)), x)
    np.testing.assert_array_equal(
        np.asarray(pallas_packed._unpack_n(jnp.asarray(want))),
        to_np(packed_kernel.unpack_planes(got)))


def test_mc_wrappers_validate_arguments():
    _, pt = params()
    phi = torch.zeros(8, 16)
    c = torch.zeros(3)
    with pytest.raises(ValueError, match="must be"):
        fused_kernel_mc.fused_iteration_mc(phi, torch.zeros(3, 8, 8), c, c,
                                           pt)
    with pytest.raises(ValueError, match="channels"):
        banded_kernel.banded_chunk_mc(phi, torch.zeros(9, 8, 16), c, c, pt,
                                      4)
    with pytest.raises(ValueError, match="must be"):
        banded_kernel.banded_chunk_mc(phi, phi, c, c, pt, 4)
    with pytest.raises(ValueError, match="unroll"):
        banded_kernel.banded_chunk_mc(phi, torch.zeros(3, 8, 16), c, c, pt,
                                      8, unroll=3)
    with pytest.raises(ValueError, match="planes"):
        packed_kernel.packed_banded_chunk_mc(phi, torch.zeros(3, 8, 16), c,
                                             c, pt, 4)
    with pytest.raises(ValueError, match="length 3"):
        fused_kernel_mc.fused_iteration_mc(phi, torch.zeros(3, 8, 16), c, c,
                                           pt, lambda1=(1.0, 2.0))


def test_mc_routing_predicates_match_reference():
    shapes = [(24, 128), (64, 128), (64, 256), (96, 256), (40, 100),
              (1080, 1920), (2160, 3840), (4320, 7680), (1000, 1500),
              (72, 384), (16, 256), (8, 128)]
    for h, w in shapes:
        for c in (0, 1, 3, 8, 9):
            assert fused_kernel_mc.supports_mc(h, w, c) \
                == pallas_sweep_mc.supports_mc(h, w, c), (h, w, c)
            for k in (1, 3, 4, 8, 16, 64, 65):
                assert banded_kernel.supports_banded_mc(h, w, k, c) \
                    == pallas_banded.supports_banded_mc(h, w, k, c)
                assert packed_kernel.supports_packed_banded_mc(h, w, k, c) \
                    == pallas_packed.supports_packed_banded_mc(h, w, k, c)
            if 1 <= c <= 8:
                assert fused_kernel_mc.band_rows_mc(h, w, c) \
                    == pallas_sweep_mc.band_rows_mc(h, w, c)
                assert banded_kernel.band_rows_banded_mc(h, w, 8, c) \
                    == pallas_banded.band_rows_banded_mc(h, w, 8, c)
                assert packed_kernel.band_rows_packed_mc(h, w, 8, c) \
                    == pallas_packed.band_rows_packed_mc(h, w, 8, c)
                for k in (1, 4, 8, 16):
                    for pk in (None, True, False):
                        assert tbanded.auto_config_mc(h, w, c, k, None, pk) \
                            == jbanded.auto_config_mc(h, w, c, k, None, pk)
    for up, dn, extra in ((16, 8, 0), (32, 16, 4)):
        assert banded_kernel._tile_height_cap(3840, up, dn, extra) \
            == pallas_banded._tile_height_cap(3840, up, dn, extra)


# On the card: each kernel against its plain version ----------------------

def _card_case(dev, shape, seed):
    ucf, phi, _, _ = _inputs(shape, seed)
    u_t = to_torch(ucf, np.float32).to(dev)
    phi_t = to_torch(phi, np.float32).to(dev)
    c1, c2 = region_means(u_t.permute(1, 2, 0), phi_t, 1.0)
    return phi_t, u_t, c1, c2


def _check_card(got, want):
    """As tests/test_torch_kernels.py: the kernel's rsqrtf, atanf and FMA
    contraction differ from PyTorch's CUDA ops in the last ulps."""
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_np(got[0]), to_np(want[0]), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(got[1]), to_np(want[1]), **PARTS_TOL)


def _check_other_sums(got, want, flips):
    """As tests/test_torch_kernels.py: the partial sums but the flips (held
    bitwise by the digest) at the plain version's bars."""
    np.testing.assert_allclose(np.delete(to_np(got[1]), flips),
                               np.delete(to_np(want[1]), flips), **PARTS_TOL)


@pytest.mark.cuda
def test_fused_iteration_mc_cuda_matches_plain():
    phi, u0, c1, c2 = _card_case(cuda_device(), (3, 200, 300), 2)
    _, pt = params()
    n = fused_kernel_mc.fused_iteration_mc.launches
    got = fused_kernel_mc.fused_iteration_mc(phi, u0, c1, c2, pt, **LAM)
    assert fused_kernel_mc.fused_iteration_mc.launches == n + 1
    assert tuple(got[1].shape) == (7,)
    _check_card(got, fused_kernel_mc.fused_iteration_mc_reference(
        phi, u0, c1, c2, pt, **LAM))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8])
def test_banded_chunk_mc_cuda_matches_plain(k):
    phi, u0, c1, c2 = _card_case(cuda_device(), (3, 200, 300), 3)
    _, pt = params()
    got = banded_kernel.banded_chunk_mc(phi, u0, c1, c2, pt, k)
    _check_card(got, banded_kernel.banded_chunk_mc_reference(
        phi, u0, c1, c2, pt, k))


@pytest.mark.cuda
@pytest.mark.parametrize("nchan", [1, 8])
def test_packed_banded_chunk_mc_cuda_matches_plain(nchan):
    phi, u0, c1, c2 = _card_case(cuda_device(), (nchan, 200, 300), 4)
    _, pt = params()
    pp, up = packed_kernel.pack_planes(phi), packed_kernel.pack_planes(u0)
    got = packed_kernel.packed_banded_chunk_mc(pp, up, c1, c2, pt, 8)
    _check_card(got, packed_kernel.packed_banded_chunk_mc_reference(
        pp, up, c1, c2, pt, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 21])
@pytest.mark.parametrize("nchan", [1, 3, 8])
def test_banded_chunk_mc_cuda_is_bitwise_the_first_body(nchan, k):
    """K5 on csrc/band.cuh: the level set and the flips bitwise the first
    body's recorded output, the other sums at the plain version's bars; a
    second launch bitwise the first."""
    phi, u0, c1, c2 = _card_case(cuda_device(), (nchan, 1000, 1500), 6)
    _, pt = params()
    got = banded_kernel.banded_chunk_mc(phi, u0, c1, c2, pt, k)
    again = banded_kernel.banded_chunk_mc(phi, u0, c1, c2, pt, k)
    torch.cuda.synchronize()
    assert_digest(f"K5 C={nchan} k={k}", got[0],
                  got[1][nchan + 2:nchan + 3])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = banded_kernel.banded_chunk_mc_reference(phi, u0, c1, c2, pt, k)
    _check_other_sums(got, want, nchan + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 21])
@pytest.mark.parametrize("nchan", [1, 3, 8])
def test_packed_banded_chunk_mc_cuda_is_bitwise_the_first_body(nchan, k):
    """K6 on csrc/band.cuh: the planes and the flips bitwise the first
    body's recorded output, the other sums at the plain version's bars; a
    second launch bitwise the first; and K5's band launch on the unpacked
    image, packed, bitwise in phi and in every partial slot."""
    phi, u0, c1, c2 = _card_case(cuda_device(), (nchan, 1000, 1500), 9)
    _, pt = params()
    pp, up = packed_kernel.pack_planes(phi), packed_kernel.pack_planes(u0)
    n = packed_kernel.packed_banded_chunk_mc.launches
    got = packed_kernel.packed_banded_chunk_mc(pp, up, c1, c2, pt, k)
    again = packed_kernel.packed_banded_chunk_mc(pp, up, c1, c2, pt, k)
    flat = banded_kernel.banded_chunk_mc(phi, u0, c1, c2, pt, k)
    torch.cuda.synchronize()
    assert packed_kernel.packed_banded_chunk_mc.launches == n + 2
    assert_digest(f"K6 C={nchan} k={k}", got[0],
                  got[1][nchan + 2:nchan + 3])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = packed_kernel.packed_banded_chunk_mc_reference(pp, up, c1, c2, pt,
                                                          k)
    _check_other_sums(got, want, nchan + 2)
    assert torch.equal(got[0], packed_kernel.pack_planes(flat[0]))
    assert torch.equal(got[1], flat[1])
