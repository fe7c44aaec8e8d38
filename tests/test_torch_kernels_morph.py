"""The morphological kernels of the port (K11 ``morph_chunk`` and
``gac_chunk`` with and without ``pre_dg``, K12 ``morph_chunk_fused`` in
ops/morph_kernel.py) against the JAX kernels (ops/pallas_morph.py) in
interpret mode, in float64.

On the CPU each wrapper runs its plain version; every case is held bit
for bit on the level set (binary state, min/max/select arithmetic), K12's
n_in exactly and its sum_in at 1e-12. The shapes are 64 x 128 (one band
in the reference at most k) and 160 x 128 (several bands). The routing
predicates are pure integer functions and must equal the reference's.
``cuda``-marked twins hold each kernel against its plain version on the
card (skipped without a GPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.ops import pallas_morph as jpm
from chan_vese_tpu_torch.ops import morph_kernel as tmk
from chan_vese_tpu_torch.ops.morph import binary_means
from torch_port_helpers import cuda_device, to_np, to_torch

F32 = np.float32


def _inputs(shape, seed):
    """A random image in [0, 255), a random binary level set, and the
    frozen force of the level set's means."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, shape)
    ls = (rng.uniform(size=shape) > 0.5).astype(np.float64)
    w = ls.sum()
    c_in = (img * ls).sum() / (w + 1e-8)
    c_out = (img * (1 - ls)).sum() / (ls.size - w + 1e-8)
    return img, ls, (img - c_in) ** 2 - (img - c_out) ** 2, c_in, c_out


def _supported(shape, k, s, kind):
    assert jpm.supports_morph_banded(*shape, k, s, kind), (shape, k, s, kind)


# (shape, k, smoothing, parity0)
ACWE_CASES = [((64, 128), 1, 1, 0), ((64, 128), 4, 0, 1),
              ((64, 128), 8, 1, 1), ((160, 128), 4, 2, 1),
              ((160, 128), 8, 1, 0), ((160, 128), 1, 2, 1)]


@pytest.mark.parametrize("shape,k,s,parity0", ACWE_CASES)
def test_morph_chunk_matches_pallas(shape, k, s, parity0):
    _supported(shape, k, s, "acwe")
    _, ls, f, _, _ = _inputs(shape, k + s)
    want = jpm.morph_chunk(jnp.asarray(ls), jnp.asarray(f), k=k,
                           smoothing=s, parity0=parity0, interpret=True)
    got = tmk.morph_chunk(to_torch(ls), to_torch(f), k=k, smoothing=s,
                          parity0=parity0)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


# (shape, k, smoothing, parity0, balloon, pre_dg)
GAC_CASES = [((64, 128), 1, 1, 0, -1, False), ((64, 128), 4, 0, 1, 1, True),
             ((64, 128), 4, 1, 1, 0, False), ((160, 128), 8, 1, 0, 1, True),
             ((160, 128), 4, 2, 1, -1, True), ((160, 128), 8, 0, 1, -1, False),
             ((160, 128), 1, 2, 0, 0, True)]


@pytest.mark.parametrize("shape,k,s,parity0,balloon,pre_dg", GAC_CASES)
def test_gac_chunk_matches_pallas(shape, k, s, parity0, balloon, pre_dg):
    _supported(shape, k, s, "gac_pre" if pre_dg else "gac")
    rng = np.random.default_rng(k + 10 * s)
    g = rng.uniform(0.05, 1.0, shape)
    ls = (rng.uniform(size=shape) > 0.5).astype(np.float64)
    kw = dict(k=k, smoothing=s, parity0=parity0, balloon=balloon,
              threshold=0.4, pre_dg=pre_dg)
    want = jpm.gac_chunk(jnp.asarray(ls), jnp.asarray(g), interpret=True,
                         **kw)
    got = tmk.gac_chunk(to_torch(ls), to_torch(g), **kw)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    if pre_dg:  # a prebuilt stack, as the chunk-loop drivers pass it
        stack = tmk.gac_aux_stack(to_torch(g), balloon, 0.4)
        np.testing.assert_array_equal(
            to_np(stack), np.asarray(jpm.gac_aux_stack(jnp.asarray(g),
                                                        balloon, 0.4)))
        np.testing.assert_array_equal(
            to_np(tmk.gac_chunk(to_torch(ls), stack, **kw)), to_np(got))


@pytest.mark.parametrize("shape,k,s,parity0", [((64, 128), 4, 1, 0),
                                               ((160, 128), 8, 1, 1),
                                               ((160, 128), 1, 0, 0),
                                               ((64, 128), 3, 2, 1)])
def test_morph_chunk_fused_matches_pallas(shape, k, s, parity0):
    _supported(shape, k, s, "acwe_fused")
    img, ls, f, c_in, c_out = _inputs(shape, 20 + k)
    want, wparts = jpm.morph_chunk_fused(
        jnp.asarray(ls), jnp.asarray(img), c_in, c_out, 1.0, 1.0, k=k,
        smoothing=s, parity0=parity0, interpret=True)
    got, parts = tmk.morph_chunk_fused(to_torch(ls), to_torch(img), c_in,
                                       c_out, 1.0, 1.0, k=k, smoothing=s,
                                       parity0=parity0)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert tuple(parts.shape) == (2,) and parts.dtype == torch.float64
    assert float(parts[0]) == float(wparts[0]) == float(got.sum())
    np.testing.assert_allclose(float(parts[1]), float(wparts[1]),
                               rtol=1e-12)
    # the same trajectory as morph_chunk on the force plane
    np.testing.assert_array_equal(
        to_np(got), to_np(tmk.morph_chunk(to_torch(ls), to_torch(f), k=k,
                                          smoothing=s, parity0=parity0)))


@pytest.mark.parametrize("kind", ["acwe", "gac", "gac_pre", "acwe_fused",
                                  "acwe_sh", "gac_pre_sh"])
def test_routing_predicates_match_reference(kind):
    for h in (8, 64, 96, 160, 1080, 2160, 4320):
        for w in (100, 128, 1920, 3840, 7680, 16384):
            for k in (1, 2, 4, 8, 16, 65):
                for s in (0, 1, 2, 3):
                    assert (tmk._halo_morph(k, s, kind)
                            == jpm._halo_morph(k, s, kind))
                    assert (tmk.band_rows_morph(h, w, k, s, kind)
                            == jpm.band_rows_morph(h, w, k, s, kind))
                    assert (tmk.supports_morph_banded(h, w, k, s, kind)
                            == jpm.supports_morph_banded(h, w, k, s, kind))
    assert tmk._reach(kind, 2) == jpm._reach(kind, 2)


def test_wrappers_validate_arguments():
    ls, f = torch.zeros(64, 128), torch.zeros(64, 128)
    with pytest.raises(ValueError, match="beside ls"):
        tmk.morph_chunk(ls, torch.zeros(64, 96))
    with pytest.raises(ValueError, match="k must be"):
        tmk.morph_chunk(ls, f, k=0)
    with pytest.raises(ValueError, match="smoothing"):
        tmk.morph_chunk(ls, f, smoothing=-1)
    with pytest.raises(ValueError, match="parity0"):
        tmk.gac_chunk(ls, f, parity0=2)
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        tmk.morph_chunk(torch.zeros(2, 64, 128), torch.zeros(2, 64, 128))
    with pytest.raises(ValueError, match="beside ls"):
        tmk.gac_chunk(ls, torch.zeros(2, 64, 128), pre_dg=True)
    with pytest.raises(ValueError, match="beside ls"):
        tmk.morph_chunk_fused(ls, torch.zeros(64, 128, 3), 1.0, 2.0, 1.0,
                              1.0)


# on the card: each kernel against its plain version ----------------------

def _card_inputs(shape, seed):
    dev = cuda_device()
    img, ls, f, c_in, c_out = (
        torch.as_tensor(np.asarray(a, F32), device=dev)
        for a in _inputs(shape, seed))
    return img, ls, f, c_in, c_out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 384), (1000, 1500)])
def test_morph_chunk_cuda_matches_plain(shape):
    img, ls, f, _, _ = _card_inputs(shape, 1)
    n = tmk.morph_chunk.launches
    for k, s, p0 in ((8, 1, 0), (3, 2, 1)):
        got = tmk.morph_chunk(ls, f, k=k, smoothing=s, parity0=p0)
        want = tmk.morph_chunk_reference(ls, f, k, s, p0)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert tmk.morph_chunk.launches == n + 2


@pytest.mark.cuda
@pytest.mark.parametrize("pre_dg", [False, True])
def test_gac_chunk_cuda_matches_plain(pre_dg):
    dev = cuda_device()
    rng = np.random.default_rng(2)
    g = torch.as_tensor(rng.uniform(0.05, 1, (512, 640)).astype(F32),
                        device=dev)
    ls = torch.as_tensor((rng.uniform(size=(512, 640)) > 0.5).astype(F32),
                         device=dev)
    n = tmk.gac_chunk.launches
    for balloon in (-1, 0, 1):
        kw = dict(k=4, smoothing=1, parity0=1, balloon=balloon,
                  threshold=0.3, pre_dg=pre_dg)
        got = tmk.gac_chunk(ls, g, **kw)
        want = tmk.gac_chunk_reference(ls, g, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert tmk.gac_chunk.launches == n + 3


@pytest.mark.cuda
def test_morph_chunk_fused_cuda_matches_plain():
    img, ls, _, _, _ = _card_inputs((720, 1280), 3)
    c_in, c_out = binary_means(img, ls)
    n = tmk.morph_chunk_fused.launches
    got, parts = tmk.morph_chunk_fused(ls, img, c_in, c_out, 1.0, 1.0, k=5)
    want, wparts = tmk.morph_chunk_fused_reference(ls, img, c_in, c_out, 1.0,
                                                   1.0, k=5)
    torch.cuda.synchronize()
    assert tmk.morph_chunk_fused.launches == n + 1
    assert torch.equal(got, want)
    assert float(parts[0]) == float(wparts[0])
    np.testing.assert_allclose(float(parts[1]), float(wparts[1]), rtol=1e-6)
