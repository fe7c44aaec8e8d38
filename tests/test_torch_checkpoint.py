"""The port's ``.npz`` checkpoints (utils/checkpoint.py) against the JAX
package's and against the port's unchunked drivers, in f64 at 32x64.

- The chunked scalar run (also with a reinit cadence that the chunks cut
  through), the vector run with per-channel lambdas and the multiphase run
  against the unchunked drivers (phi within 1e-10 of its scale, masks and
  labels identical) and against the reference's checkpointed runs.
- The file layout and names, the torn ``.tmp_ckpt_*`` file never picked,
  the level set loaded on the image's device in the image's dtype.
- The raises (every <= 0, the reinit alignment of the multiphase chunks)
  and the rerun after completion.
- The format is the reference's: a checkpoint the JAX package wrote is
  resumed by the port, and the reverse, to the uninterrupted result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.utils import checkpoint as jck
from chan_vese_tpu_torch.models.multiphase import segment_multiphase
from chan_vese_tpu_torch.models.scalar import segment_fixed
from chan_vese_tpu_torch.models.vector import segment_vector_fixed
from chan_vese_tpu_torch.utils import checkpoint as tck
from fixtures import colored_squares, four_regions, two_disks
from torch_port_helpers import assert_rel, params, to_np, to_torch

LAM = dict(lambda1=(1.0, 1.2, 0.8), lambda2=(0.9, 1.0, 1.1))


def gray():
    return two_disks(32, 64, noise=6.0)[0]


def mp_image():
    return four_regions(32, 64, noise=4.0)[0]


@pytest.mark.parametrize("every", [3, 4, 10, 25])
def test_scalar_chunked_equals_unchunked(tmp_path, every):
    img = gray()
    pj, pt = params()
    phi = tck.segment_with_checkpoints(to_torch(img), pt, 10, tmp_path,
                                       every=every)
    ref = segment_fixed(to_torch(img), pt, iters=10).phi
    assert_rel(phi, ref, 1e-10)
    assert torch.equal(phi >= 0, ref >= 0)
    jphi = jck.segment_with_checkpoints(jnp.asarray(img), pj, 10,
                                        tmp_path / "j", every=every)
    assert_rel(phi, jphi, 1e-10)
    np.testing.assert_array_equal(to_np(phi) >= 0, np.asarray(jphi) >= 0)


def test_scalar_reinit_cadence_across_chunks(tmp_path):
    img = gray()
    pj, pt = params(reinit_every=3, reinit_steps=4)
    phi = tck.segment_with_checkpoints(to_torch(img), pt, 10, tmp_path,
                                       every=4)
    ref = segment_fixed(to_torch(img), pt, iters=10).phi
    assert_rel(phi, ref, 1e-10)
    jphi = jck.segment_with_checkpoints(jnp.asarray(img), pj, 10,
                                        tmp_path / "j", every=4)
    assert_rel(phi, jphi, 1e-10)


def test_vector_per_channel_lambdas(tmp_path):
    img = colored_squares(32, 64, noise=4.0)[0]
    pj, pt = params()
    phi = tck.segment_with_checkpoints(to_torch(img), pt, 8, tmp_path,
                                       every=3, **LAM)
    ref = segment_vector_fixed(to_torch(img), pt, iters=8, **LAM).phi
    assert_rel(phi, ref, 1e-10)
    assert torch.equal(phi >= 0, ref >= 0)
    jphi = jck.segment_with_checkpoints(jnp.asarray(img), pj, 8,
                                        tmp_path / "j", every=3, **LAM)
    assert_rel(phi, jphi, 1e-10)
    state = tck.load(tck.latest(tmp_path))
    assert state["c1"].shape == (3,) and int(state["step"]) == 8


@pytest.mark.parametrize("every", [4, 10])
def test_multiphase_chunked_equals_unchunked(tmp_path, every):
    img = mp_image()
    pj, pt = params(mu=0.003 * 255 ** 2)
    res = tck.segment_multiphase_with_checkpoints(to_torch(img), pt, 10,
                                                  tmp_path, every=every)
    ref = segment_multiphase(to_torch(img), pt, fixed=True, max_iter=10)
    assert torch.equal(res.labels, ref.labels)
    assert_rel(res.phis, ref.phis, 1e-10)
    jres = jck.segment_multiphase_with_checkpoints(
        jnp.asarray(img), pj, 10, tmp_path / "j", every=every)
    np.testing.assert_array_equal(to_np(res.labels),
                                  np.asarray(jres.labels))
    assert_rel(res.phis, jres.phis, 1e-10)


def test_layout_names_and_torn_file(tmp_path):
    img = gray()
    _, pt = params()
    tck.segment_with_checkpoints(to_torch(img), pt, 10, tmp_path, every=4)
    names = sorted(f.name for f in tmp_path.iterdir())
    assert names == ["ckpt_00000004.npz", "ckpt_00000008.npz",
                     "ckpt_00000010.npz"]
    (tmp_path / ".tmp_ckpt_00000099.npz").write_bytes(b"torn")
    (tmp_path / "ckpt_00000100.npz.partial").write_bytes(b"torn")
    assert tck.latest(tmp_path).name == "ckpt_00000010.npz"
    state = tck.load(tck.latest(tmp_path))
    assert set(state) == {"step", "phi", "c1", "c2"}
    assert int(state["step"]) == 10 and state["phi"].shape == (32, 64)
    assert tck.latest(tmp_path / "missing") is None


def test_save_load_extra_and_nan_means(tmp_path):
    phi = torch.randn(8, 16, dtype=torch.float64)
    p = tck.save(tmp_path, 7, phi, extra=torch.arange(3))
    assert p.name == "ckpt_00000007.npz"
    state = tck.load(p)
    np.testing.assert_array_equal(state["phi"], phi.numpy())
    assert np.isnan(state["c1"]) and np.isnan(state["c2"])
    np.testing.assert_array_equal(state["extra"], [0, 1, 2])
    jstate = jck.load(p)
    np.testing.assert_array_equal(jstate["phi"], state["phi"])


def test_resume_places_level_set_on_image_dtype(tmp_path):
    img = gray()
    _, pt = params()
    tck.segment_with_checkpoints(to_torch(img), pt, 4, tmp_path, every=4)
    u32 = to_torch(img, np.float32)
    phi = tck.segment_with_checkpoints(u32, pt, 4, tmp_path, every=4)
    assert phi.dtype == torch.float32 and phi.device == u32.device
    want = tck.load(tck.latest(tmp_path))["phi"].astype(np.float32)
    np.testing.assert_array_equal(to_np(phi), want)


@pytest.mark.parametrize("every,iters", [(0, 10), (-1, 10), (5, -1)])
def test_bad_interval_raises(tmp_path, every, iters):
    _, pt = params()
    u = to_torch(gray())
    with pytest.raises(ValueError, match="every > 0"):
        tck.segment_with_checkpoints(u, pt, iters, tmp_path, every=every)
    with pytest.raises(ValueError, match="every > 0"):
        tck.segment_multiphase_with_checkpoints(u, pt, iters, tmp_path,
                                                every=every)


def test_multiphase_reinit_alignment_raises(tmp_path):
    _, pt = params(reinit_every=30)
    with pytest.raises(ValueError, match="multiple of reinit_every"):
        tck.segment_multiphase_with_checkpoints(
            torch.zeros(32, 64, dtype=torch.float64), pt, 100, tmp_path,
            every=50)


def test_multiphase_rerun_after_completion(tmp_path):
    img = four_regions(32, 128, noise=4.0)[0]
    _, pt = params(mu=0.003 * 255 ** 2)
    u = to_torch(img)
    res = tck.segment_multiphase_with_checkpoints(u, pt, 6, tmp_path,
                                                  every=6)
    again = tck.segment_multiphase_with_checkpoints(u, pt, 6, tmp_path,
                                                    every=6)
    assert torch.equal(again.phis, res.phis) and again.iters == 0
    # the resident route's zero-iteration call (its plain versions)
    zero = segment_multiphase(u, pt, phis0=res.phis, use_pallas=True,
                              fixed=True, max_iter=0)
    assert torch.equal(zero.phis, res.phis) and zero.iters == 0


def test_scalar_rerun_after_completion(tmp_path):
    img = gray()
    _, pt = params()
    phi = tck.segment_with_checkpoints(to_torch(img), pt, 6, tmp_path,
                                       every=3)
    again = tck.segment_with_checkpoints(to_torch(img), pt, 6, tmp_path,
                                         every=3)
    assert torch.equal(again, phi)


def test_port_resumes_reference_checkpoint(tmp_path):
    img = gray()
    pj, pt = params()
    jck.segment_with_checkpoints(jnp.asarray(img), pj, 6, tmp_path,
                                 every=3)
    assert jck.latest(tmp_path).name == "ckpt_00000006.npz"
    phi = tck.segment_with_checkpoints(to_torch(img), pt, 10, tmp_path,
                                       every=2)
    assert tck.latest(tmp_path).name == "ckpt_00000010.npz"
    full = jck.segment_with_checkpoints(jnp.asarray(img), pj, 10,
                                        tmp_path / "full", every=2)
    assert_rel(phi, full, 1e-10)
    np.testing.assert_array_equal(to_np(phi) >= 0, np.asarray(full) >= 0)


def test_reference_resumes_port_checkpoint(tmp_path):
    img = gray()
    pj, pt = params()
    tck.segment_with_checkpoints(to_torch(img), pt, 6, tmp_path, every=3)
    jphi = jck.segment_with_checkpoints(jnp.asarray(img), pj, 10, tmp_path,
                                        every=2)
    full = tck.segment_with_checkpoints(to_torch(img), pt, 10,
                                        tmp_path / "full", every=2)
    assert_rel(full, jphi, 1e-10)
    np.testing.assert_array_equal(to_np(full) >= 0, np.asarray(jphi) >= 0)


def test_multiphase_cross_resume(tmp_path):
    img = mp_image()
    pj, pt = params(mu=0.003 * 255 ** 2)
    jck.segment_multiphase_with_checkpoints(jnp.asarray(img), pj, 4,
                                            tmp_path / "a", every=4)
    res = tck.segment_multiphase_with_checkpoints(to_torch(img), pt, 10,
                                                  tmp_path / "a", every=3)
    tck.segment_multiphase_with_checkpoints(to_torch(img), pt, 4,
                                            tmp_path / "b", every=4)
    jres = jck.segment_multiphase_with_checkpoints(
        jnp.asarray(img), pj, 10, tmp_path / "b", every=3)
    ref = segment_multiphase(to_torch(img), pt, fixed=True, max_iter=10)
    for got in (res.phis, jres.phis):
        assert_rel(got, ref.phis, 1e-10)
    assert torch.equal(res.labels, ref.labels)
    np.testing.assert_array_equal(np.asarray(jres.labels),
                                  to_np(ref.labels))
