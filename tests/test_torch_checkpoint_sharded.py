"""The port's sharded checkpoints on torch.distributed.checkpoint
(utils/checkpoint_sharded.py), on a 2x2 mesh of CPU devices, mirroring
``tests/test_sharded_trace_ckpt.py`` and ``tests/test_fault_recovery.py``.

- The roundtrip and resume: checkpoints at 5, 10 and 12 of 12 iterations;
  the chunked run against the unchunked one (the port's and the
  reference's, f64: the reference's own bar), a bit-exact restore, a rerun
  that resumes past the end; comm_k chunks and the plain kernel route.
- The means layout: scalar, (C,) and absent means round-trip through the
  slabs; the multiphase stack with its (None, 'x', 'y') layout; a layout
  that does not fit the shape raises.
- The raises: the comm_k and reinit alignment of ``every``.
- The legacy layout (scalar c1/c2, no length tags) restores; a real error
  on the current layout surfaces as itself, not as a legacy retry.
- A torn ``.tmp_ckpt_*`` directory is never picked; a subprocess killed
  with SIGKILL in the middle of its third save leaves one, and the resumed
  run equals the uninterrupted one bitwise.
"""

import os
import signal
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chan_vese_tpu.parallel import mesh as jmesh
from chan_vese_tpu.parallel import sharded as jsharded
from chan_vese_tpu_torch.parallel import (make_grid_mesh,
                                          segment_multiphase_sharded,
                                          segment_sharded)
from chan_vese_tpu_torch.utils import checkpoint_sharded as cks
from fixtures import four_regions, two_disks
from torch_port_helpers import assert_rel, params, to_np, to_torch

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_grid_mesh(2, 2, [CPU] * 4)


def image(seed=0):
    return two_disks(32, 64, noise=6.0, seed=seed)[0]


@pytest.mark.parametrize("comm_k,use_pallas", [(1, False), (1, True),
                                               (2, True)])
def test_roundtrip_and_resume(mesh, tmp_path, comm_k, use_pallas):
    u = to_torch(image())
    _, pt = params()
    every = 5 if comm_k == 1 else 4
    res = cks.segment_sharded_with_checkpoints(
        u, pt, mesh, 12, tmp_path, every=every, use_pallas=use_pallas,
        comm_k=comm_k)
    steps = list(range(every, 12, every)) + [12]
    assert sorted(d.name for d in tmp_path.iterdir()) == [
        f"ckpt_{s:08d}" for s in steps]
    ref = segment_sharded(u, pt, mesh, max_iter=12, fixed=True,
                          use_pallas=use_pallas, comm_k=comm_k)
    np.testing.assert_allclose(to_np(res.phi), to_np(ref.phi), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(res.mask, ref.mask)
    state = cks.restore_sharded(cks.latest_sharded(tmp_path), mesh,
                                u.shape, u.dtype)
    assert state["step"] == 12
    assert torch.equal(state["phi"], res.phi)
    assert state["phi"].device == mesh.devices[0]
    np.testing.assert_array_equal(state["c1"], to_np(res.c1))
    again = cks.segment_sharded_with_checkpoints(
        u, pt, mesh, 12, tmp_path, every=every, use_pallas=use_pallas,
        comm_k=comm_k)
    assert torch.equal(again.phi, res.phi)


def test_chunked_against_reference(mesh, tmp_path):
    img = image()
    pj, pt = params()
    res = cks.segment_sharded_with_checkpoints(to_torch(img), pt, mesh, 12,
                                               tmp_path, every=5)
    jres = jsharded.segment_sharded(jnp.asarray(img), pj,
                                    jmesh.make_grid_mesh(2, 2),
                                    max_iter=12, fixed=True)
    np.testing.assert_allclose(to_np(res.phi), np.asarray(jres.phi),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(to_np(res.mask), np.asarray(jres.mask))


@pytest.mark.parametrize("c,n", [(None, 0), (1.5, 1),
                                 (np.array([1.0, 2.0, 3.0]), 3)])
def test_means_slabs_roundtrip(mesh, tmp_path, c, n):
    phi = torch.randn(32, 64, dtype=torch.float64)
    cc = None if c is None else torch.as_tensor(c)
    cks.save_sharded(tmp_path, 3, phi, cc, cc)
    state = cks.restore_sharded(tmp_path / "ckpt_00000003", mesh,
                                (32, 64), torch.float64)
    slab, length = cks._pack_c(c)
    assert int(length) == n and slab.shape == (cks._C_SLOTS,)
    if c is None:
        assert state["c1"] is None and state["c2"] is None
    else:
        np.testing.assert_array_equal(state["c1"], c)
    assert torch.equal(state["phi"], phi)
    with pytest.raises(ValueError, match="slot count"):
        cks._pack_c(np.zeros(cks._C_SLOTS + 1))


def test_spec_checked_against_rank(mesh, tmp_path):
    phi = torch.zeros(2, 32, 64, dtype=torch.float64)
    cks.save_sharded(tmp_path, 1, phi)
    pth = cks.latest_sharded(tmp_path)
    with pytest.raises(ValueError, match="does not fit"):
        cks.restore_sharded(pth, mesh, (2, 32, 64), torch.float64)
    with pytest.raises(ValueError, match="does not fit"):
        cks.restore_sharded(pth, mesh, (32, 64), torch.float64,
                            spec=(None, "x", "y"))
    state = cks.restore_sharded(pth, mesh, (2, 32, 64), torch.float64,
                                spec=(None, "x", "y"))
    assert torch.equal(state["phi"], phi)


def test_multiphase_checkpoints(mesh, tmp_path):
    img = four_regions(32, 64, noise=4.0)[0]
    _, pt = params(mu=0.003 * 255 ** 2)
    u = to_torch(img)
    res = cks.segment_multiphase_sharded_with_checkpoints(
        u, pt, mesh, 10, tmp_path, every=4)
    ref = segment_multiphase_sharded(u, pt, mesh, fixed=True, max_iter=10)
    assert torch.equal(res.labels, ref.labels)
    assert_rel(res.phis, ref.phis, 1e-10)
    state = cks.restore_sharded(cks.latest_sharded(tmp_path), mesh,
                                (2, 32, 64), u.dtype, spec=(None, "x", "y"))
    assert state["step"] == 10 and torch.equal(state["phi"], res.phis)
    np.testing.assert_array_equal(state["c1"], to_np(res.cs))
    again = cks.segment_multiphase_sharded_with_checkpoints(
        u, pt, mesh, 10, tmp_path, every=4)
    assert torch.equal(again.phis, res.phis) and again.iters == 0


def test_alignment_raises(mesh, tmp_path):
    u = torch.zeros(32, 64, dtype=torch.float32)
    _, pt = params()
    with pytest.raises(ValueError, match="multiple of comm_k"):
        cks.segment_sharded_with_checkpoints(u, pt, mesh, 100, tmp_path,
                                             every=50, comm_k=8)
    _, pr = params(reinit_every=30)
    with pytest.raises(ValueError, match="multiple of reinit_every"):
        cks.segment_sharded_with_checkpoints(u, pr, mesh, 100, tmp_path,
                                             every=50)
    with pytest.raises(ValueError, match="multiple of reinit_every"):
        cks.segment_multiphase_sharded_with_checkpoints(
            u, pr, mesh, 100, tmp_path, every=50)
    with pytest.raises(ValueError, match="every > 0"):
        cks.segment_sharded_with_checkpoints(u, pt, mesh, 100, tmp_path,
                                             every=0)


def test_legacy_scalar_layout_restores(mesh, tmp_path):
    import torch.distributed.checkpoint as dcp

    phi = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (32, 64)))
    pth = tmp_path / "ck" / "ckpt_00000007"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dcp.save({"step": torch.tensor(7, dtype=torch.int32), "phi": phi,
                  "c1": torch.tensor(123.25, dtype=torch.float64),
                  "c2": torch.tensor(4.5, dtype=torch.float64)},
                 checkpoint_id=pth, no_dist=True)
    assert cks._is_legacy_layout(pth)
    state = cks.restore_sharded(pth, mesh, phi.shape, phi.dtype)
    assert state["step"] == 7
    assert float(state["c1"]) == 123.25 and float(state["c2"]) == 4.5
    assert torch.equal(state["phi"], phi)


def test_real_error_not_retried_as_legacy(mesh, tmp_path):
    phi = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (32, 64)))
    cks.save_sharded(tmp_path, 5, phi, 1.5, 2.5)
    pth = cks.latest_sharded(tmp_path)
    assert not cks._is_legacy_layout(pth)
    assert not cks._is_legacy_layout(tmp_path / "missing")
    with pytest.raises(ValueError, match="Size mismatch") as ei:
        cks.restore_sharded(pth, mesh, (16, 16), phi.dtype)
    assert "c1_len" not in str(ei.value)
    assert "phi" in str(ei.value)


def test_torn_directory_never_picked(mesh, tmp_path):
    phi = torch.zeros(32, 64, dtype=torch.float64)
    cks.save_sharded(tmp_path, 4, phi)
    torn = tmp_path / ".tmp_ckpt_00000008"
    torn.mkdir()
    (torn / ".metadata").write_bytes(b"partial")
    (tmp_path / "ckpt_00000009").write_bytes(b"not a directory")
    assert cks.latest_sharded(tmp_path).name == "ckpt_00000004"
    assert cks.latest_sharded(tmp_path / "missing") is None
    # a save of the torn step replaces the wreckage
    cks.save_sharded(tmp_path, 8, phi + 1)
    assert cks.latest_sharded(tmp_path).name == "ckpt_00000008"
    assert not torn.exists()
    # saving a step again replaces it
    cks.save_sharded(tmp_path, 8, phi + 2)
    state = cks.restore_sharded(tmp_path / "ckpt_00000008", mesh, (32, 64),
                                torch.float64)
    assert torch.equal(state["phi"], phi + 2)


_CHILD = r"""
import os, signal, sys
from pathlib import Path
import torch
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
import torch.distributed.checkpoint as dcp
from chan_vese_tpu_torch.params import CVParams
from chan_vese_tpu_torch.parallel import make_grid_mesh
from chan_vese_tpu_torch.utils import checkpoint_sharded as cks
from fixtures import two_disks

mesh = make_grid_mesh(2, 2, [torch.device("cpu")] * 4)
u0 = torch.from_numpy(two_disks(32, 64, noise=4.0)[0])
real_save = dcp.save
calls = {{"n": 0}}

def save_and_die_on_third(state, *, checkpoint_id, **kw):
    calls["n"] += 1
    if calls["n"] == 3:
        # die in the middle of the save: a partial shard file in the
        # temporary directory, then SIGKILL
        tmp = Path(checkpoint_id)
        tmp.mkdir(parents=True, exist_ok=True)
        (tmp / "__0_0.distcp").write_bytes(b"partial write")
        os.kill(os.getpid(), signal.SIGKILL)
    return real_save(state, checkpoint_id=checkpoint_id, **kw)

dcp.save = save_and_die_on_third
cks.segment_sharded_with_checkpoints(u0, CVParams(), mesh, 80, {ckdir!r},
                                     every=20, use_pallas=False)
raise SystemExit("unreachable: the injected fault did not fire")
"""


def test_sigkill_mid_save_resumes_bit_exact(mesh, tmp_path):
    repo = Path(__file__).resolve().parents[1]
    ckdir = tmp_path / "ck"
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(repo) + os.pathsep + str(repo / "tests")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    code = _CHILD.format(tests=str(repo / "tests"), ckdir=str(ckdir))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=str(repo), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == -signal.SIGKILL, (proc.returncode,
                                                proc.stderr[-2000:])
    names = sorted(f.name for f in ckdir.iterdir())
    assert names == [".tmp_ckpt_00000060", "ckpt_00000020",
                     "ckpt_00000040"], names
    assert cks.latest_sharded(ckdir).name == "ckpt_00000040"

    u0 = torch.from_numpy(two_disks(32, 64, noise=4.0)[0])
    _, pt = params()
    res = cks.segment_sharded_with_checkpoints(u0, pt, mesh, 80, ckdir,
                                               every=20, use_pallas=False)
    names = {f.name for f in ckdir.iterdir()}
    assert {"ckpt_00000060", "ckpt_00000080"} <= names, names
    assert ".tmp_ckpt_00000060" not in names
    ref = cks.segment_sharded_with_checkpoints(
        u0, pt, mesh, 80, tmp_path / "ref", every=20, use_pallas=False)
    assert torch.equal(res.phi, ref.phi)
