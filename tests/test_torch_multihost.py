"""The port's multi-process entry (parallel/multihost.py) over
torch.distributed.

- In one process every call is a no-op: ``initialize`` without a process
  count (or with 1) joins nothing, ``is_coordinator`` is True and
  ``global_array`` is the identity (on the mesh's first device); a
  multi-process call without an address raises.
- Two gloo ranks on localhost (subprocesses, each with a timeout):
  ``initialize``, ``is_coordinator``, ``global_array`` (the blocks in rank
  order) and one ``save_sharded``/``restore_sharded`` under the group, the
  coordinator renaming the temporary directory.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from chan_vese_tpu_torch.parallel import make_grid_mesh, multihost

CPU = torch.device("cpu")


def test_single_process_no_ops():
    multihost.initialize()
    multihost.initialize("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()
    assert multihost.is_coordinator()
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(multihost.global_array(x), x)
    mesh = make_grid_mesh(1, 1, [CPU])
    assert torch.equal(multihost.global_array(x, mesh), x)


def test_multi_process_needs_address():
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(None, 2, 0)
    with pytest.raises(ValueError, match="process_id"):
        multihost.initialize("127.0.0.1:1", 2, None)


_RANK = r"""
import sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from chan_vese_tpu_torch.parallel import make_grid_mesh, multihost
from chan_vese_tpu_torch.utils import checkpoint_sharded as cks

rank, world, addr, ckdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
multihost.initialize(addr, world, rank)
multihost.initialize(addr, world, rank)  # already initialized: a no-op
dist = torch.distributed
assert dist.is_initialized() and dist.get_backend() == "gloo"
assert dist.get_rank() == rank and dist.get_world_size() == world
assert multihost.is_coordinator() == (rank == 0)
block = torch.full((2, 3), float(rank))
got = multihost.global_array(block)
want = torch.cat([torch.full((2, 3), float(r)) for r in range(world)])
assert torch.equal(got, want), got
mesh = make_grid_mesh(1, 1, [torch.device("cpu")])
phi = torch.arange(32 * 64, dtype=torch.float64).reshape(32, 64) / 7.0
path = cks.save_sharded(ckdir, 9, phi, 1.25, 2.5)
assert path.name == "ckpt_00000009" and path.is_dir()
assert not (Path(ckdir) / ".tmp_ckpt_00000009").exists()
state = cks.restore_sharded(path, mesh, (32, 64), torch.float64)
assert state["step"] == 9 and torch.equal(state["phi"], phi)
assert float(state["c1"]) == 1.25 and float(state["c2"]) == 2.5
dist.barrier()
dist.destroy_process_group()
print(f"rank {rank} OK")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks(tmp_path):
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), "2", addr,
         str(tmp_path / "ck")], env=env, cwd=str(repo),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, err[-3000:])
        assert f"rank {r} OK" in out
    assert sorted(f.name for f in (tmp_path / "ck").iterdir()) == [
        "ckpt_00000009"]
