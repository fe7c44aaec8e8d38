"""Sharded checkpoint/resume on ``torch.distributed.checkpoint`` (DCP).

Counterpart of ``chan_vese_tpu/utils/checkpoint_sharded.py`` with its
state layout: ``step``, ``phi``, and the means ``c1``/``c2`` as fixed
``_C_SLOTS``-long f64 slabs with ``c1_len``/``c2_len`` tags, so a vector
run's (C,) means round-trip through the same layout. A checkpoint is the
directory ``ckpt_<step:08d>``. DCP writes into the directory it is given,
so a save goes into the dot-prefixed ``.tmp_ckpt_<step:08d>`` and is
renamed only once complete: a torn save never matches ``ckpt_<8 digits>``
and :func:`latest_sharded` never picks it.

The sharded drivers of the port gather their results onto the mesh's
first device (one process drives every shard), so ``phi`` is saved whole
and :func:`restore_sharded` returns it on ``mesh``'s first device, at the
requested shape and dtype; ``segment_sharded(phi0=...)`` scatters it
again. Under a ``torch.distributed`` process group (``parallel.
multihost.initialize``) the save and the load are DCP's collective ones
and the coordinator renames; without one they run in this process alone.
"""

from __future__ import annotations

import contextlib
import re
import shutil
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..parallel.multihost import is_coordinator
from .image_io import host_array

_CKPT_RE = re.compile(r"^ckpt_(\d{8})$")

_C_SLOTS = 8  # fixed on-disk means slot count (supports up to 8 channels)

# the layouts restore_sharded accepts: a level set, a stack of them
_SPECS = {2: ("x", "y"), 3: (None, "x", "y")}


def _dcp():
    import torch.distributed.checkpoint as dcp

    return dcp


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


@contextlib.contextmanager
def _dcp_call():
    """Yields ``no_dist`` for a DCP save or load (True without a process
    group, DCP's notice that it then runs in one process silenced). DCP
    wraps a failure in a ``CheckpointException``, a ``BaseException``
    holding each rank's error: the first rank's error is raised as
    itself, so a shape mismatch is a ``ValueError`` as it is in DCP."""
    from torch.distributed.checkpoint.api import CheckpointException

    no_dist = not _distributed()
    with warnings.catch_warnings():
        if no_dist:
            warnings.filterwarnings(
                "ignore", message="torch.distributed is disabled")
        try:
            yield no_dist
        except CheckpointException as e:
            if not e.failures:
                raise
            raise next(iter(e.failures.values()))[0] from e


def _barrier():
    if _distributed():
        import torch.distributed as dist

        dist.barrier()


def _pack_c(c):
    """Pack scalar / (C,) / None means into a fixed (_C_SLOTS,) f64 slab
    plus a length tag, so restore targets are shape-independent."""
    slab = np.full((_C_SLOTS,), np.nan, np.float64)
    if c is None:
        return slab, np.int32(0)
    v = np.atleast_1d(host_array(c).astype(np.float64)).ravel()
    if v.size > _C_SLOTS:
        raise ValueError(f"means with {v.size} channels exceed the "
                         f"checkpoint slot count {_C_SLOTS}")
    slab[:v.size] = v
    return slab, np.int32(v.size)


def _unpack_c(slab, n):
    n = int(n)
    slab = host_array(slab)
    if n == 0:
        return None
    if n == 1:
        return np.float64(slab[0])
    return np.asarray(slab[:n], np.float64)


def save_sharded(path_dir, step: int, phi, c1=None, c2=None) -> Path:
    """Write the checkpoint directory ckpt_<step> (replacing one of the
    same step), through a temporary directory renamed when complete."""
    d = Path(path_dir).resolve()
    p = d / f"ckpt_{step:08d}"
    tmp = d / f".tmp_ckpt_{step:08d}"
    if is_coordinator():
        d.mkdir(parents=True, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
    _barrier()
    c1s, n1 = _pack_c(c1)
    c2s, n2 = _pack_c(c2)
    state = {
        "step": torch.tensor(step, dtype=torch.int32),
        "phi": phi.detach().contiguous(),
        "c1": torch.from_numpy(c1s), "c1_len": torch.tensor(n1),
        "c2": torch.from_numpy(c2s), "c2_len": torch.tensor(n2),
    }
    with _dcp_call() as no_dist:
        _dcp().save(state, checkpoint_id=tmp, no_dist=no_dist)
    if is_coordinator():
        if p.exists():
            shutil.rmtree(p)
        tmp.rename(p)
    _barrier()
    return p


def latest_sharded(path_dir) -> Optional[Path]:
    d = Path(path_dir).resolve()
    if not d.is_dir():
        return None
    cands = sorted(f for f in d.iterdir()
                   if f.is_dir() and _CKPT_RE.match(f.name))
    return cands[-1] if cands else None


def _is_legacy_layout(path) -> bool:
    """True iff the checkpoint predates the slab + length-tag means layout
    (scalar f64 c1/c2, no *_len keys). Detected from the saved metadata
    rather than by retrying a failed restore, so genuine restore errors
    (shape mismatch, corruption, I/O) surface as themselves."""
    try:
        meta = _dcp().FileSystemReader(str(Path(path).resolve())
                                       ).read_metadata()
    except Exception:
        return False  # let the real restore produce the real error
    return "c1_len" not in meta.state_dict_metadata


def restore_sharded(path, mesh, shape, dtype, spec=None):
    """Restore {step, phi, c1, c2}, phi on ``mesh``'s first device.

    ``spec`` names the layout's mesh axes, one per dimension of ``shape``:
    ('x', 'y') (the default) for an (H, W) level set, (None, 'x', 'y')
    for the (M, H, W) stack of the multiphase drivers.
    """
    shape = tuple(int(s) for s in shape)
    if spec is None:
        spec = _SPECS[2]
    spec = tuple(spec)
    if _SPECS.get(len(shape)) != spec:
        raise ValueError(f"layout {spec} does not fit a level set of shape "
                         f"{shape} (expected ('x', 'y') for (H, W) or "
                         f"(None, 'x', 'y') for (M, H, W))")
    path = Path(path).resolve()
    state = {"step": torch.zeros((), dtype=torch.int32),
             "phi": torch.empty(shape, dtype=dtype)}
    legacy = _is_legacy_layout(path)
    if legacy:
        state.update(c1=torch.zeros((), dtype=torch.float64),
                     c2=torch.zeros((), dtype=torch.float64))
    else:
        state.update(c1=torch.zeros(_C_SLOTS, dtype=torch.float64),
                     c2=torch.zeros(_C_SLOTS, dtype=torch.float64),
                     c1_len=torch.zeros((), dtype=torch.int32),
                     c2_len=torch.zeros((), dtype=torch.int32))
    with _dcp_call() as no_dist:
        _dcp().load(state, checkpoint_id=path, no_dist=no_dist)
    out = {"step": int(state["step"]),
           "phi": state["phi"].to(mesh.devices[0])}
    if legacy:
        out.update(c1=np.float64(state["c1"]), c2=np.float64(state["c2"]))
    else:
        out.update(c1=_unpack_c(state["c1"], state["c1_len"]),
                   c2=_unpack_c(state["c2"], state["c2_len"]))
    return out


def _check_intervals(every: int, iters: int, p, comm_k: int = 1):
    if every <= 0 or iters < 0:
        raise ValueError(f"need every > 0 and iters >= 0 "
                         f"(got every={every}, iters={iters})")
    # chunk boundaries restart the in-run iteration counter, so any
    # cadence keyed on it (comm_k frozen-means chunks, reinit) must
    # divide the checkpoint interval or the chunked trajectory diverges
    # from an unchunked run
    if comm_k > 1 and every % comm_k:
        raise ValueError(f"every={every} must be a multiple of "
                         f"comm_k={comm_k} to keep the frozen-means "
                         f"chunk boundaries identical to an unchunked run")
    if p.reinit_every and every % p.reinit_every:
        raise ValueError(f"every={every} must be a multiple of "
                         f"reinit_every={p.reinit_every} to keep the "
                         f"redistancing cadence identical to an "
                         f"unchunked run")


def segment_sharded_with_checkpoints(u0, p, mesh, iters: int, ckpt_dir,
                                     every: int = 50, phi0=None,
                                     resume: bool = True,
                                     use_pallas=None, halo="ppermute",
                                     comm_k: int = 1, packed=None):
    """Fixed-iteration sharded segmentation (``segment_sharded``, whose
    routes are the shard kernels on CUDA devices: K1's shard mode at
    comm_k 1, K2's above it, K3's with ``packed=True``, K14 with
    ``halo='rdma'``), checkpointing every ``every`` iterations; resumes
    from the newest checkpoint. Returns the final SegResult; a resume past
    ``iters`` runs zero iterations from the restored level set.
    ``packed`` is passed to ``segment_sharded`` (the port's addition to
    the reference's keywords).
    """
    from ..parallel.sharded import segment_sharded

    _check_intervals(every, iters, p, comm_k)
    start, phi = 0, phi0
    if resume:
        ck = latest_sharded(ckpt_dir)
        if ck is not None:
            state = restore_sharded(ck, mesh, u0.shape[:2], u0.dtype)
            start, phi = state["step"], state["phi"]

    kw = dict(fixed=True, use_pallas=use_pallas, halo=halo, comm_k=comm_k,
              packed=packed)
    n = start
    res = None
    while n < iters:
        chunk = min(every, iters - n)
        res = segment_sharded(u0, p, mesh, phi0=phi, max_iter=chunk, **kw)
        phi = res.phi
        n += chunk
        save_sharded(ckpt_dir, n, phi, res.c1, res.c2)
    if res is None:  # resumed past the requested iteration count
        res = segment_sharded(u0, p, mesh, phi0=phi, max_iter=0, **kw)
    return res


def segment_multiphase_sharded_with_checkpoints(u0, p, mesh, iters: int,
                                                ckpt_dir, every: int = 50,
                                                m_sets: int = 2, phis0=None,
                                                resume: bool = True,
                                                use_pallas=None,
                                                halo="ppermute"):
    """Fixed-iteration sharded multiphase segmentation
    (``segment_multiphase_sharded``: K9's shard mode for M = 2 gray on
    CUDA devices) with checkpoints of the stacked (M, H, W) level sets
    every ``every`` iterations; resumes from the newest checkpoint.
    Returns the final MultiphaseResult.
    """
    from ..parallel.sharded import segment_multiphase_sharded

    _check_intervals(every, iters, p)
    start, phis = 0, phis0
    if resume:
        ck = latest_sharded(ckpt_dir)
        if ck is not None:
            state = restore_sharded(ck, mesh,
                                    (m_sets,) + tuple(u0.shape[:2]),
                                    u0.dtype, spec=_SPECS[3])
            start, phis = state["step"], state["phi"]

    kw = dict(m_sets=m_sets, fixed=True, use_pallas=use_pallas, halo=halo)
    n = start
    res = None
    while n < iters:
        chunk = min(every, iters - n)
        res = segment_multiphase_sharded(u0, p, mesh, phis0=phis,
                                         max_iter=chunk, **kw)
        phis = res.phis
        n += chunk
        cs = host_array(res.cs)
        save_sharded(ckpt_dir, n, phis,
                     cs if cs.ndim == 1 and cs.size <= _C_SLOTS else None)
    if res is None:  # resumed past the requested iteration count
        res = segment_multiphase_sharded(u0, p, mesh, phis0=phis,
                                         max_iter=0, **kw)
    return res
