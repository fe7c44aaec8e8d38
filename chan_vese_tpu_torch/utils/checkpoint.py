"""Iteration checkpoint/resume as plain ``.npz`` files.

Counterpart of ``chan_vese_tpu/utils/checkpoint.py``, with its layout,
names and validation: a checkpoint is ``ckpt_<step:08d>.npz`` holding
``step``, ``phi`` and the means ``c1``/``c2`` (NaN where absent), written
under a dot-prefixed temporary name and renamed when complete, so that a
torn write never matches ``ckpt_*.npz``. The format is plain numpy: the
port resumes from a checkpoint the JAX package wrote, and the reverse.

The level set is copied to the host once a checkpoint; a restored one
is placed on the image's device with the image's dtype.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .image_io import host_array

_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.npz$")


def save(path_dir, step: int, phi, c1=None, c2=None, **extra) -> Path:
    d = Path(path_dir)
    d.mkdir(parents=True, exist_ok=True)
    p = d / f"ckpt_{step:08d}.npz"
    # dot-prefixed temp name: cannot match the ckpt_*.npz pattern, so a
    # torn write is never picked up by latest()
    tmp = d / f".tmp_ckpt_{step:08d}.npz"
    np.savez(tmp, step=step, phi=host_array(phi),
             c1=host_array(c1 if c1 is not None else np.nan),
             c2=host_array(c2 if c2 is not None else np.nan),
             **{k: host_array(v) for k, v in extra.items()})
    tmp.rename(p)
    return p


def latest(path_dir) -> Optional[Path]:
    d = Path(path_dir)
    if not d.is_dir():
        return None
    cands = sorted(f for f in d.iterdir() if _CKPT_RE.match(f.name))
    return cands[-1] if cands else None


def load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _check_every(every: int, iters: int):
    if every <= 0 or iters < 0:
        raise ValueError(f"need every > 0 and iters >= 0 "
                         f"(got every={every}, iters={iters})")


def _restore(ckpt_dir, u0):
    """(step, level set on u0's device in u0's dtype) of the newest
    checkpoint, or (0, None)."""
    ck = latest(ckpt_dir)
    if ck is None:
        return 0, None
    state = load(ck)
    phi = torch.from_numpy(np.ascontiguousarray(state["phi"]))
    return int(state["step"]), phi.to(device=u0.device, dtype=u0.dtype)


def segment_with_checkpoints(u0, p, iters: int, ckpt_dir, every: int = 50,
                             phi0=None, resume: bool = True,
                             lambda1=None, lambda2=None):
    """Fixed-iteration segmentation checkpointing every ``every`` iters.

    Resumes from the newest checkpoint in ckpt_dir when ``resume``. Runs
    ``every``-iteration chunks of the plain per-iteration driver
    (``segment_fixed``, or ``segment_vector_fixed`` for an (H, W, C) image,
    where per-channel lambda tuples apply) between the writes. Returns the
    final level set.
    """
    from ..models.scalar import segment_fixed
    from ..models.vector import segment_vector_fixed
    from .init_phi import init_phi

    _check_every(every, iters)
    start, phi = 0, phi0
    if resume:
        start, restored = _restore(ckpt_dir, u0)
        if restored is not None:
            phi = restored
    if phi is None:
        phi = init_phi(u0.shape[:2], p.init, u0.dtype, device=u0.device)

    n = start
    while n < iters:
        chunk = min(every, iters - n)
        # start_iter keeps the global iteration counter (and hence the
        # reinit cadence) identical to an unchunked run
        if u0.ndim == 3:
            tr = segment_vector_fixed(u0, p, iters=chunk, phi0=phi,
                                      lambda1=lambda1, lambda2=lambda2,
                                      start_iter=n)
        else:
            tr = segment_fixed(u0, p, iters=chunk, phi0=phi, start_iter=n)
        phi = tr.phi
        n += chunk
        save(ckpt_dir, n, phi, tr.c1[-1], tr.c2[-1])
    return phi


def segment_multiphase_with_checkpoints(u0, p, iters: int, ckpt_dir,
                                        every: int = 50, m_sets: int = 2,
                                        phis0=None, resume: bool = True):
    """Multiphase counterpart: checkpoints the (M, H, W) level-set stack
    every ``every`` iterations of ``segment_multiphase(fixed=True)`` (its
    auto route: K9/K10 for M = 2 on a gray image on a CUDA device);
    resumes from the newest checkpoint. Returns the MultiphaseResult.

    With a reinit cadence, ``every`` must be a multiple of
    p.reinit_every: segment_multiphase's iteration counter restarts per
    chunk, so only aligned chunk boundaries keep the redistancing
    cadence identical to an unchunked run.
    """
    from ..models.multiphase import init_multiphase, segment_multiphase

    _check_every(every, iters)
    if p.reinit_every and every % p.reinit_every:
        raise ValueError(
            f"every={every} must be a multiple of reinit_every="
            f"{p.reinit_every} to keep the redistancing cadence identical "
            f"to an unchunked run")
    start, phis = 0, phis0
    if resume:
        start, restored = _restore(ckpt_dir, u0)
        if restored is not None:
            phis = restored
    if phis is None:
        phis = init_multiphase(u0.shape[:2], m_sets, dtype=u0.dtype,
                               device=u0.device)

    n = start
    res = None
    while n < iters:
        chunk = min(every, iters - n)
        res = segment_multiphase(u0, p, m_sets=m_sets, phis0=phis,
                                 fixed=True, max_iter=chunk)
        phis = res.phis
        n += chunk
        save(ckpt_dir, n, phis)
    if res is None:  # resumed past the requested iteration count
        res = segment_multiphase(u0, p, m_sets=m_sets, phis0=phis,
                                 fixed=True, max_iter=0)
    return res
