"""Data-parallel segmentation of a frame stack over a data mesh.

Counterpart of ``chan_vese_tpu/parallel/data_parallel.py``. The stack is
split into one contiguous chunk of frames per device of the mesh's 'data'
axis; each device segments its frames on its own (no halos, no
collectives), and the results are gathered in frame order onto the
mesh's first device. That gather is an intended difference: the
reference returns one array sharded over the mesh. On a one-device mesh
it is the identity.

Routing is the reference's: ``iters=None`` runs
:func:`..models.batched.segment_batch` (tolerance mode); a fixed count
runs :func:`..models.batched.segment_stack_fixed` without the kernels,
else :func:`..models.resident.segment_stack_resident_fixed` per shard,
which runs K8/K7 batch inside the resident envelope and K1's batch mode
(:func:`..models.batched.segment_stack_fused_fixed`) off it.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from .. import spans
from ..models.batched import segment_batch, segment_stack_fixed
from ..models.resident import segment_stack_resident_fixed
from ..models.scalar import SegResult
from ..ops import fused_kernel
from ..params import CVParams
from .mesh import Mesh


def shard_stack(u0, mesh: Mesh):
    """Split an (N, H, W[, C]) stack over the mesh's 'data' axis: one
    chunk of N / n frames per device, on that device. A batch the axis
    does not divide raises."""
    n = u0.shape[0]
    nd = mesh.shape["data"]
    if n % nd:
        raise ValueError(f"batch {n} not divisible by data axis {nd}")
    per = n // nd
    return [u0[i * per:(i + 1) * per].to(dev)
            for i, dev in enumerate(mesh.devices)]


def _on(dev):
    """The device context of a shard's work (kernel launches go to the
    current CUDA device)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def segment_stack_sharded(u0, p: CVParams = CVParams(), mesh: Mesh = None,
                          iters: Optional[int] = None,
                          use_pallas: Optional[bool] = None):
    """Segment a frame stack data-parallel across the mesh.

    ``iters=None``: tolerance mode, a SegResult with per-frame fields.
    Otherwise ``iters`` fixed iterations, returning (phi, mask).
    ``use_pallas=None`` takes the kernels when the mesh's devices are CUDA
    devices, the stack is (N, H, W) and the fused kernel takes (H, W)
    (``fused_kernel.supports``); ``use_pallas=True`` on CPU devices runs
    the kernels' plain versions through the same drivers (the counterpart
    of the reference's ``interpret=True``). Results are gathered onto the
    mesh's first device.
    """
    if mesh is None:
        raise ValueError("segment_stack_sharded needs a mesh "
                         "(parallel.mesh.make_data_mesh)")
    with spans.span("cv.drv.setup"):
        shards = shard_stack(u0, mesh)
        if use_pallas is None:
            use_pallas = (all(d.type == "cuda" for d in mesh.devices)
                          and u0.ndim == 3
                          and fused_kernel.supports(*u0.shape[1:3]))
        # the reference's _build_fused_stack: the kernel route's
        # per-device work is the resident stack driver (K1 batch off its
        # envelope)
        run = (segment_stack_resident_fixed if use_pallas
               else segment_stack_fixed)
    first = mesh.devices[0]
    if iters is None:
        runs = []
        for dev, shard in zip(mesh.devices, shards):
            with _on(dev):
                runs.append(segment_batch(shard, p))
        return SegResult(*(torch.cat([getattr(r, f).to(first) for r in runs])
                           for f in SegResult._fields))
    outs = []
    for dev, shard in zip(mesh.devices, shards):
        with spans.span("cv.drv.step"), _on(dev):
            outs.append(run(shard, p, iters=iters))
    with spans.span("cv.drv.finish"):
        phis = torch.cat([phi.to(first) for phi, _ in outs])
        return phis, phis >= 0
