"""Device meshes. Counterpart of ``chan_vese_tpu/parallel/mesh.py``
(``make_data_mesh``): a 1-D 'data' mesh over which a frame stack is split,
every frame whole on one device, so no halos and no collectives.

A :class:`Mesh` is a tuple of ``torch.device`` along the one axis 'data';
there is no runtime object behind it. Its devices default to every CUDA
device the process sees; the tests pass CPU devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """Devices along one axis, 'data'."""
    devices: Tuple[torch.device, ...]
    axis_names: ClassVar[Tuple[str, ...]] = ("data",)

    @property
    def shape(self):
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return {"data": len(self.devices)}


def make_data_mesh(n: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> Mesh:
    """1-D 'data' mesh over the first ``n`` of ``devices`` (default: all
    of them; the devices default to every CUDA device). Raises where
    there is no device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n or len(devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"a data mesh of {n} needs {n} devices, have "
                         f"{len(devices)}")
    return Mesh(tuple(devices[:n]))
