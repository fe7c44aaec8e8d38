"""Device meshes. Counterpart of ``chan_vese_tpu/parallel/mesh.py``: the 1-D
'data' mesh over which a frame stack is split (every frame whole on one
device), the 2-D ('x', 'y') grid over which one image is split into
shards, and the ('data', 'x', 'y') hybrid.

A :class:`Mesh` is an n-d grid of ``torch.device`` with named axes; there
is no runtime object behind it. One process drives every device of it (a
single controller, as JAX's ``shard_map`` on one host), so a device may
repeat: four shards of a 2x2 grid may all live on ``cuda:0``. Devices
default to every CUDA device the process sees; the tests pass CPU devices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """Devices on a grid: ``devices`` row-major (the last axis fastest),
    ``dims`` the size of each axis in ``axis_names``."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)
    dims: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.dims is None:
            object.__setattr__(self, "dims", (len(self.devices),))
        n = 1
        for d in self.dims:
            n *= d
        if len(self.dims) != len(self.axis_names) or n != len(self.devices):
            raise ValueError(f"{len(self.devices)} devices do not fill axes "
                             f"{self.axis_names} of sizes {self.dims}")

    @property
    def shape(self):
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    def device(self, *index) -> torch.device:
        """The device at grid position ``index`` (one int per axis)."""
        flat = 0
        for i, d in zip(index, self.dims):
            flat = flat * d + i
        return self.devices[flat]


class Sharding(NamedTuple):
    """How an array lies on a mesh: the mesh and the mesh axes that split
    its leading dimensions, one per dimension (the counterpart of a
    ``NamedSharding`` with that ``PartitionSpec``)."""
    mesh: Mesh
    axes: Tuple[str, ...]


def _devices(devices):
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_data_mesh(n: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> Mesh:
    """1-D 'data' mesh over the first ``n`` of ``devices`` (default: all
    of them; the devices default to every CUDA device). Raises where
    there is no device."""
    devices = _devices(devices)
    n = n or len(devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"a data mesh of {n} needs {n} devices, have "
                         f"{len(devices)}")
    return Mesh(tuple(devices[:n]))


def make_grid_mesh(nx: int, ny: int,
                   devices: Optional[Sequence] = None) -> Mesh:
    """2-D ('x', 'y') mesh for the spatial sharding of one image: shard
    (ix, iy) on the device at ix * ny + iy of ``devices`` (default: every
    CUDA device). A device may repeat in the list. Raises on too few
    devices, as the reference does."""
    devices = _devices(devices)
    if nx * ny > len(devices):
        raise ValueError(f"mesh {nx}x{ny} needs {nx * ny} devices, "
                         f"have {len(devices)}")
    return Mesh(tuple(devices[:nx * ny]), ("x", "y"), (nx, ny))


def make_hybrid_mesh(ndata: int, nx: int, ny: int,
                     devices: Optional[Sequence] = None) -> Mesh:
    """('data', 'x', 'y') mesh: batches of spatially sharded images."""
    devices = _devices(devices)
    need = ndata * nx * ny
    if need > len(devices):
        raise ValueError(f"mesh needs {need} devices, have {len(devices)}")
    return Mesh(tuple(devices[:need]), ("data", "x", "y"), (ndata, nx, ny))


def grid_sharding(mesh: Mesh) -> Sharding:
    """Rows over 'x', columns over 'y': the layout of a sharded image."""
    return Sharding(mesh, ("x", "y"))


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (frame) axis over 'data': the layout of a stack."""
    return Sharding(mesh, ("data",))


def shard_grid(x, sharding: Sharding):
    """Split an (H, W, ...) array into the nx x ny grid of blocks that
    ``sharding`` (:func:`grid_sharding`) lays on its mesh: a list of rows
    of (H/nx, W/ny, ...) blocks, block (ix, iy) on that mesh position's
    device. A shape the grid does not divide raises."""
    mesh = sharding.mesh
    nx, ny = (mesh.shape[a] for a in sharding.axes)
    H, W = x.shape[:2]
    if H % nx or W % ny:
        raise ValueError(f"image {tuple(x.shape)} not divisible by mesh "
                         f"({nx}, {ny})")
    h, w = H // nx, W // ny
    return [[x[ix * h:(ix + 1) * h, iy * w:(iy + 1) * w]
             .to(mesh.device(ix, iy)).contiguous() for iy in range(ny)]
            for ix in range(nx)]


def gather_grid(blocks, mesh: Mesh):
    """The inverse of :func:`shard_grid`: the blocks' image, assembled on
    the mesh's first device."""
    first = mesh.devices[0]
    return torch.cat([torch.cat([b.to(first) for b in row], dim=1)
                      for row in blocks], dim=0)
