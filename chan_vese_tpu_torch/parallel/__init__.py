"""Distribution layer of the port: the data mesh and data-parallel frame
stacks. Counterpart of ``chan_vese_tpu/parallel`` (the grid and hybrid
meshes, the shardings and the sharded solvers are ROADMAP M13a)."""

from .data_parallel import segment_stack_sharded, shard_stack
from .mesh import Mesh, make_data_mesh

__all__ = ["Mesh", "make_data_mesh", "segment_stack_sharded", "shard_stack"]
