"""Distribution layer of the port: device meshes, the halo exchange (the
plain one in ``halo``, K14's ring shifts in ``halo_rdma``), the spatially
sharded two-phase and multiphase solvers (``sharded``), the sharded
morphological solvers (``sharded_morph``) and data-parallel frame stacks.
Counterpart of ``chan_vese_tpu/parallel``. One process drives every device
of a mesh; ``multihost`` joins several processes into a
``torch.distributed`` group."""

from .data_parallel import segment_stack_sharded, shard_stack
from .halo import exchange_halo2d, exchange_halo2d_batched
from .halo_rdma import exchange_halo2d_rdma
from .mesh import (Mesh, Sharding, batch_sharding, gather_grid,
                   grid_sharding, make_data_mesh, make_grid_mesh,
                   make_hybrid_mesh, shard_grid)
from .sharded import (MultiphaseShardedTrace, ShardedTrace,
                      segment_multiphase_sharded,
                      segment_multiphase_sharded_fixed_trace,
                      segment_sharded, segment_sharded_fixed_trace)
from . import multihost

__all__ = [
    "Mesh", "Sharding", "make_grid_mesh", "make_data_mesh",
    "make_hybrid_mesh", "grid_sharding", "batch_sharding", "shard_grid",
    "gather_grid", "exchange_halo2d", "exchange_halo2d_batched",
    "exchange_halo2d_rdma",
    "segment_sharded", "segment_sharded_fixed_trace", "ShardedTrace",
    "segment_multiphase_sharded", "segment_multiphase_sharded_fixed_trace",
    "MultiphaseShardedTrace",
    "segment_stack_sharded", "shard_stack", "multihost",
]
