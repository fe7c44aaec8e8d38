"""Multi-process entry over ``torch.distributed``.

Counterpart of ``chan_vese_tpu/parallel/multihost.py``. Each process of a
multi-host run calls :func:`initialize` with the coordinator's
``host:port``, the number of processes and its own index (nothing on the
machine tells a program of a cluster, so all three are given); after it,
:func:`global_array` assembles a tensor from every process's block and
``utils.checkpoint_sharded`` saves and loads collectively. One process
still drives every device of its own meshes (``parallel.mesh``).

Single-process runs are no-ops throughout, so library code can call these
unconditionally.
"""

from __future__ import annotations

from typing import Optional

import torch


def _dist():
    import torch.distributed as dist

    return dist


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group (``nccl`` where CUDA is present, ``gloo``
    otherwise) at ``tcp://<coordinator_address>``. Does nothing for a
    single-process run (``num_processes`` None or 1) or when a group is
    already initialized; any other error is raised."""
    if _initialized() or not num_processes or num_processes == 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address "
                         "('host:port') and process_id")
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    _dist().init_process_group("nccl" if cuda else "gloo",
                               init_method=f"tcp://{coordinator_address}",
                               world_size=num_processes, rank=process_id)


def global_array(local_data, mesh=None):
    """The global tensor of every process's block: the blocks, equal in
    shape, concatenated along the leading axis in process order, on
    ``mesh``'s first device (else ``local_data``'s device). The identity in
    a single process."""
    target = mesh.devices[0] if mesh is not None else local_data.device
    if not _initialized():
        return local_data.to(target)
    dist = _dist()
    comm = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
    block = local_data.to(comm).contiguous()
    parts = [torch.empty_like(block) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, block)
    return torch.cat(parts, dim=0).to(target)


def is_coordinator() -> bool:
    """True on process 0, and in a single-process run."""
    return not _initialized() or _dist().get_rank() == 0
