"""A frame stack through ``chan_vese_tpu_torch.parallel
.segment_stack_sharded`` on a data mesh of the run's device: a fixed
iteration count, (N, H, W) gray frames. The cell's ``use_pallas`` (null:
the program's own choice) is handed on."""

from . import port_params

TRAJECTORY = "exact_means"


def prepare(params, cell, device):
    from chan_vese_tpu_torch.parallel.data_parallel import (
        segment_stack_sharded)
    from chan_vese_tpu_torch.parallel.mesh import make_data_mesh

    p, lambdas = port_params(params)
    if lambdas:
        raise ValueError("the stack entry takes gray frames only")
    mesh = make_data_mesh(devices=[device])
    iters, use_pallas = cell["iters"], cell.get("use_pallas")

    def call(u0):
        phi, mask = segment_stack_sharded(u0, p, mesh, iters=iters,
                                          use_pallas=use_pallas)
        return phi, mask, iters
    return call
