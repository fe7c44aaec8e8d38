"""The banded drivers of ``chan_vese_tpu_torch.models.banded``:
``segment_banded_fixed`` for a cell with ``iters``, ``segment_banded``
(tolerance mode, the CLI's default route on the card) for one with
``iters`` null. Gray (H, W) and (H, W, C) images alike. :func:`route`
gives the chunk length the program picks for an input, which the cell
states and the reference follows."""

from . import port_params

TRAJECTORY = "frozen_chunks"


def prepare(params, cell, device):
    from chan_vese_tpu_torch.models.banded import (segment_banded,
                                                   segment_banded_fixed)

    p, lambdas = port_params(params)
    iters = cell["iters"]
    if iters is None:
        def call(u0):
            res = segment_banded(u0, p, **lambdas)
            return res.phi, res.mask, int(res.iters)
    else:
        def call(u0):
            phi, mask = segment_banded_fixed(u0, p, iters=iters, **lambdas)
            return phi, mask, iters
    return call


def route(u0, params):
    """{"k": the chunk length of the program's banded drivers for ``u0``}
    by their router (``auto_config``), 1 where an input off the banded
    envelope goes to the fused driver, one iteration a chunk."""
    from chan_vese_tpu_torch.models import banded
    from chan_vese_tpu_torch.ops.banded_kernel import (supports_banded,
                                                       supports_banded_mc)

    p, _ = port_params(params)
    if u0.dim() == 3:
        k = banded.auto_config_mc(*u0.shape)[0]
        ok = supports_banded_mc(*u0.shape[:2], k, u0.shape[2])
    else:
        k = banded.auto_config(*u0.shape)[0]
        ok = supports_banded(*u0.shape, k)
    ok = ok and p.order == "redblack" and not p.reinit_every
    return {"k": k if ok else 1}
