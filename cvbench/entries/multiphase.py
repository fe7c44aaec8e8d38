"""Four-phase Vese-Chan through ``chan_vese_tpu_torch.models.multiphase
.segment_multiphase``: the configuration's ``m_sets`` coupled level sets,
a fixed iteration count, the program's own routing (``use_pallas`` None:
on a CUDA tensor at 512x512, K10 in one launch). A call returns the level
sets (M, H, W), the phase labels (H, W) and the iterations."""

from . import port_params

TRAJECTORY = "four_phase"


def prepare(params, cell, device):
    from chan_vese_tpu_torch.models.multiphase import segment_multiphase

    p, lambdas = port_params(params)
    if lambdas:
        raise ValueError("the multiphase entry takes gray images only")
    m_sets, iters = int(params["m_sets"]), cell["iters"]

    def call(u0):
        res = segment_multiphase(u0, p, m_sets=m_sets, fixed=True,
                                 max_iter=iters)
        return res.phis, res.labels, res.iters
    return call
