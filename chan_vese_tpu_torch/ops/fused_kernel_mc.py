"""K4: one fused red-black iteration on a C-channel image plus the next
iteration's partials.

Counterpart of ``chan_vese_tpu/ops/pallas_sweep_mc.py``. The level set
stays scalar; only the data term (Chan-Sandberg-Vese: the channel average
of the weighted squared distances) and the region-mean partials see the
channels. u0 is carried channels-first, (C, H, W), as in the reference.
On a CUDA tensor :func:`fused_iteration_mc` launches ``csrc/fused_mc.cu``
(the single-sweep body of ``csrc/sweep.cuh`` with C channels); on a CPU
tensor it runs
:func:`fused_iteration_mc_reference`.

Partials layout (C+4,): [s_uH per channel..., s_H, s_dphi2, flips,
s_absdphi], taken over the transition phi -> phi_new.

``band_rows_mc`` and ``supports_mc`` are the reference's routing
predicates (pure integer functions of the shape); their VMEM and
alignment terms are the reference's routing, not limits of the Hopper
kernel, which takes any even H and W and 1 to 8 channels.
"""

from __future__ import annotations

import torch

from ..params import CVParams
from . import _cuda
from .fused_kernel import _HALO, _VMEM_LIMIT, iterate, partials


def band_rows_mc(h: int, w: int, c: int) -> int:
    """The reference's band height (routing predicate only)."""
    per_row = w * 4 * (27 + 2 * c)
    b = max(8, (_VMEM_LIMIT // per_row) // 8 * 8)
    return min(b, max(8, ((h - _HALO) // 8) * 8))


def supports_mc(h: int, w: int, c: int) -> bool:
    """Whether the reference routes (h, w, c) to its mc fused kernel."""
    return (w % 128 == 0 and h % 8 == 0 and h >= 24 and 1 <= c <= 8
            and band_rows_mc(h, w, c) + _HALO <= h)


def data_term_mc(u0_cfirst, c1, c2, p: CVParams, l1, l2):
    """f = -nu + sum_c (l2[c]/C) (u0[c]-c2[c])^2 - (l1[c]/C) (u0[c]-c1[c])^2,
    accumulated in the reference kernels' order (which differs from
    ``reductions.data_term``'s channel mean in the last ulps)."""
    C = u0_cfirst.shape[0]
    f = torch.full(u0_cfirst.shape[1:], -p.nu, dtype=u0_cfirst.dtype,
                   device=u0_cfirst.device)
    for ch in range(C):
        d1 = u0_cfirst[ch] - c1[ch]
        d2 = u0_cfirst[ch] - c2[ch]
        f = f + (l2[ch] / C) * (d2 * d2) - (l1[ch] / C) * (d1 * d1)
    return f


def chunk_reference_mc(phi, u0_cfirst, c1, c2, p: CVParams, k: int,
                       lambda1, lambda2, nout: int):
    """k red-black iterations with frozen per-channel means, then the
    partials of the last iteration padded to ``nout`` slots: the plain
    version of every multichannel red-black kernel."""
    C = u0_cfirst.shape[0]
    l1, l2 = p.channel_lambdas(C, lambda1, lambda2)
    c1 = torch.as_tensor(c1, dtype=phi.dtype, device=phi.device).reshape(C)
    c2 = torch.as_tensor(c2, dtype=phi.dtype, device=phi.device).reshape(C)
    f = data_term_mc(u0_cfirst, c1, c2, p, l1, l2)
    phi, prev = iterate(phi, f, p, k)
    return phi, partials(phi, prev, u0_cfirst, p, nout)


def fused_iteration_mc_reference(phi, u0_cfirst, c1, c2, p: CVParams,
                                 lambda1=None, lambda2=None):
    """Plain PyTorch version of :func:`fused_iteration_mc`."""
    return chunk_reference_mc(phi, u0_cfirst, c1, c2, p, 1, lambda1, lambda2,
                              u0_cfirst.shape[0] + 4)


def fused_iteration_mc(phi, u0_cfirst, c1, c2, p: CVParams,
                       lambda1=None, lambda2=None):
    """One red-black iteration on a (C, H, W) image; c1, c2: (C,) means.
    Returns (phi_new, partials (C+4,)).

    CPU tensors run the plain version; CUDA tensors (float32, contiguous,
    even H and W, 1 <= C <= 8) launch ``csrc/fused_mc.cu`` or raise.
    """
    C = _cuda.mc_channels(phi, u0_cfirst)
    if phi.device.type == "cpu":
        return fused_iteration_mc_reference(phi, u0_cfirst, c1, c2, p,
                                            lambda1, lambda2)
    l1, l2 = p.channel_lambdas(C, lambda1, lambda2)
    out = _cuda.launch_fused_mc(phi, u0_cfirst, c1, c2, p, l1, l2)
    fused_iteration_mc.launches += 1
    return out


fused_iteration_mc.launches = 0
