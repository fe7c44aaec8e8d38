"""Driver entry points of the port: a single-device kernel check and a
multi-device dry run (the counterpart of the repository's
``__graft_entry__.py``).

entry(device=None)   -> (fn, args): one banded chunk of k = 8 red-black
                        iterations at 512^2, the flagship's kernel (K2,
                        launched through ``ops/_cuda.py``) on a CUDA
                        device; with ``device="cpu"`` the plain
                        ``models.scalar.step``.
dryrun_multichip(n, device=None)
                     -> runs one sharded iteration of a frame stack over
                        a ('data', 'x', 'y') layout of n devices (frames
                        split over 'data', each frame over an x-by-y
                        grid, the global max update norm taken over the
                        whole layout) and one comm_k = 2 chunk of the
                        banded shard mode (K2's shard canvases) on the
                        first grid. ``device="cpu"`` takes n CPU devices;
                        otherwise the CUDA devices in turn (one process
                        drives every shard, so the layout fits one card).

    python -m chan_vese_tpu_torch.graft_entry [--device cpu] [N]
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .params import CVParams

ENTRY_SHAPE = (512, 512)
ENTRY_K = 8


def entry(device=None):
    """(fn, (phi0, u0, c1, c2)) on ``device`` (default: the first CUDA
    device)."""
    from .models.scalar import step
    from .ops import banded_kernel
    from .ops.reductions import region_means
    from .utils.init_phi import init_phi

    device = torch.device("cuda", 0) if device is None else torch.device(
        device)
    p = CVParams()
    rng = np.random.default_rng(0)
    u0 = torch.from_numpy(rng.uniform(0, 255, ENTRY_SHAPE)).to(
        device, torch.float32)
    phi0 = init_phi(ENTRY_SHAPE, "checkerboard", torch.float32,
                    device=device)
    c1, c2 = region_means(u0, phi0, p.eps)

    if device.type == "cuda":
        def fn(phi, u0, c1, c2):
            return banded_kernel.banded_chunk(phi, u0, c1, c2, p,
                                              k=ENTRY_K)
    else:
        def fn(phi, u0, c1, c2):
            del c1, c2
            phi_new, c1n, c2n, delta = step(phi, u0, p)
            return phi_new, torch.stack([c1n, c2n, delta])

    return fn, (phi0, u0, c1, c2)


def _factor3(n):
    """n -> (ndata, nx, ny): the spatial grid takes the largest divisor
    of n up to 4 (split as evenly as its factors allow), the data axis
    takes everything else: 6 -> (2, 1, 3), 8 -> (2, 2, 2), 12 -> (3, 2, 2),
    7 -> (7, 1, 1)."""
    d = max(k for k in range(1, min(n, 4) + 1) if n % k == 0)
    nx = max(k for k in range(1, math.isqrt(d) + 1) if d % k == 0)
    return n // d, nx, d // nx


def _devices(n: int, device):
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    if not count:
        raise RuntimeError("dryrun_multichip needs a CUDA device, or "
                           "device='cpu'")
    return [torch.device("cuda", i % count) for i in range(n)]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded step of a 2-frames-a-data-shard stack and one comm_k = 2
    banded chunk over the ('data', 'x', 'y') layout of ``n_devices``.
    Returns {'layout', 'delta', 'chunk_finite'}."""
    from .parallel import make_grid_mesh, make_hybrid_mesh, segment_sharded

    nd, nx, ny = _factor3(n_devices)
    mesh = make_hybrid_mesh(nd, nx, ny, _devices(n_devices, device))
    p = CVParams()
    h, w = 16, 16          # tiny local tiles
    H, W = nx * h, ny * w
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 255, (2 * nd, H, W)).astype(np.float32)
    grids = [make_grid_mesh(nx, ny, mesh.devices[d * nx * ny:
                                                 (d + 1) * nx * ny])
             for d in range(nd)]

    deltas = []
    for i, frame in enumerate(frames):
        grid = grids[i // 2]
        res = segment_sharded(torch.from_numpy(frame), p, grid, fixed=True,
                              max_iter=1)
        if tuple(res.phi.shape) != (H, W):
            raise AssertionError(f"sharded step returned {res.phi.shape}")
        deltas.append(res.delta.to("cpu", torch.float64))
    # the data axis's reduction: the global max update norm
    gmax = float(torch.stack(deltas).max())
    if not math.isfinite(gmax):
        raise AssertionError("non-finite update norm in the dry run")

    # the communication-avoiding chunk: K2's shard mode (its plain version
    # on CPU devices) on comm_k = 2 canvases of the first grid
    u2 = torch.from_numpy(rng.uniform(0, 255, (24 * nx, 64 * ny))
                          .astype(np.float32))
    res2 = segment_sharded(u2, p, grids[0], fixed=True, max_iter=2,
                           comm_k=2, use_pallas=True)
    finite = bool(torch.isfinite(res2.phi).all())
    if not finite:
        raise AssertionError("non-finite level set in the comm_k chunk")
    print(f"dryrun_multichip OK: layout (data={nd}, x={nx}, y={ny}) on "
          f"{mesh.devices[0].type}, batch {len(frames)} of {H}x{W}, "
          f"delta={gmax:.4f}; comm_k=2 banded chunk OK on ({nx}, {ny})")
    return {"layout": (nd, nx, ny), "delta": gmax, "chunk_finite": finite}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if argv[:1] == ["--device"]:
        device, argv = argv[1], argv[2:]
    n = int(argv[0]) if argv else 8
    dryrun_multichip(n, device)
    fn, args = entry(device)
    fn(*args)
    print("entry OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
