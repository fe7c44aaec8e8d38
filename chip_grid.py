"""Sharded segmentation across four NVIDIA GPUs.

    python3 chip_grid.py        # on a machine with four GPUs

Runs segment_sharded (and segment_sharded_fixed_trace) on a 2x2 grid of
shards laid over four cards, one shard a card, and the same grid on one
card, on the 4K images of chip_smoke.py, and holds the two against each
other: the kernels, their inputs and the order in which the shards'
partials are summed are the same, so phi must be bitwise equal. Does the
same for segment_stack_sharded on a data mesh of the four cards against
one card. Times every run on both layouts. The halo strips between cards
and the gather move by peer copy; with halo='rdma' each card's K14
launch reads its neighbours' strips through peer pointers (NVLink), which
must give phi bitwise equal to the ppermute run, and an exchange of each
kind (K14, exchange_halo2d) is timed on the four cards.
Exits non-zero without four CUDA devices or on any disagreement; the
last line is {"ok": true, ...}.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

if torch.cuda.device_count() < 4:
    sys.exit("chip_grid: needs four CUDA devices")

import chan_vese_tpu_torch as ct  # noqa: E402
from chan_vese_tpu_torch.parallel import (  # noqa: E402
    exchange_halo2d, exchange_halo2d_rdma, grid_sharding, make_data_mesh,
    make_grid_mesh, segment_sharded, segment_sharded_fixed_trace,
    segment_stack_sharded, shard_grid)
from chip_smoke import (H4K, W4K, colored_squares, iou_phases,  # noqa: E402
                        run, time_ms, two_disks)

ITERS, ITERS_K1, TRACE_ITERS, STACK_ITERS = 800, 100, 50, 100


def main() -> int:
    cards = [torch.device("cuda", i) for i in range(4)]
    names = run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()
    print(f"cards: {names}", flush=True)
    pt = ct.CVParams(mu=0.001 * 255.0 ** 2, max_iter=500)
    pv = ct.CVParams(mu=0.0001 * 255.0 ** 2, max_iter=500)
    img, gt = two_disks(H4K, W4K)
    rgb, gtc = colored_squares(H4K, W4K)
    u = torch.from_numpy(img).to(cards[0])
    v = torch.from_numpy(rgb).to(cards[0])
    grids = {"four cards": make_grid_mesh(2, 2, cards),
             "one card": make_grid_mesh(2, 2, cards[:1] * 4)}
    runs = {  # run on a mesh, iterations a timed run, image's truth
        "gray comm_k=8": (lambda m: segment_sharded(
            u, pt, m, fixed=True, max_iter=ITERS, comm_k=8), ITERS, gt),
        "gray comm_k=1": (lambda m: segment_sharded(
            u, pt, m, fixed=True, max_iter=ITERS_K1), ITERS_K1, gt),
        "gray comm_k=8 rdma": (lambda m: segment_sharded(
            u, pt, m, fixed=True, max_iter=ITERS, comm_k=8, halo="rdma"),
            ITERS, gt),
        "gray comm_k=1 rdma": (lambda m: segment_sharded(
            u, pt, m, fixed=True, max_iter=ITERS_K1, halo="rdma"), ITERS_K1,
            gt),
        "rgb comm_k=8": (lambda m: segment_sharded(
            v, pv, m, fixed=True, max_iter=ITERS, comm_k=8), ITERS, gtc),
        "gray tolerance comm_k=8": (lambda m: segment_sharded(
            u, pt, m, comm_k=8), None, gt),
        "trace": (lambda m: segment_sharded_fixed_trace(
            u, ct.CVParams(), m, iters=TRACE_ITERS), TRACE_ITERS, None),
    }
    ok = True
    four = {}
    for tag, (fn, iters, truth) in runs.items():
        out = {name: fn(mesh) for name, mesh in grids.items()}
        torch.cuda.synchronize()
        a, b = out["four cards"], out["one card"]
        four[tag] = a
        same = torch.equal(a.phi, b.phi) and a.phi.device == cards[0]
        if tag.endswith("rdma"):  # K14's peer reads against peer copies
            same = same and torch.equal(a.phi, four[tag[:-5]].phi)
        if tag == "trace":
            same = same and torch.equal(a.energy, b.energy)
        else:
            same = same and a.iters == b.iters
        score = (iou_phases(a.mask.cpu(), truth) if truth is not None
                 else float("nan"))
        line = (f"{tag}: four cards bitwise equal to one card {same}; "
                f"iterations {getattr(a, 'iters', TRACE_ITERS)}; IoU vs "
                f"truth {score:.6f}")
        if iters is not None:
            ms = {name: time_ms(lambda: fn(mesh), 1)
                  for name, mesh in grids.items()}
            line += "; " + ", ".join(
                f"{name} {t:.3f} ms = {H4K * W4K * iters / (t * 1e3):.1f} "
                f"Mpixel-iters/s" for name, t in ms.items())
        print(line, flush=True)
        ok = ok and same and (truth is None or score >= 0.99)

    # one exchange of the four shards' blocks across the cards: K14's
    # peer reads against the plain exchange's peer copies (host clock around 20 exchanges, every card
    # synchronized)
    blocks = shard_grid(u, grid_sharding(grids["four cards"]))

    def sync_all():
        for c in cards:
            torch.cuda.synchronize(c)

    times = []
    for D in (4, 32):
        got = exchange_halo2d_rdma(blocks, D)
        ref = exchange_halo2d(blocks, D)
        sync_all()
        same = all(torch.equal(x, y)
                   for rx, ry in zip(got, ref) for x, y in zip(rx, ry))
        ok = ok and same
        for name, fn in (("K14", exchange_halo2d_rdma),
                         ("exchange_halo2d", exchange_halo2d)):
            fn(blocks, D)
            sync_all()
            t0 = time.perf_counter()
            for _ in range(20):
                fn(blocks, D)
            sync_all()
            times.append(f"D={D} {name} "
                         f"{(time.perf_counter() - t0) / 20 * 1e3:.3f} ms")
        times[-1] += f" (K14 bitwise equal to it {same})"
    print("exchange of the 2x2 grid over four cards (host clock, all cards "
          "synchronized): " + "; ".join(times), flush=True)

    # a stack of frames on a data mesh of the four cards
    rng = np.random.default_rng(0)
    stack = torch.from_numpy(rng.uniform(0, 255, (64, 512, 512))
                             .astype(np.float32)).to(cards[0])
    meshes = {"four cards": make_data_mesh(devices=cards),
              "one card": make_data_mesh(devices=cards[:1])}
    out = {name: segment_stack_sharded(stack, ct.CVParams(), mesh,
                                       iters=STACK_ITERS)[0]
           for name, mesh in meshes.items()}
    torch.cuda.synchronize()
    same = torch.equal(out["four cards"], out["one card"])
    ms = {name: time_ms(lambda: segment_stack_sharded(
        stack, ct.CVParams(), mesh, iters=STACK_ITERS), 1)
        for name, mesh in meshes.items()}
    print(f"stack 64x512^2 {STACK_ITERS} iterations on a data mesh: four "
          f"cards bitwise equal to one card {same}; "
          + ", ".join(f"{name} {t:.3f} ms = "
                      f"{stack.numel() * STACK_ITERS / (t * 1e3):.1f} "
                      f"Mpixel-iters/s" for name, t in ms.items()),
          flush=True)
    ok = ok and same
    if not ok:
        raise AssertionError("the four-card runs disagree with one card")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
