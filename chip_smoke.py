"""Smoke test of chan_vese_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from this checkout, holds each kernel against its
plain PyTorch version, drives the scalar main path (segment_banded at 4K,
3840x2160) through the kernels, checks the masks, and times the 4K
fixed-iteration run. Five phases, one line each; any failure raises and
exits non-zero. The last lines are a JSON object per kernel and
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch finds no CUDA device")

import chan_vese_tpu_torch as ct  # noqa: E402
from chan_vese_tpu_torch import _build  # noqa: E402
from chan_vese_tpu_torch.ops import (banded_kernel, fused_kernel,  # noqa: E402
                                     packed_kernel)
from chan_vese_tpu_torch.ops.reductions import region_means  # noqa: E402
from chan_vese_tpu_torch.utils.init_phi import init_phi  # noqa: E402

H4K, W4K = 2160, 3840
SHAPES = ((H4K, W4K), (1080, 1920), (1000, 1500))  # 4K, 1080p, ragged
# kernel vs plain on the card: rsqrtf/atanf/FMA contraction differ from
# PyTorch's ops in the last ulps and the stiff update amplifies that over
# k iterations; flips may differ at cells with |phi| below PHI_ATOL
PHI_RTOL, PHI_ATOL = 1e-4, 1e-4
PARTS_RTOL, PARTS_ATOL = 1e-4, 16.0

KERNELS = {
    "K1 fused_iteration": dict(
        wrapper=fused_kernel.fused_iteration,
        plain=lambda phi, u0, c1, c2, p, k: (
            fused_kernel.fused_iteration_reference(phi, u0, c1, c2, p)),
        source="chan_vese_tpu_torch/csrc/fused.cu",
        replaces="chan_vese_tpu/ops/pallas_sweep.py:216", ks=(1,),
        packed=False),
    "K2 banded_chunk": dict(
        wrapper=banded_kernel.banded_chunk,
        plain=banded_kernel.banded_chunk_reference,
        source="chan_vese_tpu_torch/csrc/banded.cu",
        replaces="chan_vese_tpu/ops/pallas_banded.py:104", ks=(1, 3, 8),
        packed=False),
    "K3 packed_banded_chunk": dict(
        wrapper=packed_kernel.packed_banded_chunk,
        plain=packed_kernel.packed_banded_chunk_reference,
        source="chan_vese_tpu_torch/csrc/packed.cu",
        replaces="chan_vese_tpu/ops/pallas_packed.py:528", ks=(8,),
        packed=True),
}


def two_disks(h, w, fg=217.0, bg=38.0, noise=8.0, seed=0):
    """Two bright disks on a dark background plus Gaussian noise, and the
    ground-truth mask (the recipe of tests/fixtures.py)."""
    rng = np.random.default_rng(seed)
    i, j = np.mgrid[0:h, 0:w].astype(np.float64)
    gt = ((np.hypot(i - 0.3 * h, j - 0.3 * w) < 0.15 * min(h, w))
          | (np.hypot(i - 0.68 * h, j - 0.65 * w) < 0.2 * min(h, w)))
    img = np.where(gt, fg, bg) + noise * rng.standard_normal(gt.shape)
    return img.astype(np.float32), gt


def iou(a, b):
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    return float((a & b).sum() / max((a | b).sum(), 1))


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def time_ms(fn, n):
    """Mean device time of fn over n calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


@contextlib.contextmanager
def plain_route():
    """The drivers with every kernel call replaced by its plain version
    (the same driver code on the same card, without the kernels)."""
    saved = (fused_kernel.fused_iteration, banded_kernel.banded_chunk,
             packed_kernel.packed_banded_chunk)
    fused_kernel.fused_iteration = fused_kernel.fused_iteration_reference
    banded_kernel.banded_chunk = (
        lambda phi, u0, c1, c2, p, k=8, unroll=1, fuse=False:
        banded_kernel.banded_chunk_reference(phi, u0, c1, c2, p, k))
    packed_kernel.packed_banded_chunk = (
        lambda phi, u0, c1, c2, p, k=8, unroll=1, fuse=False:
        packed_kernel.packed_banded_chunk_reference(phi, u0, c1, c2, p, k))
    try:
        yield
    finally:
        (fused_kernel.fused_iteration, banded_kernel.banded_chunk,
         packed_kernel.packed_banded_chunk) = saved


def main() -> int:
    dev = torch.device("cuda", 0)
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    nvcc = run([_build.find_nvcc(), "--version"]).splitlines()[-1]
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {nvcc}", flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s "
          f"({len(_build.sources())} sources)", flush=True)

    # phase 3: each kernel against its plain version, at the main path's
    # shapes and a ragged one, on the main path's inputs
    p = ct.CVParams()
    stats = {name: dict(max_abs_err=0.0) for name in KERNELS}
    for h, w in SHAPES:
        img, _ = two_disks(h, w)
        u0 = torch.from_numpy(img).to(dev)
        phi = init_phi((h, w), p.init, torch.float32, device=dev)
        c1, c2 = region_means(u0, phi, p.eps)
        for name, kern in KERNELS.items():
            args = ((packed_kernel._pack(phi), packed_kernel._pack(u0))
                    if kern["packed"] else (phi, u0))
            for k in kern["ks"]:
                kw = {} if name.startswith("K1") else {"k": k}
                got_phi, got_parts = kern["wrapper"](*args, c1, c2, p, **kw)
                ref_phi, ref_parts = kern["plain"](*args, c1, c2, p, k)
                torch.cuda.synchronize()
                err = float((got_phi - ref_phi).abs().max())
                ok_phi = torch.allclose(got_phi, ref_phi, rtol=PHI_RTOL,
                                        atol=PHI_ATOL)
                sure = ref_phi.abs() > PHI_ATOL
                ok_mask = bool(((got_phi >= 0) == (ref_phi >= 0))[sure]
                               .all())
                ok_parts = torch.allclose(got_parts, ref_parts,
                                          rtol=PARTS_RTOL, atol=PARTS_ATOL)
                print(f"phase 3 {name} k={k} {h}x{w}: phi max|d|={err:.3e} "
                      f"parts max|d|="
                      f"{float((got_parts - ref_parts).abs().max()):.3e} "
                      f"(phi rtol {PHI_RTOL} atol {PHI_ATOL}, parts rtol "
                      f"{PARTS_RTOL} atol {PARTS_ATOL})", flush=True)
                if not (ok_phi and ok_mask and ok_parts
                        and math.isfinite(err)):
                    raise AssertionError(f"{name} k={k} at {h}x{w} "
                                         f"disagrees with its plain version")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                                 err)
            if (h, w) == (H4K, W4K):
                k = kern["ks"][-1]
                kw = {} if name.startswith("K1") else {"k": k}
                stats[name]["ms"] = time_ms(
                    lambda: kern["wrapper"](*args, c1, c2, p, **kw), 20)
                stats[name]["plain_ms"] = time_ms(
                    lambda: kern["plain"](*args, c1, c2, p, k), 3)

    # phase 4: the main path through user entry points. auto_config sends
    # 4K to K3 and 1080p to K2; segment_fused is the per-iteration driver
    # (K1). Counts are taken over exactly these calls. mu is 0.001 * 255^2:
    # at the default 0.01 * 255^2 the k=8 frozen-means route (the
    # reference's as well) leaves this image's symmetric checkerboard start
    # too slowly and stops or plateaus below the fused route (PERF.md).
    pt = ct.CVParams(mu=0.001 * 255.0 ** 2, max_iter=500)
    img4k, gt4k = two_disks(H4K, W4K)
    img1k, gt1k = two_disks(1080, 1920)
    u4k = torch.from_numpy(img4k).to(dev)
    u1k = torch.from_numpy(img1k).to(dev)
    for kern in KERNELS.values():
        kern["wrapper"].launches = 0
    res4k = ct.segment_banded(u4k, pt)
    res1k = ct.segment_banded(u1k, pt)
    resf = ct.segment_fused(u1k, pt)
    torch.cuda.synchronize()
    for name, kern in KERNELS.items():
        stats[name]["launches"] = kern["wrapper"].launches
    with plain_route():
        plain4k = ct.segment_banded(u4k, pt)
        plain1k = ct.segment_banded(u1k, pt)
    torch.cuda.synchronize()
    checks = {
        "4K IoU vs truth": (iou(res4k.mask.cpu(), gt4k), 0.99),
        "4K IoU vs plain route": (iou(res4k.mask.cpu(), plain4k.mask.cpu()),
                                  0.999),
        "1080p IoU vs truth": (iou(res1k.mask.cpu(), gt1k), 0.99),
        "1080p IoU vs plain route": (iou(res1k.mask.cpu(),
                                         plain1k.mask.cpu()), 0.999),
        "1080p fused IoU vs truth": (iou(resf.mask.cpu(), gt1k), 0.99),
    }
    print(f"phase 4 slice: 4K {res4k.iters} iters (plain route "
          f"{plain4k.iters}), 1080p {res1k.iters} (plain {plain1k.iters}), "
          f"fused 1080p {resf.iters}; "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in
                      checks.items())
          + "; launches " + ", ".join(f"{n.split()[0]}={s['launches']}"
                                     for n, s in stats.items()), flush=True)
    if not (res4k.iters < pt.max_iter and res1k.iters < pt.max_iter
            and resf.iters < pt.max_iter):
        raise AssertionError("a run did not converge within max_iter")
    if not torch.isfinite(res4k.phi).all():
        raise AssertionError("non-finite 4K level set")
    for key, (val, bar) in checks.items():
        if not val >= bar:
            raise AssertionError(f"{key} = {val} < {bar}")
    for name, s in stats.items():
        if s["launches"] < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    # phase 5: steady-state throughput of the 4K fixed-iteration run
    p = ct.CVParams()
    iters, plain_iters = 800, 40
    kern_ms = time_ms(lambda: ct.segment_banded_fixed(u4k, p, iters=iters),
                      1)
    with plain_route():
        plain_ms = time_ms(
            lambda: ct.segment_banded_fixed(u4k, p, iters=plain_iters), 1)
    rate = H4K * W4K * iters / (kern_ms * 1e3)
    plain_rate = H4K * W4K * plain_iters / (plain_ms * 1e3)
    print(f"phase 5 throughput: segment_banded_fixed 4K k=8 packed, {iters} "
          f"iters {kern_ms:.1f} ms = {rate:.1f} Mpixel-iters/s; plain "
          f"route {plain_iters} iters {plain_ms:.1f} ms = "
          f"{plain_rate:.1f} Mpixel-iters/s [{card}]", flush=True)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"],
             replaces=k["replaces"], launches=stats[name]["launches"],
             max_abs_err=stats[name]["max_abs_err"],
             ms=stats[name]["ms"], plain_ms=stats[name]["plain_ms"])
        for name, k in KERNELS.items()]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
