"""Smoke test of chan_vese_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from this checkout, holds each kernel against its
plain PyTorch version, drives the grayscale main path (segment_banded at
4K, 3840x2160) and the RGB main path (segment_banded at 4K RGB,
3840x2160x3) through the kernels, checks the masks, and times the 4K
fixed-iteration runs. Five phases; any failure raises and exits non-zero.
The last lines are a JSON object per kernel, the card's name and power
limit, and {"ok": true, "device": {...}}. Without a CUDA device it exits 1
and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
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
                                     fused_kernel_mc, packed_kernel)
from chan_vese_tpu_torch.ops.reductions import region_means  # noqa: E402
from chan_vese_tpu_torch.utils.init_phi import init_phi  # noqa: E402

H4K, W4K = 2160, 3840
SHAPES = ((H4K, W4K), (1080, 1920), (1000, 1500))  # 4K, 1080p, ragged
RGB = 3
# kernel vs plain on the card: rsqrtf/atanf/FMA contraction differ from
# PyTorch's ops in the last ulps and the stiff update amplifies that over
# k iterations; flips may differ at cells with |phi| below PHI_ATOL
PHI_RTOL, PHI_ATOL = 1e-4, 1e-4
PARTS_RTOL, PARTS_ATOL = 1e-4, 16.0
# per-channel weights of the extra k=1 check of the mc kernels (with
# lambda1 != lambda2 per channel the k-iteration chunk from the
# checkerboard start is ill-conditioned: plain f32 and f64 differ by 0.1 at
# k=8, so deeper chunks are held at the main path's default lambdas)
LAMBDAS = dict(lambda1=(1.0, 1.2, 0.8), lambda2=(0.9, 1.0, 1.1))

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
# operations per cell update of redblack.cuh::update_cell: 8 differences,
# 4 halvings, 4 face coefficients (2 squares, 2 adds, rsqrt, mu *), the
# Dirac factor (square, add, divide), num (4 products, 4 adds, 2) and den
# (3 adds, 2), the divide; rsqrt, divide and atan count as one operation
OPS_UPDATE = 55

KERNELS = {
    "K1 fused_iteration": dict(
        wrapper=fused_kernel.fused_iteration,
        plain=lambda phi, u0, c1, c2, p, k: (
            fused_kernel.fused_iteration_reference(phi, u0, c1, c2, p)),
        source="chan_vese_tpu_torch/csrc/fused.cu",
        replaces="chan_vese_tpu/ops/pallas_sweep.py:216", ks=(1,),
        packed=False, channels=0),
    "K2 banded_chunk": dict(
        wrapper=banded_kernel.banded_chunk,
        plain=banded_kernel.banded_chunk_reference,
        source="chan_vese_tpu_torch/csrc/banded.cu",
        replaces="chan_vese_tpu/ops/pallas_banded.py:104", ks=(1, 3, 8),
        packed=False, channels=0),
    "K3 packed_banded_chunk": dict(
        wrapper=packed_kernel.packed_banded_chunk,
        plain=packed_kernel.packed_banded_chunk_reference,
        source="chan_vese_tpu_torch/csrc/packed.cu",
        replaces="chan_vese_tpu/ops/pallas_packed.py:528", ks=(8,),
        packed=True, channels=0),
    "K4 fused_iteration_mc": dict(
        wrapper=fused_kernel_mc.fused_iteration_mc,
        plain=lambda phi, u0, c1, c2, p, k, **lam: (
            fused_kernel_mc.fused_iteration_mc_reference(phi, u0, c1, c2, p,
                                                         **lam)),
        source="chan_vese_tpu_torch/csrc/fused_mc.cu",
        replaces="chan_vese_tpu/ops/pallas_sweep_mc.py:50", ks=(1,),
        packed=False, channels=RGB),
    "K5 banded_chunk_mc": dict(
        wrapper=banded_kernel.banded_chunk_mc,
        plain=banded_kernel.banded_chunk_mc_reference,
        source="chan_vese_tpu_torch/csrc/banded_mc.cu",
        replaces="chan_vese_tpu/ops/pallas_banded.py:507", ks=(1, 3, 8),
        packed=False, channels=RGB),
    "K6 packed_banded_chunk_mc": dict(
        wrapper=packed_kernel.packed_banded_chunk_mc,
        plain=packed_kernel.packed_banded_chunk_mc_reference,
        source="chan_vese_tpu_torch/csrc/packed_mc.cu",
        replaces="chan_vese_tpu/ops/pallas_packed.py:965", ks=(8,),
        packed=True, channels=RGB),
}
GRAY = [n for n, k in KERNELS.items() if not k["channels"]]
COLOR = [n for n, k in KERNELS.items() if k["channels"]]


def two_disks(h, w, fg=217.0, bg=38.0, noise=8.0, seed=0):
    """Two bright disks on a dark background plus Gaussian noise, and the
    ground-truth mask (the recipe of tests/fixtures.py)."""
    rng = np.random.default_rng(seed)
    i, j = np.mgrid[0:h, 0:w].astype(np.float64)
    gt = ((np.hypot(i - 0.3 * h, j - 0.3 * w) < 0.15 * min(h, w))
          | (np.hypot(i - 0.68 * h, j - 0.65 * w) < 0.2 * min(h, w)))
    img = np.where(gt, fg, bg) + noise * rng.standard_normal(gt.shape)
    return img.astype(np.float32), gt


def colored_squares(h, w, noise=8.0, seed=1):
    """RGB image: two differently colored squares on a gray background
    plus Gaussian noise, and the ground-truth mask (the recipe of
    tests/fixtures.py)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), (30.0, 40.0, 50.0))
    gt = np.zeros((h, w), dtype=bool)
    sq1 = np.s_[h // 8: h // 8 + h // 4, w // 8: w // 8 + w // 4]
    sq2 = np.s_[h // 2: h // 2 + h // 3, w // 2: w // 2 + w // 3]
    img[sq1], gt[sq1] = (230.0, 200.0, 60.0), True
    img[sq2], gt[sq2] = (210.0, 60.0, 230.0), True
    img = img + noise * rng.standard_normal(img.shape)
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


def bound(h, w, k, channels):
    """(ms, "bytes" or "operations"): the least time an H100 SXM takes for
    one launch's work at (h, w), k iterations, ``channels`` (0 = gray):
    phi and every u0 channel read once and phi written once, against the
    operations of k updates per pixel plus the data term (8 per channel)
    and the partials (14 + 2 per channel) once per pixel."""
    c = max(channels, 1)
    nbytes = 4 * h * w * (2 + c)
    ops = h * w * (OPS_UPDATE * k + 8 * c + 14 + 2 * c)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary():
    """Registers and spill stores of every chunk_kernel instance, from
    ptxas's -v report of the build: 'flat/packed C=n: R regs, S B spill'."""
    out, name = {}, None
    for line in _build.ptxas_report().splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:  # the lines up to the next entry describe this one
            m = re.search(r"chunk_kernelILb(\d)ELi(\d+)E", m.group(1))
            name = (("flat", "packed")[int(m.group(1))], int(m.group(2))) \
                if m else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(name, {})["spill"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["regs"] = int(m.group(1))
    return ", ".join(f"{lay} C={c}: {v.get('regs')} regs {v.get('spill')} B "
                     f"spill" for (lay, c), v in sorted(out.items()))


@contextlib.contextmanager
def plain_route():
    """The drivers with every kernel call replaced by its plain version
    (the same driver code on the same card, without the kernels)."""
    saved = (fused_kernel.fused_iteration, banded_kernel.banded_chunk,
             packed_kernel.packed_banded_chunk,
             fused_kernel_mc.fused_iteration_mc,
             banded_kernel.banded_chunk_mc,
             packed_kernel.packed_banded_chunk_mc)
    fused_kernel.fused_iteration = fused_kernel.fused_iteration_reference
    banded_kernel.banded_chunk = (
        lambda phi, u0, c1, c2, p, k=8, unroll=1, fuse=False:
        banded_kernel.banded_chunk_reference(phi, u0, c1, c2, p, k))
    packed_kernel.packed_banded_chunk = (
        lambda phi, u0, c1, c2, p, k=8, unroll=1, fuse=False:
        packed_kernel.packed_banded_chunk_reference(phi, u0, c1, c2, p, k))
    fused_kernel_mc.fused_iteration_mc = (
        fused_kernel_mc.fused_iteration_mc_reference)
    banded_kernel.banded_chunk_mc = (
        lambda phi, u0, c1, c2, p, k=8, unroll=1, lambda1=None,
        lambda2=None, fuse=False: banded_kernel.banded_chunk_mc_reference(
            phi, u0, c1, c2, p, k, lambda1, lambda2))
    packed_kernel.packed_banded_chunk_mc = (
        lambda phi, u0, c1, c2, p, k=8, unroll=1, fuse=False, lambda1=None,
        lambda2=None: packed_kernel.packed_banded_chunk_mc_reference(
            phi, u0, c1, c2, p, k, lambda1, lambda2))
    try:
        yield
    finally:
        (fused_kernel.fused_iteration, banded_kernel.banded_chunk,
         packed_kernel.packed_banded_chunk,
         fused_kernel_mc.fused_iteration_mc, banded_kernel.banded_chunk_mc,
         packed_kernel.packed_banded_chunk_mc) = saved


def check_kernel(name, kern, args, c1, c2, p, k, h, w, lam):
    """One kernel launch against its plain version; returns max |d phi|."""
    kw = {} if kern["ks"] == (1,) else {"k": k}
    got_phi, got_parts = kern["wrapper"](*args, c1, c2, p, **kw, **lam)
    ref_phi, ref_parts = kern["plain"](*args, c1, c2, p, k, **lam)
    torch.cuda.synchronize()
    err = float((got_phi - ref_phi).abs().max())
    ok_phi = torch.allclose(got_phi, ref_phi, rtol=PHI_RTOL, atol=PHI_ATOL)
    sure = ref_phi.abs() > PHI_ATOL
    ok_mask = bool(((got_phi >= 0) == (ref_phi >= 0))[sure].all())
    ok_parts = (got_parts.shape == ref_parts.shape
                and torch.allclose(got_parts, ref_parts, rtol=PARTS_RTOL,
                                   atol=PARTS_ATOL))
    tag = f"{h}x{w}" + (f"x{kern['channels']}" if kern["channels"] else "")
    print(f"phase 3 {name} k={k} {tag}{' per-channel lambda' if lam else ''}"
          f": phi max|d|={err:.3e} parts max|d|="
          f"{float((got_parts - ref_parts).abs().max()):.3e} "
          f"(phi rtol {PHI_RTOL} atol {PHI_ATOL}, parts rtol "
          f"{PARTS_RTOL} atol {PARTS_ATOL})", flush=True)
    if not (ok_phi and ok_mask and ok_parts and math.isfinite(err)):
        raise AssertionError(f"{name} k={k} at {tag} disagrees with its "
                             f"plain version")
    return err


def check_masks(checks):
    for key, (val, bar) in checks.items():
        if not val >= bar:
            raise AssertionError(f"{key} = {val} < {bar}")


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
          f"({len(_build.sources())} sources); ptxas: {ptxas_summary()}",
          flush=True)

    # phase 3: each kernel against its plain version, at the main paths'
    # shapes and a ragged one, on the main paths' inputs (the gray image
    # for K1-K3, the RGB one channels-first for K4-K6)
    p = ct.CVParams()
    stats = {name: dict(max_abs_err=0.0) for name in KERNELS}
    for h, w in SHAPES:
        img, _ = two_disks(h, w)
        rgb, _ = colored_squares(h, w)
        u0 = torch.from_numpy(img).to(dev)
        u0_rgb = torch.from_numpy(rgb).to(dev)
        ucf = u0_rgb.permute(2, 0, 1).contiguous()
        phi = init_phi((h, w), p.init, torch.float32, device=dev)
        means = {0: region_means(u0, phi, p.eps),
                 RGB: region_means(u0_rgb, phi, p.eps)}
        inputs = {(0, False): (phi, u0),
                  (0, True): (packed_kernel._pack(phi),
                              packed_kernel._pack(u0)),
                  (RGB, False): (phi, ucf),
                  (RGB, True): (packed_kernel._pack(phi),
                                packed_kernel._pack_mc(ucf))}
        for name, kern in KERNELS.items():
            args = inputs[kern["channels"], kern["packed"]]
            c1, c2 = means[kern["channels"]]
            runs = [(k, {}) for k in kern["ks"]]
            if kern["channels"]:
                runs.append((1, LAMBDAS))
            for k, lam in runs:
                err = check_kernel(name, kern, args, c1, c2, p, k, h, w, lam)
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                                 err)
            if (h, w) == (H4K, W4K):
                k = kern["ks"][-1]
                kw = {} if kern["ks"] == (1,) else {"k": k}
                stats[name]["ms"] = time_ms(
                    lambda: kern["wrapper"](*args, c1, c2, p, **kw), 20)
                stats[name]["plain_ms"] = time_ms(
                    lambda: kern["plain"](*args, c1, c2, p, k), 3)
                stats[name]["bound_ms"], stats[name]["bound_by"] = bound(
                    h, w, k, kern["channels"])

    # phase 4, gray main path, through user entry points. auto_config
    # sends 4K to K3 and 1080p to K2; segment_fused is the per-iteration
    # driver (K1). Counts are taken over exactly these calls. mu is
    # 0.001 * 255^2: at the default 0.01 * 255^2 the k=8 frozen-means
    # route (the reference's as well) leaves this image's symmetric
    # checkerboard start too slowly and stops or plateaus below the fused
    # route (PERF.md).
    pt = ct.CVParams(mu=0.001 * 255.0 ** 2, max_iter=500)
    img4k, gt4k = two_disks(H4K, W4K)
    img1k, gt1k = two_disks(1080, 1920)
    u4k = torch.from_numpy(img4k).to(dev)
    u1k = torch.from_numpy(img1k).to(dev)
    for name in GRAY:
        KERNELS[name]["wrapper"].launches = 0
    res4k = ct.segment_banded(u4k, pt)
    res1k = ct.segment_banded(u1k, pt)
    resf = ct.segment_fused(u1k, pt)
    torch.cuda.synchronize()
    for name in GRAY:
        stats[name]["launches"] = KERNELS[name]["wrapper"].launches
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
          + "; launches " + ", ".join(f"{n.split()[0]}={stats[n]['launches']}"
                                     for n in GRAY), flush=True)
    if not (res4k.iters < pt.max_iter and res1k.iters < pt.max_iter
            and resf.iters < pt.max_iter):
        raise AssertionError("a run did not converge within max_iter")
    if not torch.isfinite(res4k.phi).all():
        raise AssertionError("non-finite 4K level set")
    check_masks(checks)

    # phase 4, RGB main path: auto_config_mc sends 4K RGB to K6 and 1080p
    # RGB to K5; segment_fused on RGB is the per-iteration driver (K4).
    # mu is 0.0001 * 255^2: at the default mu and at 0.001 * 255^2 the k=8
    # frozen-means route leaves this image's checkerboard start with no
    # contour (8 iterations, IoU 0.15), where the per-iteration route
    # converges (PERF.md); the reference's own RGB tests start from a
    # circle, which at 4K does not converge within 3000 iterations.
    pv = ct.CVParams(mu=0.0001 * 255.0 ** 2, max_iter=500)
    rgb4k, gtc4k = colored_squares(H4K, W4K)
    rgb1k, gtc1k = colored_squares(1080, 1920)
    v4k = torch.from_numpy(rgb4k).to(dev)
    v1k = torch.from_numpy(rgb1k).to(dev)
    for name in COLOR:
        KERNELS[name]["wrapper"].launches = 0
    rv4k = ct.segment_banded(v4k, pv)
    rv1k = ct.segment_banded(v1k, pv)
    rvf = ct.segment_fused(v1k, pv)
    torch.cuda.synchronize()
    for name in COLOR:
        stats[name]["launches"] = KERNELS[name]["wrapper"].launches
    with plain_route():
        pv4k = ct.segment_banded(v4k, pv)
        pv1k = ct.segment_banded(v1k, pv)
        pvf = ct.segment_fused(v1k, pv)
    torch.cuda.synchronize()
    checks = {}
    for tag, res, ref, gt in (("4K RGB", rv4k, pv4k, gtc4k),
                              ("1080p RGB", rv1k, pv1k, gtc1k),
                              ("1080p RGB fused", rvf, pvf, gtc1k)):
        checks[f"{tag} IoU vs truth"] = (iou(res.mask.cpu(), gt), 0.99)
        checks[f"{tag} IoU vs plain route"] = (
            iou(res.mask.cpu(), ref.mask.cpu()), 0.999)
    print(f"phase 4 RGB slice: 4K {rv4k.iters} iters (plain route "
          f"{pv4k.iters}), 1080p {rv1k.iters} (plain {pv1k.iters}), fused "
          f"1080p {rvf.iters} (plain {pvf.iters}); "
          + "; ".join(f"{k} {v:.6f} (>= {m})" for k, (v, m) in
                      checks.items())
          + "; launches " + ", ".join(f"{n.split()[0]}={stats[n]['launches']}"
                                     for n in COLOR), flush=True)
    if not all(r.iters < pv.max_iter for r in (rv4k, rv1k, rvf)):
        raise AssertionError("an RGB run did not converge within max_iter")
    if not (torch.isfinite(rv4k.phi).all() and rv4k.c1.shape == (RGB,)):
        raise AssertionError("non-finite 4K RGB level set or bad means")
    check_masks(checks)
    for name, s in stats.items():
        if s["launches"] < 1:
            raise AssertionError(f"{name} was not launched on the main path")

    # phase 5: steady-state throughput of the 4K fixed-iteration runs
    p = ct.CVParams()
    iters, plain_iters = 800, 40
    for tag, u, route in (("4K", u4k, "K3"), ("4K RGB", v4k, "K6")):
        kern_ms = time_ms(lambda: ct.segment_banded_fixed(u, p, iters=iters),
                          1)
        with plain_route():
            plain_ms = time_ms(
                lambda: ct.segment_banded_fixed(u, p, iters=plain_iters), 1)
        rate = H4K * W4K * iters / (kern_ms * 1e3)
        plain_rate = H4K * W4K * plain_iters / (plain_ms * 1e3)
        print(f"phase 5 throughput: segment_banded_fixed {tag} k=8 packed "
              f"({route}), {iters} iters {kern_ms:.1f} ms = {rate:.1f} "
              f"Mpixel-iters/s; plain route {plain_iters} iters "
              f"{plain_ms:.1f} ms = {plain_rate:.1f} Mpixel-iters/s "
              f"[{card}]", flush=True)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=k["source"],
             replaces=k["replaces"], launches=stats[name]["launches"],
             max_abs_err=stats[name]["max_abs_err"],
             ms=stats[name]["ms"], plain_ms=stats[name]["plain_ms"],
             bound_ms=stats[name]["bound_ms"],
             bound_by=stats[name]["bound_by"], library_ms=None)
        for name, k in KERNELS.items()]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
