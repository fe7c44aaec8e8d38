"""Variants of the bit-packed morphological body (K11, K12) timed against it
on one NVIDIA GPU.

    python3 chip_morph_variants.py

The measurements behind PERF.md's account of csrc/morph_bits.cuh: builds
the package's kernels, then compiles variants of the body from modified
copies of csrc/morph_bits.cuh (with morph_band.cu and morph_fused.cu) into
chan_vese_tpu_torch/_build/morph_variants/ and times each in turns with
the package's body (package, variant, variant, package; device time queued
behind a spin), on chip_smoke.py's phase 12 inputs at 4K (3840x2160) and
its phase 21 shard blocks (the 2x2 grid's shard (0, 0)), through the same
C launchers with the package's geometry:

- loads16:   sixteen words in flight a lane in the window load, not eight;
- run8:      a thread's run of rows in an op at least eight rows long;
- threads256: 256-thread blocks, four an SM (the same threads an SM);
- noops:     the body without its elementary ops (the load, the planes
             and the store: the breakdown's skeleton);

and the package's body at other tile heights than its geometry picks
(16, 32, 48, 64, 96 and 128 rows). The exact variants are checked bitwise
against the package's launch. Prints the card's name and power limit.
Exits non-zero without a CUDA device or when a variant fails.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("chip_morph_variants: torch finds no CUDA device")

import chip_smoke as cs  # noqa: E402
from chan_vese_tpu_torch import _build  # noqa: E402
from chan_vese_tpu_torch.ops import _cuda, morph_kernel  # noqa: E402

CSRC = Path(_build.__file__).resolve().parent / "csrc"
OUT = Path(_build.__file__).resolve().parent / "_build" / "morph_variants"
ROWS = (16, 32, 48, 64, 96, 128)

# the body's text the variants change
LOADS = "  constexpr int kU = KIND == kGac ? 4 : 8;"
RUN = "    const int run = max(1, (rows * ww + blockDim.x - 1) / blockDim.x);"
THREADS = "constexpr int kThreads = 512;  // ops/_cuda.py MORPH_THREADS"
BOUNDS = "__global__ void __launch_bounds__(kThreads, 2)"
OPS = "  for (int j = 0; j < A.k; ++j) {"


def variants():
    """{name: ({file name: text}, exact)}: the modified header beside the
    launch sources that include it."""
    base = (CSRC / "morph_bits.cuh").read_text()
    for text in (LOADS, RUN, THREADS, BOUNDS, OPS):
        if text not in base:
            raise RuntimeError(f"csrc/morph_bits.cuh no longer holds "
                               f"{text!r}")
    subs = {
        "loads16": ([(LOADS, LOADS.replace(": 8", ": 16"))], True),
        "run8": ([(RUN, RUN.replace("max(1,", "max(8,"))], True),
        "threads256": ([(THREADS, THREADS.replace("512", "256")),
                        (BOUNDS, BOUNDS.replace(", 2)", ", 4)"))], True),
        "noops": ([(OPS, OPS.replace("j < A.k", "j < 0"))], False),
    }
    out = {}
    for name, (pairs, exact) in subs.items():
        text = base
        for a, b in pairs:
            text = text.replace(a, b)
        files = {"morph_bits.cuh": text}
        for src in ("morph_band.cu", "morph_fused.cu"):
            files[src] = (CSRC / src).read_text()
        out[name] = (files, exact)
    return out


def build(texts):
    """Compiles every variant at once; {name: loaded library}."""
    nvcc = _build.find_nvcc()
    flags = list(_build.NVCC_FLAGS[:_build.NVCC_FLAGS.index("-Xptxas")])
    procs = {}
    for name, (files, _) in texts.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-shared", str(d / "morph_band.cu"),
             str(d / "morph_fused.cu"), "-o", str(d / "lib.so")],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-3000:]}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for sym in ("cv_morph_chunk", "cv_morph_chunk_shard",
                    "cv_morph_fused_chunk"):
            getattr(lib, sym).argtypes = _build.SIGNATURES[sym]
        libs[name] = lib
    return libs


def cases(dev):
    """{tag: (kind, run function of (library, geometry), geometry, the
    morph_geometry arguments)} at the smoke's shapes."""
    p = cs.ct.CVParams()
    inp = cs.morph_inputs(dev, p, cs.H4K, cs.W4K)
    ls, fm, g = cs.morph_shard_inputs(dev, p)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counter = torch.zeros(64, dtype=torch.int32, device=dev)
    out = {}
    for kind in ("acwe", "gac", "gac_pre", "acwe_fused"):
        k, s, p0 = cs.MORPH_RUNS[kind][0][:3]
        b = 1 if kind.startswith("gac") else 0
        halo = morph_kernel._reach(kind, s) * k
        x = inp["ls"]
        aux = {"acwe": inp["f"], "gac": inp["g"], "gac_pre": inp["stacks"][1],
               "acwe_fused": inp["u"]}[kind]
        cc = torch.stack([inp["ci"], inp["co"], inp["l1"], inp["l2"]]
                         ).reshape(4).to(torch.float32).contiguous()
        thr = morph_kernel._thr_b(b, cs.GAC_THRESHOLD)

        def run(lib, geo, kind=kind, x=x, aux=aux, k=k, s=s, p0=p0, b=b,
                halo=halo, cc=cc, thr=thr):
            y = torch.empty_like(x)
            if kind == "acwe_fused":
                bp = torch.empty((geo[-1], 2), dtype=torch.float64,
                                 device=dev)
                parts = torch.empty(2, dtype=torch.float32, device=dev)
                err = lib.cv_morph_fused_chunk(
                    x.data_ptr(), aux.data_ptr(), cc.data_ptr(), y.data_ptr(),
                    bp.data_ptr(), counter.data_ptr(), parts.data_ptr(),
                    *x.shape, k, s, p0, halo, *geo, stream)
            else:
                parts = None
                err = lib.cv_morph_chunk(
                    x.data_ptr(), aux.data_ptr(), y.data_ptr(), *x.shape,
                    _cuda.MORPH_KINDS[kind], k, s, p0, b, thr, halo, *geo,
                    stream)
            if err:
                raise RuntimeError(f"{kind} launch failed ({err})")
            return y, parts
        out[f"{kind} 4K"] = (kind, run, (kind, cs.H4K, cs.W4K, halo))
    for gac in (False, True):
        kind = "gac_pre_sh" if gac else "acwe_sh"
        k = cs.MORPH_SHARD_K
        D = morph_kernel._reach(kind, 1) * k
        (_, x, a, e), = [blk for blk in cs.morph_blocks(
            ls, g if gac else fm, 2, 2, D, dev, gac) if blk[0] == (0, 0)]
        h, w = x.shape
        shard = (D, D, D, D, *(int(v) for v in e))

        def run(lib, geo, kind=kind, x=x, a=a, k=k, D=D, gac=gac,
                shard=shard):
            y = torch.empty_like(x)
            err = lib.cv_morph_chunk_shard(
                x.data_ptr(), a.data_ptr(), y.data_ptr(), *x.shape,
                _cuda.MORPH_KINDS[kind], k, 1, 0, int(gac), 0.0, D, *geo,
                *shard, stream)
            if err:
                raise RuntimeError(f"{kind} launch failed ({err})")
            return y, None
        out[f"{kind} 2x2 block"] = (kind, run,
                                    (kind, h, w, D, (D, h - D, D, w - D)))
    return out


def tiles(rows, args):
    """morph_geometry's answer with its candidate heights cut to one (None
    where that height's window leaves too little shared memory)."""
    saved = _cuda.MORPH_TILE_ROWS
    _cuda.MORPH_TILE_ROWS = (rows,)
    _cuda.morph_geometry.cache_clear()
    try:
        return _cuda.morph_geometry(*args)
    except ValueError:
        return None
    finally:
        _cuda.MORPH_TILE_ROWS = saved
        _cuda.morph_geometry.cache_clear()


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    lib = _build.library()
    texts = variants()
    libs = build(texts)
    dev = torch.device("cuda", 0)
    for tag, (kind, run, args) in cases(dev).items():
        geo = _cuda.morph_geometry(*args)
        package = functools.partial(run, lib, geo)
        ref = package()
        lines = []
        for name, vlib in libs.items():
            variant = functools.partial(run, vlib, geo)
            got = variant()
            torch.cuda.synchronize()
            same = torch.equal(got[0], ref[0]) and (
                got[1] is None or torch.equal(got[1][0], ref[1][0]))
            if texts[name][1] and not same:
                raise AssertionError(f"{name} at {tag}: differs from the "
                                     f"package's launch")
            t = [cs.queued_ms(f, 20) for f in (package, variant, variant,
                                                package)]
            lines.append(f"{name} {(t[1] + t[2]) / 2:.4f} (package "
                         f"{(t[0] + t[3]) / 2:.4f}"
                         + ("; bitwise" if same else "") + ")")
        for rows in ROWS:
            g2 = tiles(rows, args)
            if g2 is None or g2 == geo:
                continue
            other = functools.partial(run, lib, g2)
            got = other()
            torch.cuda.synchronize()
            if not torch.equal(got[0], ref[0]):
                raise AssertionError(f"{tag} at {rows} rows: differs")
            t = [cs.queued_ms(f, 20) for f in (package, other, other,
                                                package)]
            lines.append(f"TH {g2[0]} ({g2[-1]} blocks) {(t[1] + t[2]) / 2:.4f}"
                         f" (package {(t[0] + t[3]) / 2:.4f})")
        print(f"{tag} (tile {geo[0]}x{geo[1]}, {geo[-1]} blocks): queued "
              f"device ms a launch, variant (package in turns): "
              + "; ".join(lines), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
