"""Pass depths and tiles of R1's tile body timed on one NVIDIA GPU.

    python3 chip_reinit_variants.py [--out FILE]

The measurements behind ``_cuda.reinit_geometry`` and the tile body's
design (csrc/reinit.cu reinit_tile): builds the package's kernels, prints
ptxas's registers and spills of the tile body, then for each shape the
main path redistances (the 4K pyramid's five level shapes, f32, and 4K
f64) times the geometry's own choice and every pass depth of
REINIT_DEPTHS under a set of block shapes (PX columns, PY strips of RS
rows; device time queued behind a spin, so the host's pace does not
enter), with the blocks an SM the card gives each. Then it
compiles variants of the body from modified copies of csrc/reinit.cu into
chan_vese_tpu_torch/_build/reinit_variants/ (each its own library with
the same C launcher) and times the best geometries of each at 4K f32 and
f64, 1080p and 135x240:

- registers:     the first form of the tile body (REGISTERS below): a
                 thread's strip of at most 16 rows keeps its prepass
                 values and flags in registers and computes a step into
                 registers between two barriers, one shared plane of psi,
                 the loops unrolled over the strip; registers_rows8 and
                 registers_rows4 the same with strips of at most 8 and 4
                 rows;
- batched:       the steps 4 rows at a time (their loads, then their
                 updates, then their stores: the stores may alias later
                 loads for all the compiler knows), not a row at a time;
- border_inline: the border copies made by every edge cell's thread in
                 the step loop (four predicated stores a cell), not after
                 it by the edge threads;
- rolled_loads:  a pass's window loaded a row at a time, each global load
                 waited for before the next, not a strip's rows at once;
- sign_branch:   the sign of phi0 picking maxima or minima of the
                 differences (two predicated forms) in place of the
                 differences times sign(phi0);
- old_godunov:   the Godunov gradient as the plain version spells it (both
                 branches' clamps and NaN-checked maxima of the squares);
- one_block:     __launch_bounds__ asking for one block an SM in f32;

and, timed only (their results differ), a breakdown of the body:
fast_sqrt (the square root an rsqrt and a product), no_update (a step a
sum of the stencil's loads) and no_sync (the steps without barriers).

Every timed geometry of every exact variant is checked bitwise against
the plain version (``ops/reinit.py::reinit_reference``) on the same
input. Prints a table a shape, the card's name
and power limit, and writes every number to ``--out`` (default
chiprun_out/reinit_variants.json). Exits non-zero without a CUDA device
or when a geometry disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_reinit_variants: torch finds no CUDA device")

from chan_vese_tpu_torch import _build  # noqa: E402
from chan_vese_tpu_torch.ops import _cuda  # noqa: E402
from chan_vese_tpu_torch.ops.reinit import reinit_reference  # noqa: E402

STEPS = 20
SHAPES = [((1, 2160, 3840), torch.float32), ((1, 2160, 3840), torch.float64),
          ((1, 1080, 1920), torch.float32), ((1, 540, 960), torch.float32),
          ((1, 270, 480), torch.float32), ((1, 135, 240), torch.float32)]
# (PX, PY, RS): window columns, strips, rows a strip (the geometry's own
# candidates)
BLOCKS = _cuda.REINIT_BLOCKS
SPIN = 20_000_000
CSRC = Path(_build.__file__).resolve().parent / "csrc"
OUT = Path(_build.__file__).resolve().parent / "_build" / "reinit_variants"
# the NaN-keeping helpers of the registers and old_godunov variants
# (torch.maximum, torch.clamp(min=0) and torch.clamp(max=0))
NAN_HELPERS = r'''template <typename T>
__device__ __forceinline__ bool isnan_(T x) {
  return x != x;
}

template <typename T>
__device__ __forceinline__ T nmax(T x, T y) {
  return isnan_(x) ? x : (isnan_(y) ? y : (x > y ? x : y));
}

template <typename T>
__device__ __forceinline__ T pos(T x) {
  return x < T(0) ? T(0) : x;
}

template <typename T>
__device__ __forceinline__ T neg(T x) {
  return x > T(0) ? T(0) : x;
}

'''
# the first form of the tile body, in place of the package's section from
# TILE_START to TILE_END: registers for the strip's prepass values, flags
# and new values, one shared plane of psi
TILE_START = "constexpr int kTileThreads = 512;  // most threads a block"
TILE_END = "// reinit_tile<T>'s dynamic shared-memory limit"
REGISTERS = NAN_HELPERS + r'''constexpr int kTileThreads = 512;  // most threads a block
constexpr int kTileRows = 16;      // most rows of a thread's strip
constexpr int kMaxDevices = 64;

// blocks an SM that __launch_bounds__ asks registers for: 64 a thread in
// f32, 128 in f64
template <typename T>
struct TileBlocks {
  static constexpr int value = sizeof(T) == 4 ? 2 : 1;
};

// one step of a cell off or on the crossing (the plain version's
// expressions)
template <typename T>
__device__ __forceinline__ T tile_update(T c, T up, T dn, T lf, T rt, T v,
                                         bool positive, bool crossing,
                                         T dtau, T dth) {
  using O = R<T>;
  if (crossing) {
    const T s = positive ? T(1) : T(-1);
    return O::sub(c, O::mul(dth, O::sub(O::mul(s, fabs(c)), v)));
  }
  const T a = positive ? O::sub(c, up) : O::sub(up, c);
  const T b = positive ? O::sub(dn, c) : O::sub(c, dn);
  const T cc = positive ? O::sub(c, lf) : O::sub(lf, c);
  const T d = positive ? O::sub(rt, c) : O::sub(c, rt);
  const T g = O::sqrt(O::add(nmax(sq(pos(a)), sq(neg(b))),
                             nmax(sq(pos(cc)), sq(neg(d)))));
  return O::sub(c, O::mul(O::mul(dtau, v), O::sub(g, T(1))));
}

// One pass of `steps` steps (at most `halo`) on the tile (blockIdx.y,
// blockIdx.x) of frame blockIdx.z: phi0 gives the prepass, src the pass's
// starting psi (phi0 itself on the first pass), dst the tile's result.
// Thread t: window column t % PX, strip rows (t / PX) RS .. + RS - 1.
template <typename T>
__global__ void __launch_bounds__(kTileThreads, TileBlocks<T>::value)
reinit_tile(const T* __restrict__ phi0, const T* __restrict__ src,
            T* __restrict__ dst, int H, int W, int halo, int steps, int TH,
            int TW, int PX, int RS, T dtau, T dth, T h, T hh, T lo, T hi) {
  using O = R<T>;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* sp = reinterpret_cast<T*>(tile_smem);
  const int tr0 = blockIdx.y * TH, tc0 = blockIdx.x * TW;
  const int tr1 = min(tr0 + TH, H), tc1 = min(tc0 + TW, W);
  const int wr0 = max(tr0 - halo, 0), wr1 = min(tr1 + halo, H);
  const int wc0 = max(tc0 - halo, 0), wc1 = min(tc1 + halo, W);
  const int wh = wr1 - wr0, ww = wc1 - wc0;
  const int q = threadIdx.x % PX, r0 = (threadIdx.x / PX) * RS;
  const int nr = max(0, min(RS, wh - r0));  // strip rows in the window
  const bool col = q < ww;
  const int ql = max(q - 1, 0), qr = min(q + 1, ww - 1);
  const int64_t at0 = (int64_t)blockIdx.z * H * W + (int64_t)wr0 * W + wc0;

  if (col) {
#pragma unroll
    for (int s = 0; s < kTileRows; ++s)
      if (s < nr) sp[(r0 + s) * ww + q] = __ldg(phi0 + at0 +
                                                (int64_t)(r0 + s) * W + q);
  }
  __syncthreads();

  // the prepass, on phi0's window
  T aux[kTileRows];
  uint32_t posm = 0, crossm = 0;
  if (col) {
#pragma unroll
    for (int s = 0; s < kTileRows; ++s) {
      if (s >= nr) continue;
      const int r = r0 + s;
      const T c = sp[r * ww + q], up = sp[max(r - 1, 0) * ww + q],
              dn = sp[min(r + 1, wh - 1) * ww + q], lf = sp[r * ww + ql],
              rt = sp[r * ww + qr];
      const T gx = O::mul(T(0.5), O::sub(dn, up));
      const T gy = O::mul(T(0.5), O::sub(rt, lf));
      const T gn2 = O::add(O::mul(gx, gx), O::mul(gy, gy));
      const bool crosses = O::mul(c, up) < T(0) || O::mul(c, dn) < T(0) ||
                           O::mul(c, lf) < T(0) || O::mul(c, rt) < T(0);
      T v;
      if (crosses) {
        T m = O::sqrt(gn2);
        m = m < T(1e-12) ? T(1e-12) : m;
        v = O::div(O::mul(h, c), m);
        v = v < lo ? lo : (v > hi ? hi : v);
      } else {
        v = O::div(c, O::sqrt(O::add(O::add(O::mul(c, c), O::mul(gn2, hh)),
                                     T(1e-30))));
      }
      aux[s] = v;
      posm |= (c > T(0) ? 1u : 0u) << s;
      crossm |= (crosses ? 1u : 0u) << s;
    }
  }
  if (src != phi0) {  // a later pass starts from the previous pass's psi
    __syncthreads();
    if (col) {
#pragma unroll
      for (int s = 0; s < kTileRows; ++s)
        if (s < nr) sp[(r0 + s) * ww + q] = __ldg(src + at0 +
                                                  (int64_t)(r0 + s) * W + q);
    }
    __syncthreads();
  }

  // the steps: step n computes the cells n or more from a cut side
  const bool top = wr0 > 0, bottom = wr1 < H, left = wc0 > 0, right = wc1 < W;
  T nw[kTileRows];
  int rlo = 0, rhi = 0;
  bool act = false;
  for (int n = 1;; ++n) {
    rlo = max(r0, top ? n : 0);
    rhi = min(r0 + nr, bottom ? wh - n : wh);
    act = col && q >= (left ? n : 0) && q < (right ? ww - n : ww);
    if (act && rlo < rhi) {
      T up = sp[max(rlo - 1, 0) * ww + q], c = sp[rlo * ww + q];
#pragma unroll
      for (int s = 0; s < kTileRows; ++s) {
        const int r = r0 + s;
        if (r < rlo || r >= rhi) continue;
        const T dn = sp[min(r + 1, wh - 1) * ww + q];
        nw[s] = tile_update(c, up, dn, sp[r * ww + ql], sp[r * ww + qr],
                            aux[s], (posm >> s) & 1u, (crossm >> s) & 1u,
                            dtau, dth);
        up = c;
        c = dn;
      }
    }
    if (n == steps) break;
    __syncthreads();
    if (act) {
#pragma unroll
      for (int s = 0; s < kTileRows; ++s) {
        const int r = r0 + s;
        if (r >= rlo && r < rhi) sp[r * ww + q] = nw[s];
      }
    }
    __syncthreads();
  }

  // the tile's cells, all computed by the last step, from registers
  const int sr0 = tr0 - wr0, sr1 = tr1 - wr0;
  if (act && q >= tc0 - wc0 && q < tc1 - wc0) {
#pragma unroll
    for (int s = 0; s < kTileRows; ++s) {
      const int r = r0 + s;
      if (r >= sr0 && r < sr1 && r >= rlo && r < rhi)
        dst[at0 + (int64_t)r * W + q] = nw[s];
    }
  }
}

'''
SMEM_PLANES = """  return (size_t)(std::min(TH + 2 * k, H) + 2) *
         (size_t)(std::min(TW + 2 * k, W) + 2) * 3 * sizeof(T);"""
ROWS = "constexpr int kTileRows = 16;      // most rows of a thread's strip"
TO_REGISTERS = [
    (SMEM_PLANES, """  return (size_t)std::min(TH + 2 * k, H) *
         (size_t)std::min(TW + 2 * k, W) * sizeof(T);"""),
    ("RS > kStripRows", "RS > kTileRows")]
OLD_GODUNOV = """  const T x = max_nan(max_nan(O::mul(s, a), O::mul(s, e)), T(0));
  const T y = max_nan(max_nan(O::mul(s, l), O::mul(s, r)), T(0));
  const T g = O::sqrt(O::add(sq(x), sq(y)));"""
# the sign of phi0 as a branch of maxima and minima (predicated both ways)
MIN_NAN = """__device__ __forceinline__ float min_nan(float x, float y) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}
__device__ __forceinline__ double min_nan(double x, double y) {
  return (x != x || x < y) ? x : y;
}
"""
SELECTED = """  T x, y;
  if (f & 1) {
    x = max_nan(max_nan(a, e), T(0));
    y = max_nan(max_nan(l, r), T(0));
  } else {
    x = min_nan(min_nan(a, e), T(0));
    y = min_nan(min_nan(l, r), T(0));
  }
  const T g = O::sqrt(O::add(sq(x), sq(y)));"""
TILE_UPDATE = "// One step of a cell: the plain version's step, bitwise."
# the package's step loop, a row at a time, and the same loop 4 rows
# at a time (their loads, then their updates, then their stores)
ONE_ROW = """        for (int r = rlo; r < rhi; ++r, i += stride, m >>= 2) {
          const T dn = cur[i + stride];
          nxt[i] = tile_update(c, up, dn, cur[i - 1], cur[i + 1], aux[i],
                               (uint8_t)(m & 3u), dtau, dth);
          up = c;
          c = dn;
        }
"""
BATCHED = """        for (int r = rlo; r < rhi; r += 4, i += 4 * stride, m >>= 8) {
          T dn[4], lf[4], rt[4], v[4], out[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = i + min(b, rhi - 1 - r) * stride;
            dn[b] = cur[j + stride];
            lf[b] = cur[j - 1];
            rt[b] = cur[j + 1];
            v[b] = aux[j];
          }
#pragma unroll
          for (int b = 0; b < 4; ++b)
            out[b] = tile_update(b == 0 ? c : dn[b - 1],
                                 b == 0 ? up : (b == 1 ? c : dn[b - 2]),
                                 dn[b], lf[b], rt[b], v[b],
                                 (uint8_t)((m >> (2 * b)) & 3u), dtau, dth);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (r + b < rhi) nxt[i + b * stride] = out[b];
          up = dn[2];
          c = dn[3];
        }
        i = at + (rhi - r0) * stride;
"""
# the border copies made in the step loop, by every cell's thread, in
# place of the package's copies after it
UPDATE = """          nxt[i] = tile_update(c, up, dn, cur[i - 1], cur[i + 1], aux[i],
                               (uint8_t)(m & 3u), dtau, dth);
"""
UPDATE_INLINE = """          const T v = tile_update(c, up, dn, cur[i - 1], cur[i + 1], aux[i],
                                  (uint8_t)(m & 3u), dtau, dth);
          nxt[i] = v;
          if (r == 0) nxt[i - stride] = v;
          if (r == wh - 1) nxt[i + stride] = v;
          if (first_col) nxt[i - 1] = v;
          if (last_col) nxt[i + 1] = v;
"""
BORDER = """        const int i0 = at + (rlo - r0) * stride;
        if (first_col && !left)
          for (int j = i0; j < i; j += stride) nxt[j - 1] = nxt[j];
        if (last_col && !right)
          for (int j = i0; j < i; j += stride) nxt[j + 1] = nxt[j];
        if (rlo == 0) nxt[i0 - stride] = nxt[i0];
        if (rhi == wh) nxt[i] = nxt[i - stride];
"""
# the package's loads of a pass's window (every row of a strip in flight,
# phi0's and the last pass's psi together) and a rolled loop of phi0's
# rows, each load waited for before the next (psi's loaded after the
# prepass the same way)
FETCH = """  T start[kStripRows], later[kStripRows];
  fetch(phi0, start);
  if (src != phi0) fetch(src, later);
  place(start);
  __syncthreads();
"""
ROLLED = """  T start[kStripRows], later[kStripRows];
  if (col)
    for (int r = r0; r < r1; ++r) {
      const int i = at + (r - r0) * stride;
      const T v = __ldg(phi0 + at0 + (int64_t)r * W + q);
      cur[i] = v;
      if (r == 0) cur[i - stride] = v;
      if (r == wh - 1) cur[i + stride] = v;
      if (first_col) cur[i - 1] = v;
      if (last_col) cur[i + 1] = v;
    }
  __syncthreads();
"""
LATER = """    __syncthreads();
    place(later);
  }"""
ROLLED_LATER = """    __syncthreads();
    if (col)
      for (int r = r0; r < r1; ++r) {
        const int i = at + (r - r0) * stride;
        const T v = __ldg(src + at0 + (int64_t)r * W + q);
        cur[i] = v;
        if (r == 0) cur[i - stride] = v;
        if (r == wh - 1) cur[i + stride] = v;
        if (first_col) cur[i - 1] = v;
        if (last_col) cur[i + 1] = v;
      }
  }"""
VARIANTS = {
    "registers": TO_REGISTERS,
    "registers_rows8": TO_REGISTERS + [(ROWS, ROWS.replace("16;", "8;"))],
    "registers_rows4": TO_REGISTERS + [(ROWS, ROWS.replace("16;", "4;"))],
    "batched": [(ONE_ROW, BATCHED)],
    "border_inline": [(UPDATE, UPDATE_INLINE), (BORDER, "")],
    "rolled_loads": [(FETCH, ROLLED), (LATER, ROLLED_LATER)],
    "old_godunov": [(TILE_UPDATE, NAN_HELPERS + TILE_UPDATE),
                    (OLD_GODUNOV, """  const T b = O::sub(dn, c), d = O::sub(rt, c);
  T g;
  if (f & 1)
    g = O::sqrt(O::add(nmax(sq(pos(a)), sq(neg(b))),
                       nmax(sq(pos(l)), sq(neg(d)))));
  else
    g = O::sqrt(O::add(nmax(sq(neg(a)), sq(pos(b))),
                       nmax(sq(neg(l)), sq(pos(d)))));""")],
    "sign_branch": [(TILE_UPDATE, MIN_NAN + TILE_UPDATE),
                    (OLD_GODUNOV, SELECTED)],
    "one_block": [("static constexpr int value = sizeof(T) == 4 ? 2 : 1;",
                   "static constexpr int value = 1;")],
    # the breakdown: inexact, timed only
    "fast_sqrt": [("    return __fsqrt_rn(a);",
                   "    return __fmul_rn(a, rsqrtf(a));")],
    "no_update": [("                                         uint8_t f, T "
                   "dtau, T dth) {\n  using O = R<T>;\n",
                   "                                         uint8_t f, T "
                   "dtau, T dth) {\n  using O = R<T>;\n  return O::add("
                   "O::add(c, O::add(up, dn)), O::add(O::add(lf, rt), v));"
                   "\n")],
    "no_sync": [("    nxt = t;\n    __syncthreads();\n", "    nxt = t;\n")],
}
INEXACT = {"fast_sqrt", "no_update", "no_sync"}
# the registers variants' most rows a strip
VARIANT_ROWS = {"registers_rows8": 8, "registers_rows4": 4}


def window_bytes(name, h, w, geo, itemsize):
    """Shared memory of a variant's window at ``geo``."""
    k, th, tw = geo[:3]
    if name.startswith("registers"):
        return min(th + 2 * k, h) * min(tw + 2 * k, w) * itemsize
    return _cuda.reinit_smem(h, w, k, th, tw, itemsize)


VARIANT_SHAPES = [((1, 2160, 3840), torch.float32),
                  ((1, 2160, 3840), torch.float64),
                  ((1, 1080, 1920), torch.float32),
                  ((1, 135, 240), torch.float32)]


def level_sets(shape, dtype, dev, seed=0):
    """Steep two-disk distance functions (slope 40, as a converged coarse
    level set upsampled), noise, exact zeros on a row."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    i, j = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for m in range(b):
        d1 = 0.15 * min(h, w) - np.hypot(i - (0.3 + 0.05 * m) * h, j - 0.3 * w)
        d2 = 0.2 * min(h, w) - np.hypot(i - 0.68 * h, j - 0.65 * w)
        phi = 40.0 * np.maximum(d1, d2) + rng.standard_normal((h, w))
        phi[h // 3, : w // 4] = 0.0
        out.append(phi)
    x = torch.from_numpy(np.stack(out)).to(dev, dtype)
    return x if b > 1 else x[0]


def queued_ms(fn, n):
    """Mean device time of fn over n calls queued behind a spin."""
    fn()
    torch.cuda.synchronize()
    for spin in (SPIN << s for s in range(5)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / n
    raise AssertionError("queued_ms: the calls outlasted every spin")


def geometries(b, h, w, itemsize):
    """The geometry's choice first, then every depth under every block
    shape that fits the image."""
    out = [_cuda.reinit_geometry(b, h, w, STEPS, itemsize)]
    for k in _cuda.REINIT_DEPTHS:
        k = min(k, STEPS)
        for px, py, rs in BLOCKS:
            th = h if h <= py * rs else py * rs - 2 * k
            tw = w if w <= px else px - 2 * k
            if th < 1 or tw < 1:
                continue
            smem = _cuda.reinit_smem(h, w, k, th, tw, itemsize)
            if smem > _cuda.SMEM_LIMIT:
                continue
            g = (k, th, tw, px, py, rs)
            if g not in out:
                out.append(g)
    return out


def build_variant(name):
    """(library, ptxas text) of reinit.cu with VARIANTS[name] applied."""
    text = (CSRC / "reinit.cu").read_text()
    if name.startswith("registers"):
        a, b = text.index(TILE_START), text.index(TILE_END)
        text = text[:a] + REGISTERS + text[b:]
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"variant {name}: text not found: {old!r}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.cv_reinit.argtypes = _build.SIGNATURES["cv_reinit"]
    dll.cv_reinit.restype = ctypes.c_int
    return dll, proc.stderr


def variant_ptxas(text):
    """{'f32': {regs, spill stores, stack frame bytes}, 'f64': ...} of
    reinit_tile in a ptxas report."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            k = re.search(r"reinit_tileI([fd])E", m.group(1))
            name = ("f32" if k.group(1) == "f" else "f64") if k else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            out.setdefault(name, {}).update(stack=int(m.group(1)),
                                            spill=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["regs"] = int(m.group(1))
    return out


def launch_variant(dll, x, geo):
    """One redistance of ``x`` (20 steps) on a variant's library at
    ``geo``, as _cuda.launch_reinit launches the package's."""
    b, h, w = (1, *x.shape) if x.ndim == 2 else x.shape
    bufs = (torch.empty_like(x), torch.empty_like(x))
    err = dll.cv_reinit(x.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
                        b, h, w, STEPS, *geo, 0.5, 1.0,
                        int(x.dtype == torch.float64),
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed ({err}) at {geo}")
    return bufs[(len(_cuda.reinit_passes(STEPS, geo[0])) - 1) % 2]


def variants(record, card, only=None):
    """Each variant's best geometries against the package's body, in turns
    at VARIANT_SHAPES. Returns whether every launch agreed."""
    ok = True
    dev = torch.device("cuda", 0)
    best = {(tuple(r["shape"]), r["dtype"]): sorted(
        r["rows"], key=lambda row: row["ms"])[:6] for r in record["shapes"]}
    record["variants"] = {}
    for name in only or VARIANTS:
        dll, text = build_variant(name)
        regs = variant_ptxas(text)
        print(f"variant {name} ptxas: {regs}", flush=True)
        rows = []
        for shape, dtype in VARIANT_SHAPES:
            x = level_sets(shape, dtype, dev)
            b, h, w = shape
            ref = reinit_reference(x, STEPS)
            size = x.element_size()
            cands = [g for g in geometries(b, h, w, size)
                     if g[5] <= VARIANT_ROWS.get(name, _cuda.REINIT_ROWS)
                     and window_bytes(name, h, w, g, size)
                     <= _cuda.SMEM_LIMIT]
            top = [tuple(r["geometry"]) for r in
                   best[(shape, str(dtype)[6:])]]
            first = [g for g in cands if g in top]
            cands = first + [g for g in cands if g not in top][
                :max(0, 6 - len(first))]
            for geo in cands:
                got = launch_variant(dll, x, geo)
                same = torch.equal(got, ref)
                ok &= same or name in INEXACT
                turns = [queued_ms(fn, 10) for fn in (
                    lambda: _cuda.launch_reinit(x, STEPS, 0.5, 1.0,
                                                geometry=geo),
                    lambda: launch_variant(dll, x, geo))]
                rows.append(dict(shape=shape, dtype=str(dtype)[6:],
                                 geometry=geo, package_ms=turns[0],
                                 ms=turns[1], bitwise=same))
            mine = sorted((r for r in rows if r["shape"] == shape
                           and r["dtype"] == str(dtype)[6:]),
                          key=lambda r: r["ms"])
            print(f"variant {name} {'x'.join(map(str, shape))} "
                  f"{str(dtype)[6:]}: " + ", ".join(
                      f"{r['geometry']} {r['ms']:.4f} (package "
                      f"{r['package_ms']:.4f})" for r in mine[:4])
                  + f" [{card}]", flush=True)
        record["variants"][name] = dict(ptxas=regs, rows=rows)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/reinit_variants.json")
    ap.add_argument("--no-variants", action="store_true",
                    help="time the package's body only")
    ap.add_argument("--sass", help="write the tile body's SASS here")
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS),
                    help="the variants to build (default every one)")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    regs = variant_ptxas(_build.ptxas_report())
    if args.sass:
        tool = "/usr/local/cuda/bin/cuobjdump"
        text = subprocess.run([tool, "-sass", str(_build.build())],
                              capture_output=True, text=True).stdout
        keep = [f for f in text.split("\n\t\tFunction : ")
                if "reinit_tile" in f.split("\n")[0]]
        Path(args.sass).parent.mkdir(parents=True, exist_ok=True)
        Path(args.sass).write_text("\n\n".join(keep))
    print(f"reinit_tile ptxas: {regs}", flush=True)
    record = {"card": card, "ptxas": regs, "shapes": []}
    failed = False
    for shape, dtype in SHAPES:
        b, h, w = shape
        x = level_sets(shape, dtype, dev)
        itemsize = x.element_size()
        ref = reinit_reference(x, STEPS)
        rows = []
        for geo in geometries(b, h, w, itemsize):
            got = _cuda.launch_reinit(x, STEPS, 0.5, 1.0, geometry=geo)
            same = torch.equal(got, ref)
            failed |= not same
            ms = queued_ms(lambda: _cuda.launch_reinit(
                x, STEPS, 0.5, 1.0, geometry=geo), 10)
            k, th, tw, px, py, rs = geo
            smem = _cuda.reinit_smem(h, w, k, th, tw, itemsize)
            bps = _cuda.reinit_occupancy(px * py, smem,
                                         dtype == torch.float64)
            rows.append(dict(geometry=geo, ms=ms, bitwise=same,
                             blocks_per_sm=bps,
                             passes=len(_cuda.reinit_passes(STEPS, k))))
        chosen = rows[0]
        ranked = sorted(rows, key=lambda r: r["ms"])
        tag = f"{'x'.join(map(str, shape))} {str(dtype)[6:]}"
        print(f"{tag}: geometry's choice "
              f"{chosen['geometry']} {chosen['ms']:.4f} ms (rank "
              f"{ranked.index(chosen) + 1} of {len(rows)}); fastest "
              + ", ".join(f"{r['geometry']} {r['ms']:.4f} ({r['passes']} "
                          f"passes, {r['blocks_per_sm']}/SM)"
                          for r in ranked[:6])
              + f" [{card}]", flush=True)
        record["shapes"].append(dict(shape=shape, dtype=str(dtype)[6:],
                                     rows=rows))
    if not args.no_variants:
        failed |= not variants(record, card, args.only)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(record, indent=1))
    print(f"{card}", flush=True)
    if failed:
        print("a geometry disagreed with the plain version", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
