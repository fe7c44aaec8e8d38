"""Variants of the resident tile bodies (K7-K10) timed against them on one
NVIDIA GPU.

    python3 chip_resident_variants.py
    python3 chip_resident_variants.py --groups

The measurements behind PERF.md's account of csrc/resident_tiles.cuh and
mp2.cuh's tile body: builds the package's kernels, then compiles variants
of the bodies from modified copies of csrc/resident_tiles.cuh and
csrc/mp2.cuh (with the resident launch sources) into
chan_vese_tpu_torch/_build/resident_variants/ and times each in turns with
the package's body (package, variant, variant, package; CUDA events over
three launches of 1000 iterations), through the package's wrappers and
launch path on chip_smoke.py's inputs at the main path's shapes (K8 256^2
and 1024^2 gray, K8 mc 512^2 RGB, K10 512^2, K9 1024^2):

- nosweep:    the cell update replaced by a copy of the cell (the
              iteration's commits, sums, rims, neighbour waits and
              grid-wide step without the update's arithmetic);
- empty:      nosweep without the commits' Heaviside sums either (the
              loops, the rims, the waits and the grid-wide step: the
              iteration's skeleton);
- gridsync:   a grid.sync() before each neighbour wait (the tagged rim
              words then wait for nothing);
- two_per_sm: two blocks an SM (__launch_bounds__(512, 2), tiles of half
              the size, the geometry's per_sm = 2);
- threads1024: 1024-thread blocks, one an SM (64 registers a thread; the
              geometry gives every thread a cell pair at 1024 a block);
- unroll2:    the half-sweep and commit loops unrolled by two (two cell
              pairs' updates in flight a thread);
- u0_l2:      the package's body with u0 read through L2, not kept in
              shared memory (the geometry's u0res off);
- cluster:    K8 at 256^2 on one thread-block cluster of 16 blocks (64 x
              64 tiles): the rims read from the neighbours' shared memory
              (DSMEM) and three cluster barriers an iteration in place of
              the tagged rim words and the grid-wide step (every block
              adds the blocks' sums in block order).

The exact variants (gridsync, unroll2, u0_l2) are checked bitwise
against the package's launch; the others (two_per_sm, threads1024 and
cluster add the f64 sums in another order, nosweep is not a body) print
their mask IoU (labels agreement) with it over the 1000 iterations.

``--groups`` builds no variant: it times the package's K8 batch launch
(30 iterations, a stack of noisy two-disk frames on parity planes) at
each frame-group count G that keeps u0 in shared memory, against the
count ``_cuda.frame_groups`` picks, in turns (rule, G, G, rule), at 256 x
512^2, 64 x 256^2 and 16 x 1024^2. It prints each G's time, its time a
group step and a frame step, the tile, phi's agreement with G = 1 (bitwise
or the largest difference) and, from all of them, the least-squares fit of
a group step's time to a + b x the tile's cells, whose a / b is
``_cuda.GROUP_STEP_CELLS``. Prints the card's name and power limit. Exits
non-zero without a CUDA device or when a variant fails.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("chip_resident_variants: torch finds no CUDA device")

import chip_smoke as cs  # noqa: E402
from chan_vese_tpu_torch import _build  # noqa: E402
from chan_vese_tpu_torch.ops import _cuda  # noqa: E402
from chan_vese_tpu_torch.ops import packed_kernel as pk  # noqa: E402

CSRC = Path(_build.__file__).resolve().parent / "csrc"
OUT = Path(_build.__file__).resolve().parent / "_build" / "resident_variants"
SOURCES = ("packed_resident.cu", "packed_resident_mc.cu", "mp2_resident.cu",
           "packed_mp2_resident.cu")
ITERS = cs.THROUGHPUT_ITERS
# blocks of the cluster variant (a non-portable cluster size)
CLUSTER = 16
CLUSTER_CU = r'''
// K8 at 256^2 on one thread-block cluster: the tile body's half-sweeps
// and commits, the rims read from the neighbours' shared memory, three
// cluster barriers an iteration.
#include "resident_tiles.cuh"

namespace cv {
namespace {

// another block's padded tile index (Tile's, for block b)
struct TileOf {
  int r0, c0, th, pw;
  __device__ TileOf(int H, int W, int TH, int TW, int GX, int b) {
    const int by = b / GX, bx = b - by * GX;
    r0 = by * TH;
    c0 = bx * TW;
    th = min(r0 + TH, H) - r0;
    pw = (min(c0 + TW, W) - c0 + 2) >> 1;
  }
  __device__ int operator()(int i, int j) const {
    return (((i + j) & 1) * (th + 2) + i - r0 + 1) * pw + ((j - c0 + 1) >> 1);
  }
};

__device__ void ring_dsmem(cg::cluster_group& cl, float* S, const Tile& t,
                           int H, int W, int TH, int TW, int GX, int GY,
                           bool red_only) {
  const int sides = 2 * t.tw + 2 * t.th;
  for (int k = threadIdx.x; k < sides + 3; k += blockDim.x) {
    int i, j, dy, dx;
    if (k < t.tw) {
      i = t.r0 - 1, j = t.c0 + k, dy = -1, dx = 0;
    } else if (k < 2 * t.tw) {
      i = t.r1, j = t.c0 + k - t.tw, dy = 1, dx = 0;
    } else if (k < 2 * t.tw + t.th) {
      i = t.r0 + k - 2 * t.tw, j = t.c0 - 1, dy = 0, dx = -1;
    } else if (k < sides) {
      i = t.r0 + k - 2 * t.tw - t.th, j = t.c1, dy = 0, dx = 1;
    } else if (k == sides) {
      i = t.r0 - 1, j = t.c0 - 1, dy = -1, dx = -1;
    } else if (k == sides + 1) {
      i = t.r0 - 1, j = t.c1, dy = -1, dx = 1;
    } else {
      i = t.r1, j = t.c0 - 1, dy = 1, dx = -1;
    }
    const int ny = t.by + dy, nx = t.bx + dx;
    if (ny < 0 || ny >= GY || nx < 0 || nx >= GX) continue;
    if (red_only && ((dy != 0 && dx != 0) || ((i + j) & 1))) continue;
    const int o = ny * GX + nx;
    const float* R = cl.map_shared_rank(S, o);
    S[t(i, j)] = R[TileOf(H, W, TH, TW, GX, o)(i, j)];
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(kTileThreads, 1)
cluster_kernel(TileResidentArgs a, Params P) {
  constexpr int kM = 2, kS = 5;
  extern __shared__ float smem[];
  __shared__ double s_red[kTileWarps][kS];
  __shared__ double s_post[kS], s_tot[kS], s_carry[kM];
  __shared__ float s_cc[2];
  cg::cluster_group cl = cg::this_cluster();
  const int H = a.H, W = a.W, nb = gridDim.x;
  const Tile t(H, W, a.TH, a.TW, a.GX);
  const int hw = t.tw >> 1, npairs = t.th * hw, cells = t.th * t.tw;
  const Pairs pr(hw);
  const double n_pix = (double)H * W;
  float* S = smem;
  float* N = S + (a.TH + 2) * (a.TW + 2);
  float* U = N + a.TH * a.TW / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double acc[kS];
  // the block's sums [lo, hi) into s_post, a cluster barrier, then every
  // block adds the blocks' posts in block order; the means, block 0's row
  auto step = [&](int lo, int hi, bool row, bool more, int it) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      if (s < lo || s >= hi) continue;
      double x = acc[s];
      for (int o = 16; o > 0; o >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, o);
      if (lane == 0) s_red[warp][s] = x;
    }
    __syncthreads();
    if ((int)threadIdx.x >= lo && (int)threadIdx.x < hi) {
      double x = 0.0;
      for (int w = 0; w < kTileWarps; ++w) x += s_red[w][threadIdx.x];
      s_post[threadIdx.x] = x;
    }
    cl.sync();
    if ((int)threadIdx.x >= lo && (int)threadIdx.x < hi) {
      double x = 0.0;
      for (int b = 0; b < nb; ++b)
        x += cl.map_shared_rank(s_post, b)[threadIdx.x];
      s_tot[threadIdx.x] = x;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      if (row && blockIdx.x == 0) {
        float* dst = a.parts + (int64_t)(it / a.unroll) * a.nrow;
        dst[0] = (float)s_carry[0];
        dst[1] = (float)s_carry[1];
        for (int s = kM; s < kS; ++s) dst[s] = (float)s_tot[s];
        for (int s = kS; s < a.nrow; ++s) dst[s] = 0.0f;
      }
      if (more) {
        s_cc[0] = (float)(s_tot[0] / fmax(s_tot[1], 1e-30));
        s_cc[1] = (float)((a.usum[0] - s_tot[0]) /
                          fmax(n_pix - s_tot[1], 1e-30));
        s_carry[0] = s_tot[0];
        s_carry[1] = s_tot[1];
      }
    }
    if (more) ring_dsmem(cl, S, t, H, W, a.TH, a.TW, a.GX, a.GY, false);
    cl.sync();
  };

#pragma unroll
  for (int s = 0; s < kS; ++s) acc[s] = 0.0;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    const int i = t.r0 + k / t.tw, j = t.c0 + k % t.tw;
    const int64_t g = gaddr<PACKED>(i, j, H, W);
    const float v = a.phi_in[g];
    S[t(i, j)] = v;
    U[t.u(i, j)] = a.u0[g];
    const float h = 0.5f + P.inv_pi * atanf(v / P.eps);
    acc[0] += (double)(a.u0[g] * h);
    acc[1] += (double)h;
  }
  cl.sync();  // every tile loaded before any ring reads it
  step(0, kM, false, true, 0);

  for (int it = 0; it < a.iters; ++it) {
    const bool row = it % a.unroll == a.unroll - 1;
    const bool more = it + 1 < a.iters;
#pragma unroll
    for (int s = 0; s < kS; ++s) acc[s] = 0.0;
    for (int color = 0; color < 2; ++color) {
      for (int k = threadIdx.x, lr = pr.lr0, q = pr.q0; k < npairs;
           k += blockDim.x, pr.next(lr, q)) {
        const int i = t.r0 + lr, j = t.c0 + 2 * q + ((i + color) & 1);
        const float fv = data_term<0>(U, t.u(i, j), cells, s_cc, P);
        N[k] = update_cell_at(S, [fv] { return fv; }, i, j, H, W, t, P);
      }
      __syncthreads();
      for (int k = threadIdx.x, lr = pr.lr0, q = pr.q0; k < npairs;
           k += blockDim.x, pr.next(lr, q)) {
        const int i = t.r0 + lr, j = t.c0 + 2 * q + ((i + color) & 1);
        float* s = S + t(i, j);
        const float old = *s, nv = N[k];
        *s = nv;
        if (row) {
          const float d = nv - old;
          acc[kM] += (double)(d * d);
          acc[kM + 1] += ((nv >= 0.0f) != (old >= 0.0f)) ? 1.0 : 0.0;
          acc[kM + 2] += (double)fabsf(d);
        }
        if (more) {
          const float h = 0.5f + P.inv_pi * atanf(nv / P.eps);
          acc[0] += (double)(U[t.u(i, j)] * h);
          acc[1] += (double)h;
        }
      }
      if (color == 0) {
        cl.sync();
        ring_dsmem(cl, S, t, H, W, a.TH, a.TW, a.GX, a.GY, true);
        __syncthreads();
      }
    }
    if (row || more) step(more ? 0 : kM, row ? kS : kM, row, more, it);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    const int i = t.r0 + k / t.tw, j = t.c0 + k % t.tw;
    a.out[gaddr<PACKED>(i, j, H, W)] = S[t(i, j)];
  }
}

}  // namespace
}  // namespace cv

extern "C" cudaError_t cv_packed_resident_iterations(CV_TILE_RESIDENT_ARGS) {
  if (N != 1 || C != 0 || nblocks > %(CLUSTER)d ||
      smem != cv::tile_smem_bytes(TH, TW, 1, 1, u0res) || !u0res)
    return cudaErrorInvalidValue;
  const cv::TileResidentArgs a{phi_in, out, u0, usum, wts, scratch,
                               (cv::Word*)rims, sync, parts, N, H, W,
                               iters, unroll, batch, nrow, TH, TW, GX,
                               nblocks / GX, u0res};
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  auto kernel = cv::cluster_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks);
  cfg.blockDim = dim3(cv::kTileThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nblocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, P);
}

extern "C" cudaError_t cv_packed_resident_iterations_grid(int C, int smem,
                                                          int* max_blocks) {
  *max_blocks = %(CLUSTER)d;
  return cudaSuccess;
}
'''.replace("%(CLUSTER)d", str(CLUSTER))

# the bodies' text the variants change
UPDATE = re.compile(r"update_cell_at\((S\d?), \[f\w*\] \{ return f\w*; \}, "
                    r"i, (j\w*), H, W, t, P\)")
BOUNDS = "__global__ void __launch_bounds__(kTileThreads, 1)"
THREADS = "constexpr int kTileThreads = 512;  // ops/_cuda.py TILE_THREADS"
WAIT = ("        if (color == 0) {  // the sides' new red cells for the "
        "black sweep\n")
WAIT0 = "    fill_ring(S0, rims(0, par), t, a.TH, a.TW, a.GX, a.GY, true, next);"
WAIT1 = "    fill_ring(S1, rims(1, par), t, a.TH, a.TW, a.GX, a.GY, true, next);"
SYNC = "  cg::this_grid().sync();\n"
LOOP = "for (int k = threadIdx.x, lr = pr.lr0, q = pr.q0; k < npairs;"
HSUMS = ("if (more) hsums(", "if (more) add_phase_sums(")


def variants():
    """{name: dict(files, sources, per_sm, threads, sms, only)}: the
    modified headers beside the launch sources that include them (the
    cluster variant: its own source), the geometry's blocks an SM, threads
    a block and SM count, and the one case a variant runs on (None: all)."""
    tiles = (CSRC / "resident_tiles.cuh").read_text()
    mp2 = (CSRC / "mp2.cuh").read_text()
    for text, where in ((BOUNDS, tiles),
                        (BOUNDS, mp2), (WAIT, tiles), (THREADS, tiles),
                        (WAIT0, mp2), (WAIT1, mp2)):
        if text not in where:
            raise RuntimeError(f"the tile bodies no longer hold {text!r}")
    subs = {
        "nosweep": ([(UPDATE, r"\1[t(i, \2)]")], 1, 512),
        "empty": ([(UPDATE, r"\1[t(i, \2)]")]
                  + [(h, h.replace("more", "false")) for h in HSUMS], 1, 512),
        "gridsync": ([(WAIT, WAIT + "      " + SYNC),
                      (WAIT0, "  " + SYNC + WAIT0),
                      (WAIT1, "  " + SYNC + WAIT1)], 1, 512),
        "two_per_sm": ([(BOUNDS, BOUNDS.replace(", 1)", ", 2)"))], 2, 512),
        "threads1024": ([(THREADS, THREADS.replace("512", "1024"))], 1,
                        1024),
        "unroll2": ([(LOOP, "_Pragma(\"unroll 2\") " + LOOP)], 1, 512),
        "cluster": ([], 1, 512),
    }
    out = {}
    for name, (pairs, per_sm, threads) in subs.items():
        files = {"resident_tiles.cuh": tiles, "mp2.cuh": mp2}
        for a, b in pairs:
            files = {f: (a.sub(b, t) if isinstance(a, re.Pattern)
                         else t.replace(a, b)) for f, t in files.items()}
        files["redblack.cuh"] = (CSRC / "redblack.cuh").read_text()
        sources = SOURCES
        if name == "cluster":
            files["cluster.cu"] = CLUSTER_CU
            sources = ("cluster.cu",)
        else:
            for src in SOURCES:
                files[src] = (CSRC / src).read_text()
        out[name] = dict(files=files, sources=sources, per_sm=per_sm,
                         threads=threads,
                         sms=CLUSTER if name == "cluster" else _cuda.SMS,
                         only="K8 256^2" if name == "cluster" else None)
    return out


def build(texts):
    """Compiles every variant at once; {name: loaded library}. Prints the
    tile kernels' registers and spills from ptxas's report."""
    nvcc = _build.find_nvcc()
    flags = list(_build.NVCC_FLAGS)
    procs = {}
    for name, v in texts.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in v["files"].items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-shared", *(str(d / s) for s in v["sources"]),
             "-o", str(d / "lib.so")], stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-3000:]}")
        regs, tile, spill = [], False, ""
        for line in err.splitlines():
            if "entry function" in line:
                tile = "tile" in line or "cluster" in line
            elif tile and "spill stores" in line:
                spill = line.split(",")[1].strip()
            elif tile and "Used" in line:
                regs.append(line.split("Used ")[1].split(",")[0] + ", "
                            + spill)
        print(f"{name} ptxas (tile kernels): {'; '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for sym, types in _build.SIGNATURES.items():
            if hasattr(lib, sym) and "resident" in sym:
                getattr(lib, sym).argtypes = types
                getattr(lib, sym).restype = ctypes.c_int
        libs[name] = lib
    return libs


class Library:
    """A variant's resident launchers, the package's library for the
    rest (the error strings)."""

    def __init__(self, variant, package):
        self.variant, self.package = variant, package

    def __getattr__(self, name):
        if "resident" in name and hasattr(self.variant, name):
            return getattr(self.variant, name)
        return getattr(self.package, name)


@contextlib.contextmanager
def using(lib=None, per_sm=1, u0res=True, threads=512, sms=_cuda.SMS):
    """The package's wrappers on a variant library, with the geometry's
    blocks an SM, threads a block, SM count and u0 residency."""
    saved = (_build.library, _cuda.resident_tile_geometry,
             _cuda.TILE_THREADS)
    _cuda.frame_groups.cache_clear()
    package = saved[0]()

    def geometry(h, w, c=0, levels=1, _sms=None):
        th, tw, gx, gy, res, smem = saved[1](h, w, c, levels, sms, per_sm)
        if res and not u0res:
            res, smem = False, _cuda.tile_smem_bytes(th, tw, c, levels,
                                                     False)
        return th, tw, gx, gy, res, smem

    if lib is not None:
        _build.library = lambda: Library(lib, package)
    _cuda.resident_tile_geometry = geometry
    _cuda.TILE_THREADS = threads
    saved[1].cache_clear()
    _cuda.resident_capacity.cache_clear()
    try:
        yield
    finally:
        (_build.library, _cuda.resident_tile_geometry,
         _cuda.TILE_THREADS) = saved
        saved[1].cache_clear()
        _cuda.resident_capacity.cache_clear()
        _cuda.frame_groups.cache_clear()


def cases(dev):
    """{tag: (a run of ITERS iterations returning (level sets, rows),
    multiphase)} at the main path's shapes."""
    p = cs.ct.CVParams()
    pm = cs.ct.CVParams(mu=cs.MU_MP, max_iter=500)
    out = {}
    for tag, (h, w), name in (("K8 256^2", (256, 256),
                               "K8 packed_resident_iterations"),
                              ("K8 1024^2", (1024, 1024),
                               "K8 packed_resident_iterations"),
                              ("K8 mc 512^2 RGB", (512, 512),
                               "K8 packed_resident_iterations_mc")):
        r = cs.RESIDENT[name]
        u0 = torch.from_numpy(cs.two_disks(h, w)[0]).to(dev)
        ucf = (torch.from_numpy(cs.colored_squares(h, w)[0]).to(dev)
               .permute(2, 0, 1).contiguous())
        phi = cs.init_phi((h, w), "checkerboard", torch.float32, device=dev)
        args = cs.resident_inputs(r, phi, u0, ucf, None)
        out[tag] = ((lambda r=r, args=args: r["wrapper"](*args, p, ITERS)),
                    False)
    for tag, (h, w), name in (("K10 512^2", (512, 512),
                               "K10 packed_mp2_resident_iterations"),
                              ("K9 1024^2", (1024, 1024),
                               "K9 mp2_resident_iterations")):
        u, phis, _, _ = cs.mp2_inputs(h, w, dev, pm)
        fn = cs.MP2[name]["wrapper"]
        out[tag] = ((lambda fn=fn, phis=phis, u=u: fn(phis, u, pm, ITERS)),
                    True)
    return out


def agree(a, b, multi):
    if multi:
        return 1.0 - cs.label_frac(a, b)
    return cs.iou((a >= 0).cpu(), (b >= 0).cpu())


# --groups: the stacks (frames, h, w) and the iterations of a launch
GROUP_STACKS = ((256, 512, 512), (64, 256, 256), (16, 1024, 1024))
GROUP_ITERS = 30


@contextlib.contextmanager
def forced_groups(g):
    """The package's launches with G frame groups (None: the rule's)."""
    saved = _cuda.frame_groups
    if g is not None:
        _cuda.frame_groups = lambda n, h, w, c=0, sms=_cuda.SMS: (
            g, _cuda.resident_tile_geometry(h, w, c, 1, sms // g))
    try:
        yield
    finally:
        _cuda.frame_groups = saved


def u0_resident(h, w, blocks):
    """Whether (h, w)'s tiles over ``blocks`` blocks keep u0 in shared
    memory (False where not even the level set fits)."""
    try:
        return _cuda.resident_tile_geometry(h, w, 0, 1, blocks)[4]
    except ValueError:
        return False


def groups_main(card) -> int:
    dev = torch.device("cuda", 0)
    p = cs.ct.CVParams()
    sms = _cuda._sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    fits = []
    for n, h, w in GROUP_STACKS:
        base = torch.from_numpy(cs.two_disks(h, w)[0]).to(dev)
        u0 = (base + 8.0 * torch.randn((n, h, w), generator=gen,
                                       device=dev)).contiguous()
        phi = cs.init_phi((h, w), "checkerboard", torch.float32,
                          device=dev).expand(n, h, w).contiguous()
        pu, pphi = pk.pack_planes(u0), pk.pack_planes(phi)

        def run():
            return _cuda.launch_resident(
                "cv_packed_resident_iterations", pphi, pu, p, GROUP_ITERS, 1,
                h, w, frames=n, batch=True)

        rule = _cuda.frame_groups(n, h, w, 0, sms)[0]
        with forced_groups(1):
            ref = run()
        counts = [g for g in range(1, min(n, sms) + 1)
                  if g == 1 or u0_resident(h, w, sms // g)]
        lines = []
        for g in counts:
            with forced_groups(g):
                got = run()
            torch.cuda.synchronize()
            diff = float((got[0] - ref[0]).abs().max())
            t = []
            for forced in (False, True, True, False):
                with forced_groups(g if forced else None):
                    t.append(cs.time_ms(run, 3))
            ms, rule_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            th, tw, gx, gy = _cuda.resident_tile_geometry(
                h, w, 0, 1, sms // g)[:4]
            steps = -(-n // g) * (GROUP_ITERS + 1)
            fits.append((th * tw, ms * 1e3 / steps))
            lines.append(
                f"G {g} B {gx * gy} ({th}x{tw} tiles): {ms:.3f} ms "
                f"(rule {rule_ms:.3f}), {ms * 1e3 / steps:.2f} us a group "
                f"step, {ms * 1e3 / (n * (GROUP_ITERS + 1)):.3f} us a frame "
                f"step; phi " + ("bitwise G 1" if diff == 0.0 else
                                 f"max |diff| {diff:.3g} from G 1"))
        print(f"K8 batch {n} x {h}x{w}, {GROUP_ITERS} iterations (rule: G "
              f"{rule}): " + "; ".join(lines), flush=True)
    x = torch.tensor([c for c, _ in fits], dtype=torch.float64)
    y = torch.tensor([t for _, t in fits], dtype=torch.float64)
    a_mat = torch.stack([torch.ones_like(x), x], 1)
    a, b = torch.linalg.lstsq(a_mat, y[:, None]).solution[:, 0].tolist()
    print(f"fit: a group step {a:.3f} us + {b * 1e3:.4f} ns a tile cell "
          f"(a / b = {a / b:.0f} cells)")
    print(f"card: {card}")
    return 0


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    if "--groups" in sys.argv[1:]:
        return groups_main(card)
    texts = variants()
    libs = build(texts)
    dev = torch.device("cuda", 0)
    setups = {name: (libs[name], dict(per_sm=v["per_sm"],
                                      threads=v["threads"], sms=v["sms"]),
                      v["only"]) for name, v in texts.items()}
    setups["u0_l2"] = (None, dict(u0res=False), None)
    for tag, (run, multi) in cases(dev).items():
        ref = run()
        torch.cuda.synchronize()
        lines = []
        for name, (lib, kw, only) in setups.items():
            if only not in (None, tag):
                continue
            with using(lib, **kw):
                got = run()
                torch.cuda.synchronize()
            same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            if name in ("gridsync", "unroll2", "u0_l2") and not same:
                raise AssertionError(f"{name} at {tag}: differs from the "
                                     f"package's launch")
            close = agree(got[0], ref[0], multi)
            t = []
            for variant in (False, True, True, False):
                with (using(lib, **kw) if variant
                      else contextlib.nullcontext()):
                    t.append(cs.time_ms(run, 3))
            new, pkg = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            lines.append(f"{name} {new:.3f} ms ({new / ITERS * 1e3:.2f} us "
                         f"an iteration; package {pkg:.3f}; "
                         + ("bitwise" if same else
                            f"{'labels agree' if multi else 'mask IoU'} "
                            f"{close:.4f}") + ")")
        print(f"{tag}, {ITERS} iterations a launch: variant (package in "
              f"turns): " + "; ".join(lines), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
