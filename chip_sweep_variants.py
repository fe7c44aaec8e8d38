"""Variants of K1's single-sweep body timed against it on one NVIDIA GPU.

    python3 chip_sweep_variants.py

The measurements behind PERF.md's account of csrc/sweep.cuh (K1, K4):
builds the package's kernels, then compiles variants of the whole-image
gray instantiation from modified copies of csrc/sweep.cuh into
chan_vese_tpu_torch/_build/variants/ and times each in turns with the
package's body (package, variant, variant, package; device time queued
behind a spin, so the host's pace does not enter), on the same inputs and
through the same host path (direct calls of the variants' C launchers):

- two:       the partials summed by a second launch (one block a frame)
             in place of the last block's sum;
- persist:   a persistent grid (the card's co-resident blocks) that walks
             the tiles and prefetches the next tile's window with
             cp.async into a second buffer while it sweeps the current one;
- breakdown: the body without its partials, without its sweeps, without
             the black half-sweep, and with neither sweeps nor partials
             (the window load, the stores and the sums' skeleton).

at 4K (3840x2160), 16 x 1080p frames and 512^2, with the 44 x 60 tile.
The exact variants (two, persist) are checked bitwise against the
package's launch. Prints the card's name and power limit. Exits non-zero
without a CUDA device or when a variant fails.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("chip_sweep_variants: torch finds no CUDA device")

import chan_vese_tpu_torch as ct  # noqa: E402
from chan_vese_tpu_torch import _build  # noqa: E402
from chan_vese_tpu_torch.ops import _cuda  # noqa: E402
from chan_vese_tpu_torch.utils.init_phi import init_phi  # noqa: E402

CSRC = Path(_build.__file__).resolve().parent / "csrc"
OUT = Path(_build.__file__).resolve().parent / "_build" / "variants"
SHAPES = {"4K": (1, 2160, 3840), "16x1080p": (16, 1080, 1920),
          "512^2": (1, 512, 512)}
SPIN = 40_000_000

# the body's text the variants change
FINISH = '''  sweep_finish<kSums>(block_parts, counters + frame, parts, nblocks, nout,
                      red_scratch);'''
RED = "  band_half_sweep<SHARD, kSweepRows>("
BLACK = "  if (busy) {\n    const SweepCell<NC> cell{"
PARTIALS = ("    for (int o = 0; o < 2; ++o) {\n"
            "      if (!(o ? in1 : in0)) continue;")

# the second launch of `two`: band.cuh's one-pass sum, one block a frame
FRAME_REDUCE = '''
namespace cv {
namespace {
template <int NSUMS>
__global__ void __launch_bounds__(256)
frame_reduce_kernel(const double* __restrict__ block_parts, int nblocks,
                    int nout, float* __restrict__ parts) {
  block_parts += (int64_t)blockIdx.x * nblocks * NSUMS;
  parts += (int64_t)blockIdx.x * nout;
  __shared__ double s[NSUMS][8];
  double a[NSUMS];
#pragma unroll
  for (int t = 0; t < NSUMS; ++t) a[t] = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += 256) {
#pragma unroll
    for (int t = 0; t < NSUMS; ++t)
      a[t] += block_parts[(int64_t)b * NSUMS + t];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < NSUMS; ++t) {
    double v = a[t];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) s[t][warp] = v;
  }
  __syncthreads();
  if ((int)threadIdx.x < nout) {
    double v = 0.0;
    if (threadIdx.x < NSUMS)
      for (int w = 0; w < 8; ++w) v += s[threadIdx.x][w];
    parts[threadIdx.x] = (float)v;
  }
}
}  // namespace
}  // namespace cv
'''

# every variant's C launcher: the package's cv_fused_iteration_batch
# arguments (frames N), then the persistent grid's block count
LAUNCHER = '''#include "%(header)s"
%(extra)s
extern "C" int cv_variant(const float* phi, const float* u0, const float* cc,
    float* out, double* bp, unsigned int* cnt, float* parts, int H, int W,
    int N, int TH, int TW, int PX, int PY, int cap, int nb, float mu,
    float nu, float l1, float l2, float eta2, float gdt, float eps,
    float eps2, float inv_pi, int grid, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  %(body)s
}
extern "C" int cv_variant_occupancy(int threads, int smem, int* blocks) {
  %(occupancy)s
}
'''
SWEEP_BODY = '''int err = cv::launch_sweep<0, false>(phi, u0, cc, out, bp, cnt, parts,
      H, W, N, TH, TW, PX, PY, cap, nb, 8, P, (cudaStream_t)stream,
      cv::Shard{0, 0, H, 0, W, 0, 0, 0, 0});
  if (err) return err;
  %s
  return cudaGetLastError();'''
SWEEP_OCC = "return cv::sweep_occupancy<0, false>(threads, smem, blocks);"

# the persistent prefetching grid: sweep.cuh's cell, strips and finish; a
# tile's window copied pair by pair with cp.async into one of two buffers
PERSIST = r'''
namespace cv {
namespace {
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ BandWin tile_win(int i, int tiles_x, int H, int W,
                                            int TH, int TW) {
  const int by = i / tiles_x, bx = i - by * tiles_x;
  BandWin B;
  B.par = 0;
  B.tr0 = by * TH;
  B.tc0 = bx * TW;
  B.tr1 = min(B.tr0 + TH, H);
  B.tc1 = min(B.tc0 + TW, W);
  B.wr0 = max(B.tr0 - 2, 0);
  const int wr1 = min(B.tr1 + 2, H);
  B.wc0 = max(B.tc0 - 2, 0) & ~1;
  int wc1 = min(B.tc1 + 2, W);
  wc1 += (wc1 - B.wc0) & 1;
  B.wh = wr1 - B.wr0;
  B.ww = wc1 - B.wc0;
  B.hw = B.ww >> 1;
  return B;
}
__device__ __forceinline__ void prefetch(const float* phi, const float* u0,
                                         float* cur, float* upl,
                                         const BandWin& B, int W) {
  for (int idx = threadIdx.x; idx < B.wh * B.hw; idx += blockDim.x) {
    const int r = idx / B.hw, q = idx - r * B.hw;
    const int64_t g = (int64_t)(B.wr0 + r) * W + B.wc0 + 2 * q;
    cp_async8(cur + r * B.ww + 2 * q, phi + g);
    cp_async8(upl + r * B.ww + 2 * q, u0 + g);
  }
}
// dynamic shared memory: two buffers of cur[cap] | upl[cap], then the old
// planes [2][cap / 2]: 20 cap bytes
__global__ void __launch_bounds__(kSweepThreads, 3)
persist_kernel(const float* __restrict__ phi, const float* __restrict__ u0,
               const float* __restrict__ cc, float* __restrict__ out,
               double* __restrict__ block_parts,
               unsigned int* __restrict__ counters, float* __restrict__ parts,
               int frames, int H, int W, int TH, int TW, int PX, int cap,
               Params P) {
  extern __shared__ __align__(16) float ps_smem[];
  __shared__ double red_scratch[5][kBandThreads / 32];
  __shared__ float s_cc[2];
  float* bufs[2] = {ps_smem, ps_smem + 2 * cap};
  float* old = ps_smem + 4 * cap;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = tiles_x * ((H + TH - 1) / TH), total = tiles * frames;
  const int64_t chan = (int64_t)H * W;
  const int q = threadIdx.x % PX;
  const int r0s = (threadIdx.x / PX) * kSweepRows;
  const Shard S{0, 0, H, 0, W, 0, 0, 0, 0};
  int t = blockIdx.x, b = 0;
  if (t < total) {
    const int f = t / tiles;
    prefetch(phi + f * chan, u0 + f * chan, bufs[0], bufs[0] + cap,
             tile_win(t - f * tiles, tiles_x, H, W, TH, TW), W);
  }
  cp_commit();
  for (; t < total; t += gridDim.x, b ^= 1) {
    const int frame = t / tiles;
    const BandWin B = tile_win(t - frame * tiles, tiles_x, H, W, TH, TW);
    const int tn = t + gridDim.x;
    if (tn < total) {
      const int f = tn / tiles;
      prefetch(phi + f * chan, u0 + f * chan, bufs[b ^ 1],
               bufs[b ^ 1] + cap,
               tile_win(tn - f * tiles, tiles_x, H, W, TH, TW), W);
    }
    cp_commit();
    cp_wait<1>();
    if (threadIdx.x < 2) s_cc[threadIdx.x] = cc[frame * 2 + threadIdx.x];
    __syncthreads();
    float* cur = bufs[b];
    float* upl = bufs[b] + cap;
    const bool busy = q < B.hw && r0s < B.wh;
    const int half = B.wh * B.hw;
    band_half_sweep<false, kSweepRows>(
        cur, B, S, 0, busy, false, r0s, q,
        SweepCell<0>{upl, old, s_cc, B.ww, B.hw, q, cap, P}, B.wh);
    float nb[kSweepRows];
    if (busy) {
      const SweepCell<0> cell{upl, old + half, s_cc, B.ww, B.hw, q, cap, P};
      if ((B.wr0 + 1) & 1)
        band_rows<1>(cur, B, r0s, q, cell, nb, B.wh);
      else
        band_rows<0>(cur, B, r0s, q, cell, nb, B.wh);
    }
    double acc[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
    float* o = out + frame * chan;
#pragma unroll
    for (int j = 0; j < kSweepRows; ++j) {
      const int r = r0s + j, gi = B.wr0 + r;
      if (!busy || r >= B.wh || gi < B.tr0 || gi >= B.tr1) continue;
      const int red1 = (B.wr0 + r) & 1;
      const int w = r * B.ww + 2 * q;
      const int gj = B.wc0 + 2 * q;
      const float2 v2 = red1 ? make_float2(nb[j], cur[w + 1])
                             : make_float2(cur[w], nb[j]);
      const int64_t g = (int64_t)gi * W + gj;
      const bool in0 = gj >= B.tc0 && gj < B.tc1;
      const bool in1 = gj + 1 >= B.tc0 && gj + 1 < B.tc1;
      if (in0 && in1)
        *reinterpret_cast<float2*>(o + g) = v2;
      else if (in0)
        o[g] = v2.x;
      else if (in1)
        o[g + 1] = v2.y;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!(e ? in1 : in0)) continue;
        const float v = e ? v2.y : v2.x;
        const float prev = old[(red1 ^ e) * half + r * B.hw + q];
        const float h = 0.5f + P.inv_pi * atanf(v / P.eps);
        const float d = v - prev;
        acc[0] += (double)(upl[w + e] * h);
        acc[1] += (double)h;
        acc[2] += (double)(d * d);
        acc[3] += ((v >= 0.0f) != (prev >= 0.0f)) ? 1.0 : 0.0;
        acc[4] += (double)fabsf(d);
      }
    }
    // the tile's row, frame-major as the package's blocks
    double* rows = block_parts + (int64_t)frame * tiles * 5;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      double v = acc[s];
      for (int of = 16; of > 0; of >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, of);
      if (lane == 0) red_scratch[s][warp] = v;
    }
    __syncthreads();
    if (threadIdx.x < 5) {
      double v = 0.0;
      for (int w2 = 0; w2 < (int)(blockDim.x + 31) / 32; ++w2)
        v += red_scratch[threadIdx.x][w2];
      rows[(int64_t)(t - frame * tiles) * 5 + threadIdx.x] = v;
    }
    sweep_finish<5>(rows, counters + frame, parts + frame * 8, tiles, 8,
                    red_scratch);
    __syncthreads();
  }
  cp_wait<0>();
}
template <class K>
cudaError_t persist_attributes(K kernel) {
  static bool done[kMaxDevices] = {};
  return raise_smem_limit(kernel, done);
}
}  // namespace
}  // namespace cv
'''
PERSIST_BODY = '''cudaError_t err = cv::persist_attributes(cv::persist_kernel);
  if (err) return err;
  cv::persist_kernel<<<grid, (PX * PY + 31) & ~31, (size_t)cap * 20,
                       (cudaStream_t)stream>>>(
      phi, u0, cc, out, bp, cnt, parts, N, H, W, TH, TW, PX, cap, P);
  return cudaGetLastError();'''
PERSIST_OCC = '''cudaError_t err = cv::persist_attributes(cv::persist_kernel);
  if (err) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, cv::persist_kernel, threads, (size_t)smem);'''


def variants():
    """{name: (header text, launcher text, shared bytes a window cell,
    exact)}."""
    base = (CSRC / "sweep.cuh").read_text().replace(
        '#include "band.cuh"', f'#include "{CSRC / "band.cuh"}"')
    for text in (FINISH, RED, BLACK, PARTIALS):
        if text not in base:
            raise RuntimeError(f"csrc/sweep.cuh no longer holds {text!r}")
    cut = {"nopartials": [(PARTIALS, PARTIALS.replace("o < 2", "o < 0"))],
           "nosweeps": [(RED, "  if (false) " + RED.lstrip()),
                        (BLACK, BLACK.replace("if (busy)", "if (false)"))],
           "noblack": [(BLACK, BLACK.replace("if (busy)", "if (false)"))]}
    cut["loadstore"] = cut["nosweeps"] + cut["nopartials"]
    out = {"two": (base.replace(FINISH, "") + FRAME_REDUCE, dict(
        extra="", body=SWEEP_BODY % ("cv::frame_reduce_kernel<5><<<N, 256, "
                                     "0, (cudaStream_t)stream>>>(bp, nb, 8, "
                                     "parts);"), occupancy=SWEEP_OCC), 12,
        True)}
    out["persist"] = (base, dict(extra=PERSIST, body=PERSIST_BODY,
                                 occupancy=PERSIST_OCC), 20, True)
    for name, subs in cut.items():
        text = base
        for a, b in subs:
            text = text.replace(a, b)
        out[name] = (text, dict(extra="", body=SWEEP_BODY % "",
                                occupancy=SWEEP_OCC), 12, False)
    return out


def build(variant_texts):
    """Compiles every variant at once; {name: loaded library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    flags = list(_build.NVCC_FLAGS[:_build.NVCC_FLAGS.index("-Xptxas")])
    procs = {}
    for name, (header, launcher, _, _) in variant_texts.items():
        (OUT / f"{name}.cuh").write_text(header)
        (OUT / f"{name}.cu").write_text(LAUNCHER % dict(
            header=OUT / f"{name}.cuh", **launcher))
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-shared", str(OUT / f"{name}.cu"), "-o",
             str(OUT / f"{name}.so")], stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-3000:]}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.cv_variant.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                                   + [ctypes.c_float] * 9 + [ctypes.c_int,
                                                             ctypes.c_void_p])
        lib.cv_variant_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
        libs[name] = lib
    return libs


def queued_ms(fn, n=20):
    """Mean device time of fn over n calls queued behind a spin kernel."""
    fn()
    torch.cuda.synchronize()
    for shift in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN << shift)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / n
    raise AssertionError("the spin ended before the calls were queued")


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    _build.library()
    texts = variants()
    libs = build(texts)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = ct.CVParams()
    params = (p.mu, p.nu, p.lambda1, p.lambda2, *_cuda._common_params(p))
    gen = torch.Generator().manual_seed(0)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for tag, (n, h, w) in SHAPES.items():
        u = (torch.rand(n, h, w, generator=gen) * 255).to(dev)
        phi = torch.stack([init_phi((h, w), p.init, torch.float32,
                                    device=dev)] * n).contiguous()
        cc = torch.tensor([[160.0, 90.0]] * n, device=dev)
        (th, tw, px, py, cap), nb = _cuda.sweep_plan(h, w)
        threads = -(-px * py // 32) * 32
        counters = torch.zeros(64, dtype=torch.int32, device=dev)

        def call(fn, *extra):
            out = torch.empty_like(phi)
            bp = torch.empty((n * nb, 5), dtype=torch.float64, device=dev)
            parts = torch.empty((n, 8), dtype=torch.float32, device=dev)
            err = fn(phi.data_ptr(), u.data_ptr(), cc.data_ptr(),
                     out.data_ptr(), bp.data_ptr(), counters.data_ptr(),
                     parts.data_ptr(), h, w, n, th, tw, px, py, cap, nb,
                     *params, *extra, stream)
            if err:
                raise RuntimeError(f"launch failed ({err})")
            return out, parts

        def package():  # the package's batch launcher (N = 1: one image)
            return call(lib.cv_fused_iteration_batch)
        ref = package()
        lines = []
        for name, vlib in libs.items():
            occ = ctypes.c_int(0)
            err = vlib.cv_variant_occupancy(threads, texts[name][2] * cap,
                                            ctypes.byref(occ))
            if err or occ.value < 1:
                raise RuntimeError(f"{name}: occupancy query failed ({err})")
            grid = occ.value * sms

            def run(vlib=vlib, grid=grid):
                return call(vlib.cv_variant, grid)
            got = run()
            torch.cuda.synchronize()
            same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            if texts[name][3] and not same:
                raise AssertionError(f"{name} at {tag}: differs from the "
                                     f"package's launch")
            t = [queued_ms(f) for f in (package, run, run, package)]
            lines.append(f"{name} {(t[1] + t[2]) / 2:.4f} (package "
                         f"{(t[0] + t[3]) / 2:.4f}; {occ.value} blocks/SM"
                         + ("; phi and partials bitwise the package's"
                            if same else "") + ")")
        print(f"{tag} ({n} x {h} x {w}, tile {th}x{tw}, {n * nb} tiles): "
              f"queued device ms a launch, variant (package in turns): "
              + "; ".join(lines), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
