// Shared device code of the Hopper red-black kernels: K1 fused.cu (and its
// force mode fused_sweep.cu, and its batch mode over a stack of frames),
// K2 banded.cu, K3 packed.cu on a scalar image and K4 fused_mc.cu, K5
// banded_mc.cu, K6 packed_mc.cu on a C-channel image. One body, eight
// launchers.
//
// What a launch computes: k red-black semi-implicit iterations with the
// region means c1/c2 frozen (k = 1 for the fused kernels), then the
// partials of the LAST iteration's transition, summed over the image:
// [s_uH, s_H, s_dphi2, flips, s_absdphi, 0, 0, 0] for a scalar image,
// [s_uH per channel..., s_H, s_dphi2, flips, s_absdphi, 0...] for a
// C-channel one (C + 4 slots for K4, padded to 16 for K5/K6). This is the
// contract of chan_vese_tpu/ops/pallas_banded.py::_banded_kernel and
// ::_banded_mc_kernel (and, at k = 1, of ops/pallas_sweep.py and
// ops/pallas_sweep_mc.py).
//
// Channels. The template parameter NC is 0 for a scalar image and the
// channel count C (1..8) otherwise; u0 is then channels-first, channel c
// at u0 + c H W in both layouts. Only the data term and the s_uH partials
// see the channels: the level set, the update and the shared-memory
// window stay scalar. NC = 0 keeps the scalar kernels' arithmetic
// (f = -nu - l1 d1^2 + l2 d2^2); NC >= 1 computes the reference mc
// kernels' f = -nu + sum_c (l2[c]/C) d2^2 - (l1[c]/C) d1^2 in their order,
// with the weights l1[c]/C, l2[c]/C precomputed on the host. NC = kForce
// (-1) is the force mode of K1 (fused_sweep.cu, the reference's data_is_f):
// the second input already is the force f, read where the others compute
// the data term; its s_uH slot then sums f H, which carries no meaning.
//
// Tiling. A block owns a TH x TW output tile and loads a window of phi
// clipped to the image and extended by 4k rows/cols up/left and 2k
// rows/cols down/right (the reach of k iterations; the red half-sweep at a
// window edge is wrong because its neighbor read clamps there, and the
// error front moves one cell per half-sweep, so 2k each way would do).
// Neighbor reads clamp at the window bounds: where a bound is an image
// edge that is exact replica-eval Neumann, elsewhere the wrong values stay
// in the halo. Clamped replicas are never stored as cells.
//
// Per chunk the block computes f once into shared memory, then runs
// k x (red, black) half-sweeps there. A half-sweep computes the active
// color's new values into a half-size buffer from the current window,
// then writes them back: the red update reads its diagonal (red)
// neighbors through the backward coefficients, so an in-place update
// would race. Each thread handles one horizontal cell pair, exactly one of
// which is active, so no warp lane idles on color. Window columns start
// at an even global column, which the wrapper guarantees by requiring
// even H and W.
//
// Bound on the card: shared-memory traffic and the rsqrt/divide pipe. Per
// iteration each cell reads its 3x3 neighborhood (8 loads) and evaluates
// 4 rsqrt and 1 divide; device memory is read and written once per chunk
// (12 B/pixel per k iterations for a scalar image, 8 + 4C for C channels,
// plus the halo overlap), so at k = 8 DRAM is far from the limit. The halo
// costs (TH + 6k)(TW + 6k) / (TH TW) of redundant compute (2.4x at k = 8
// with 64 x 128 tiles).
//
// Partials come from owned cells only and compare each cell's value after
// the last iteration with its value before it: the write-back of the last
// iteration sees both; s_uH reads u0 from device memory there. Each block
// writes its sums (f64) to an (nblocks, nsums) scratch; a second
// one-block kernel sums them in a fixed order in f64, so the result is
// deterministic.
//
// Frames (K1's batch mode, fused.cu cv_fused_iteration_batch). A launch
// may carry N independent images of one shape, stacked (N, H, W):
// blockIdx.z is the frame, each frame reads its own means from row z of
// an (N, cc_len) cc and writes its own (nblocks, nsums) block-partials
// rows, and the reduction runs one block per frame into an (N, nout)
// parts. A frame's tiles, sums and summation order are those of the same
// image launched alone, so frame n of a batch is bitwise the single-image
// result. Single-image launches are the case N = 1.
//
// Shard canvases (SHARD = true: K1 shard in fused.cu, K2/K3/K5 shard in
// banded.cu, packed.cu, banded_mc.cu). The image is one shard's halo-padded
// canvas of the spatially sharded solver (parallel/sharded.py), and the
// launch computes the contract of chan_vese_tpu/ops/pallas_banded.py
// ::_banded_kernel's sharded branch with pallas_sweep.py::_resync_rim:
// - parity: canvas cell (i, j) is red iff (i + j + parity) is even, which
//   puts the canvas on the global red-black lattice;
// - crop [r0, r1) x [c0, c1): the shard's own cells. The tiles tile the
//   crop only, and the partials count only its cells; their windows reach
//   4k up/left and 2k down/right into the canvas as in the whole-image
//   mode. Cells outside the crop are copied through from the input;
// - edges (top, bottom, left, right): the sides of the canvas that are
//   global image edges. There the canvas holds clamped replicas of the
//   shard's edge row or column, which the sweeps overwrite; after the
//   write-back of every half-sweep the depth-2 rim is refreshed from the
//   edge cells in shared memory, rows first and then columns (so the
//   corners come out as in _resync_rim), wherever a block's window holds
//   the replica row or column and its source. Depth 2 suffices: a
//   half-sweep reads one cell into the rim.
// Window columns still start on an even canvas column (the start is
// rounded down to an even column, and the width rounded up to even), so
// each thread's cell pair holds one cell of either color.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cv {
// Internal linkage: every .cu that includes this header gets its own copy,
// so the launchers link into one library without clashes.
namespace {

constexpr int kThreads = 512;
constexpr int kMaxChannels = 8;
constexpr int kForce = -1;  // NC of the force mode

struct Params {
  float mu, nu, l1, l2, eta2;  // l1, l2: scalar image only
  float gdt;     // dt * eps / pi, computed on the host in double
  float eps, eps2, inv_pi;
};

// The shard-canvas arguments (SHARD = true; unused otherwise): lattice
// parity, crop [r0, r1) x [c0, c1), and the global-edge flags.
struct Shard {
  int parity, r0, r1, c0, c1;
  int top, bottom, left, right;
};

// s_uH slots, and all partial sums, of a block for channel count NC.
template <int NC>
__host__ __device__ constexpr int uh_slots() { return NC <= 0 ? 1 : NC; }
template <int NC>
__host__ __device__ constexpr int sum_slots() { return uh_slots<NC>() + 4; }
// floats of cc: [c1, c2] for a scalar image (unused in the force mode),
// [c1 x C, c2 x C, l1/C x C, l2/C x C] for C channels
template <int NC>
__host__ __device__ constexpr int cc_len() { return NC <= 0 ? 2 : 4 * NC; }

// Offset of image element (i, j): flat row-major, or parity planes
// P[i & 1][j & 1][i >> 1][j >> 1] of shape (2, 2, H/2, W/2).
template <bool PACKED>
__device__ __forceinline__ int64_t gaddr(int i, int j, int H, int W) {
  if (PACKED) {
    const int64_t hp = H >> 1, wp = W >> 1;
    const int64_t plane = (i & 1) * 2 + (j & 1);
    return (plane * hp + (i >> 1)) * wp + (j >> 1);
  }
  return (int64_t)i * W + j;
}

// The frozen data term at element offset g; chan is H * W, the channel
// stride of a channels-first u0.
template <int NC>
__device__ __forceinline__ float data_term(const float* __restrict__ u0,
                                           int64_t g, int64_t chan,
                                           const float* cc,
                                           const Params& P) {
  if constexpr (NC == kForce) {
    return u0[g];
  } else if constexpr (NC == 0) {
    const float u = u0[g];
    const float d1 = u - cc[0], d2 = u - cc[1];
    return -P.nu - P.l1 * (d1 * d1) + P.l2 * (d2 * d2);
  } else {
    float f = -P.nu;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float u = u0[c * chan + g];
      const float d1 = u - cc[c], d2 = u - cc[NC + c];
      f = f + cc[3 * NC + c] * (d2 * d2) - cc[2 * NC + c] * (d1 * d1);
    }
    return f;
  }
}

__device__ __forceinline__ float face(float mu, float eta2, float a,
                                      float b) {
  return mu * rsqrtf(eta2 + a * a + b * b);
}

// Row-major offset of cell (r, c) in a window of width ww.
struct FlatIdx {
  int ww;
  __device__ __forceinline__ int operator()(int r, int c) const {
    return r * ww + c;
  }
};

// Semi-implicit update of cell (r, c) of an wh x ww grid whose cell
// offsets in s come from idx, with the force at the cell from force(),
// evaluated where the sum needs it (so a shared-memory window's f is
// loaded after the neighbours, as K1-K6 always did). Counterpart of
// chan_vese_tpu/ops/pallas_sweep.py::_update_all: forward coefficients
// A, B at the cell; backward ones A- = A(r-1, c) and B- = B(r, c-1)
// evaluated with clamped reads, which at the grid's first row/col gives
// the replica-eval value (am0/bm0 of the reference). The Dirac factor uses
// the cell's value before the iteration: the active color is still old
// when its half-sweep runs.
template <class Idx, class Force>
__device__ __forceinline__ float update_cell_at(const float* s, Force force,
                                                int r, int c, int wh, int ww,
                                                Idx idx, const Params& P) {
  const int rn = max(r - 1, 0), rs = min(r + 1, wh - 1);
  const int cw = max(c - 1, 0), ce = min(c + 1, ww - 1);
  const float x = s[idx(r, c)];
  const float n = s[idx(rn, c)], so = s[idx(rs, c)];
  const float w = s[idx(r, cw)], e = s[idx(r, ce)];
  const float nw = s[idx(rn, cw)], ne = s[idx(rn, ce)];
  const float sw = s[idx(rs, cw)];
  const float A = face(P.mu, P.eta2, so - x, 0.5f * (e - w));
  const float Am = face(P.mu, P.eta2, x - n, 0.5f * (ne - nw));
  const float B = face(P.mu, P.eta2, 0.5f * (so - n), e - x);
  const float Bm = face(P.mu, P.eta2, 0.5f * (sw - nw), x - w);
  const float g = P.gdt / (P.eps2 + x * x);
  const float num = x + g * (A * so + Am * n + B * e + Bm * w + force());
  const float den = 1.0f + g * (A + Am + B + Bm);
  return num / den;
}

// update_cell_at on a shared-memory window with its force field f.
__device__ __forceinline__ float update_cell(const float* s, const float* f,
                                             int r, int c, int wh, int ww,
                                             const Params& P) {
  return update_cell_at(s, [&] { return f[r * ww + c]; }, r, c, wh, ww,
                        FlatIdx{ww}, P);
}

// Sum v over the block in a fixed order (warp shuffles, then warp 0).
__device__ __forceinline__ double block_sum(double v, double* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    if (lane < (int)(blockDim.x >> 5)) v = scratch[lane];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();
  return v;  // valid in thread 0
}

// Refreshes the depth-2 replica rim of a shard canvas inside the window
// [wr0, wr1) x [wc0, wc0 + ww) held row-major in cur: rows r0-1, r0-2 take
// row r0 (top), rows r1, r1+1 take row r1-1 (bottom), then columns c0-1,
// c0-2 take column c0 (left) and c1, c1+1 take c1-1 (right), each where
// its flag is set and the window holds both the replica and its source.
// The counterpart of chan_vese_tpu/ops/pallas_sweep.py::_resync_rim.
__device__ __forceinline__ void resync_rim(float* cur, int wr0, int wr1,
                                           int wc0, int ww, const Shard& S) {
  const int wh = wr1 - wr0, wc1 = wc0 + ww;
  for (int idx = threadIdx.x; idx < 4 * ww; idx += blockDim.x) {
    const int t = idx / ww, c = idx - t * ww;
    const bool top = t < 2;
    const int dst = top ? S.r0 - 1 - t : S.r1 + t - 2;
    const int src = top ? S.r0 : S.r1 - 1;
    if ((top ? S.top : S.bottom) && dst >= wr0 && dst < wr1 && src >= wr0 &&
        src < wr1)
      cur[(dst - wr0) * ww + c] = cur[(src - wr0) * ww + c];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 4 * wh; idx += blockDim.x) {
    const int t = idx / wh, r = idx - t * wh;
    const bool left = t < 2;
    const int dst = left ? S.c0 - 1 - t : S.c1 + t - 2;
    const int src = left ? S.c0 : S.c1 - 1;
    if ((left ? S.left : S.right) && dst >= wc0 && dst < wc1 && src >= wc0 &&
        src < wc1)
      cur[r * ww + dst - wc0] = cur[r * ww + src - wc0];
  }
  __syncthreads();
}

// cap: window capacity in floats, min(H, TH + 6k) * min(W, TW + 6k)
// (TH + 6k + 2 and TW + 6k + 2 on a shard canvas, whose windows are
// widened to an even start and width).
// Dynamic shared memory: cur[cap] | f[cap] | half[cap / 2] = 10 cap bytes.
template <bool PACKED, int NC, bool SHARD = false>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const float* __restrict__ phi, const float* __restrict__ u0,
             const float* __restrict__ cc, float* __restrict__ out,
             double* __restrict__ block_parts, int H, int W, int k, int TH,
             int TW, int cap, Params P, Shard S) {
  constexpr int kUh = uh_slots<NC>(), kSums = sum_slots<NC>();
  extern __shared__ float smem[];
  __shared__ double red_scratch[kThreads / 32];
  __shared__ float s_cc[cc_len<NC>()];
  float* cur = smem;
  float* f = smem + cap;
  float* half = smem + 2 * cap;

  // the tiled region: the whole image, or a shard canvas's crop
  const int ty0 = SHARD ? S.r0 : 0, ty1 = SHARD ? S.r1 : H;
  const int tx0 = SHARD ? S.c0 : 0, tx1 = SHARD ? S.c1 : W;
  const int par = SHARD ? S.parity : 0;
  const int tr0 = ty0 + blockIdx.y * TH, tc0 = tx0 + blockIdx.x * TW;
  const int tr1 = min(tr0 + TH, ty1), tc1 = min(tc0 + TW, tx1);
  const int wr0 = max(tr0 - 4 * k, 0), wr1 = min(tr1 + 2 * k, H);
  int wc0 = max(tc0 - 4 * k, 0), wc1 = min(tc1 + 2 * k, W);
  if constexpr (SHARD) {  // an even start and width (W is even)
    wc0 &= ~1;
    wc1 += (wc1 - wc0) & 1;
  }
  const int wh = wr1 - wr0, ww = wc1 - wc0, hw = ww >> 1;
  const int64_t chan = (int64_t)H * W;

  // this block's frame (0 unless the launch carries a stack)
  const int64_t frame = blockIdx.z;
  phi += frame * chan;
  out += frame * chan;
  u0 += frame * chan * uh_slots<NC>();
  cc += frame * cc_len<NC>();
  block_parts += frame * gridDim.x * gridDim.y * kSums;

  for (int t = threadIdx.x; t < cc_len<NC>(); t += blockDim.x) s_cc[t] = cc[t];
  __syncthreads();
  for (int idx = threadIdx.x; idx < wh * ww; idx += blockDim.x) {
    const int r = idx / ww, c = idx - r * ww;
    const int64_t g = gaddr<PACKED>(wr0 + r, wc0 + c, H, W);
    cur[idx] = phi[g];
    f[idx] = data_term<NC>(u0, g, chan, s_cc, P);
  }
  __syncthreads();

  double acc[kSums];
#pragma unroll
  for (int t = 0; t < kSums; ++t) acc[t] = 0.0;
  for (int it = 0; it < k; ++it) {
    const bool last = it == k - 1;
    for (int color = 0; color < 2; ++color) {  // 0 = red: (i + j) even
      for (int idx = threadIdx.x; idx < wh * hw; idx += blockDim.x) {
        const int r = idx / hw, q = idx - r * hw;
        const int c = 2 * q + ((wr0 + r + color + par) & 1);
        half[idx] = update_cell(cur, f, r, c, wh, ww, P);
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < wh * hw; idx += blockDim.x) {
        const int r = idx / hw, q = idx - r * hw;
        const int c = 2 * q + ((wr0 + r + color + par) & 1);
        const float nv = half[idx];
        if (last) {
          const int gi = wr0 + r, gj = wc0 + c;
          if (gi >= tr0 && gi < tr1 && gj >= tc0 && gj < tc1) {
            const float old = cur[r * ww + c];
            const float h = 0.5f + P.inv_pi * atanf(nv / P.eps);
            const float d = nv - old;
            const int64_t g = gaddr<PACKED>(gi, gj, H, W);
#pragma unroll
            for (int ch = 0; ch < kUh; ++ch)
              acc[ch] += (double)(u0[ch * chan + g] * h);
            acc[kUh] += (double)h;
            acc[kUh + 1] += (double)(d * d);
            acc[kUh + 2] += ((nv >= 0.0f) != (old >= 0.0f)) ? 1.0 : 0.0;
            acc[kUh + 3] += (double)fabsf(d);
          }
        }
        cur[r * ww + c] = nv;
      }
      __syncthreads();
      if constexpr (SHARD) resync_rim(cur, wr0, wr1, wc0, ww, S);
    }
  }

  for (int idx = threadIdx.x; idx < (tr1 - tr0) * (tc1 - tc0);
       idx += blockDim.x) {
    const int orow = idx / (tc1 - tc0), ocol = idx - orow * (tc1 - tc0);
    const int gi = tr0 + orow, gj = tc0 + ocol;
    out[gaddr<PACKED>(gi, gj, H, W)] = cur[(gi - wr0) * ww + (gj - wc0)];
  }
  if constexpr (SHARD) {
    // the canvas outside the crop passes through: a block on the tile
    // grid's border also copies the rim cells beyond its tile, so the
    // border blocks cover the rim once
    const int er0 = blockIdx.y == 0 ? 0 : tr0;
    const int er1 = blockIdx.y == gridDim.y - 1 ? H : tr1;
    const int ec0 = blockIdx.x == 0 ? 0 : tc0;
    const int ec1 = blockIdx.x == gridDim.x - 1 ? W : tc1;
    const int ew = ec1 - ec0;
    for (int idx = threadIdx.x; idx < (er1 - er0) * ew; idx += blockDim.x) {
      const int gi = er0 + idx / ew, gj = ec0 + idx % ew;
      if (gi < tr0 || gi >= tr1 || gj < tc0 || gj >= tc1) {
        const int64_t g = gaddr<PACKED>(gi, gj, H, W);
        out[g] = phi[g];
      }
    }
  }

  const int64_t bid = blockIdx.y * gridDim.x + blockIdx.x;
#pragma unroll
  for (int t = 0; t < kSums; ++t) {
    const double s = block_sum(acc[t], red_scratch);
    if (threadIdx.x == 0) block_parts[bid * kSums + t] = s;
  }
}

// Sums the (nblocks, nsums) per-block partials in a fixed order in f64
// into parts[nout]; slots from nsums on are 0. One block per frame: block
// z reduces frame z's rows into parts[z * nout ...].
__global__ void __launch_bounds__(256)
reduce_parts_kernel(const double* __restrict__ block_parts, int nblocks,
                    int nsums, int nout, float* __restrict__ parts) {
  __shared__ double s[256];
  block_parts += (int64_t)blockIdx.x * nblocks * nsums;
  parts += (int64_t)blockIdx.x * nout;
  for (int t = 0; t < nout; ++t) {
    double a = 0.0;
    if (t < nsums) {
      for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
        a += block_parts[(int64_t)b * nsums + t];
    }
    s[threadIdx.x] = a;
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
      if ((int)threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
      __syncthreads();
    }
    if (threadIdx.x == 0) parts[t] = (float)s[0];
    __syncthreads();
  }
}

// Host side: launch one chunk plus the partials reduction on `stream`.
// The caller (chan_vese_tpu_torch/ops/_cuda.py) chooses TH, TW and cap and
// allocates out, block_parts ((frames * nblocks, sum_slots<NC>()) f64) and
// parts (frames * nout f32). `frames` images of one shape are stacked in
// phi, u0 and out, with frames rows of means in cc (at most 65535, the
// grid's z limit, which the caller checks).
// On a shard canvas (SHARD) the grid tiles S's crop.
template <bool PACKED, int NC, bool SHARD = false>
cudaError_t launch_chunk(const float* phi, const float* u0, const float* cc,
                         float* out, double* block_parts, float* parts,
                         int H, int W, int k, int TH, int TW, int cap,
                         int nout, Params P, cudaStream_t stream,
                         int frames = 1, Shard S = Shard{}) {
  const size_t smem = (size_t)cap * 10;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_kernel<PACKED, NC, SHARD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int th = SHARD ? S.r1 - S.r0 : H, tw = SHARD ? S.c1 - S.c0 : W;
  const dim3 grid((tw + TW - 1) / TW, (th + TH - 1) / TH, frames);
  chunk_kernel<PACKED, NC, SHARD><<<grid, kThreads, smem, stream>>>(
      phi, u0, cc, out, block_parts, H, W, k, TH, TW, cap, P, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_parts_kernel<<<frames, 256, 0, stream>>>(
      block_parts, (int)(grid.x * grid.y), sum_slots<NC>(), nout, parts);
  return cudaGetLastError();
}

// C-channel image: the runtime channel count C (1..kMaxChannels) picks
// the kernel compiled for it.
template <bool PACKED, int NC = 1, bool SHARD = false>
cudaError_t launch_chunk_mc(const float* phi, const float* u0,
                            const float* cc, float* out, double* block_parts,
                            float* parts, int H, int W, int C, int k, int TH,
                            int TW, int cap, int nout, Params P,
                            cudaStream_t stream, Shard S = Shard{}) {
  if (C == NC)
    return launch_chunk<PACKED, NC, SHARD>(phi, u0, cc, out, block_parts,
                                           parts, H, W, k, TH, TW, cap, nout,
                                           P, stream, 1, S);
  if constexpr (NC < kMaxChannels)
    return launch_chunk_mc<PACKED, NC + 1, SHARD>(
        phi, u0, cc, out, block_parts, parts, H, W, C, k, TH, TW, cap, nout,
        P, stream, S);
  return cudaErrorInvalidValue;
}

// Params of a C-channel launch: the per-channel weights travel in cc.
__host__ inline Params mc_params(float mu, float nu, float eta2, float gdt,
                                 float eps, float eps2, float inv_pi) {
  return Params{mu, nu, 0.0f, 0.0f, eta2, gdt, eps, eps2, inv_pi};
}

}  // namespace
}  // namespace cv
