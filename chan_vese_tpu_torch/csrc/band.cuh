// The banded chunk body of K2 (banded.cu, NC = 0) and K5 (banded_mc.cu,
// NC = C), in their whole-image and shard-canvas modes (SHARD), and of K3
// (packed.cu, both modes) and K6 (packed_mc.cu) on parity planes
// (PACKED). It computes what redblack.cuh's chunk_kernel computes for
// those kernels: k red-black iterations with c1/c2 frozen, the shard
// canvas's lattice parity, crop, edge flags and depth-2 rim refresh after
// every half-sweep, the canvas outside the crop copied through, and the
// partials of the last iteration in the same slots, summed in f64 in a
// fixed order. Every cell goes through redblack.cuh's update_cell_at and
// the same Heaviside and partials expressions, so the level set comes out
// bitwise equal to chunk_kernel's. Replaces, like chunk_kernel did,
// chan_vese_tpu/ops/pallas_banded.py::_banded_kernel (:104, _fusej :230,
// the sharded branch of banded_chunk_sharded :399), _banded_mc_kernel
// (:507, _fusej :625, banded_chunk_mc :776, banded_chunk_mc_sharded :800),
// and chan_vese_tpu/ops/pallas_packed.py::_packed_banded_kernel (:528,
// _fusej :670, packed_banded_chunk_sharded :857 with _packed_rim :276) and
// _packed_banded_mc_kernel (:965, _fusej :1089).
//
// The layout enters only the three passes over device memory: the window
// load, the stores with the partials, and the shard canvas's copy-through.
// Element (i, j) lives at redblack.cuh's gaddr<PACKED>(i, j, H, W): flat
// row-major, or planes P[i & 1][j & 1][i >> 1][j >> 1]. The window in
// shared memory is flat in both, so the sweeps, the rim refresh, the
// reduction and the tile choice are the flat kernel's, and a packed launch
// equals pack(flat launch(unpack(x))) bitwise, partials included. The
// window's column start is even, so the pair (2q, 2q + 1) of row i is one
// cell of plane (i & 1, 0) and one of plane (i & 1, 1) at the same offset:
// two 4-byte loads, each consecutive across a warp's q.
//
// Bound on the card: the update's arithmetic (4 rsqrt and a divide on the
// MUFU pipe, ~55 FP32 operations) over every window cell, not DRAM (12
// B/pixel per k iterations for a gray image). What the design does about
// it, against chunk_kernel:
// - A symmetric 2k halo. The wrong values that the clamped reads at a
//   window edge make move one cell per half-sweep (an update reads its
//   3x3 neighbourhood), so after the 2k half-sweeps of a chunk they reach
//   2k - 1 cells in, and a window that is the tile plus 2k each way (cut
//   at the image) computes every tile cell exactly. On a shard canvas the
//   rim refreshed from the crop's edge cells stops them at a flagged side.
//   tests/test_torch_band_tiling.py holds a plain windowed twin of this
//   tiling bitwise equal to the whole-image plain run.
// - No half buffer. Thread t owns column pair q = t % PX (window columns
//   2q, 2q + 1) over a strip of kBandRows rows starting at row
//   (t / PX) kBandRows; in every row exactly one of its two cells has the
//   active colour. A half-sweep computes the strip's new values into
//   registers, waits at a barrier until every thread has read the old
//   window, writes them back and waits again. The strip start is even, so
//   the colour pattern down the strip is the same in every thread of a
//   block: one branch a half-sweep picks the unrolled body for it, and the
//   sweep loops hold no division and no modulo.
// - Fewer shared loads. Walking down its strip, a thread keeps three rows
//   of its four columns (2q - 1 .. 2q + 2, clamped at the window) in
//   registers and loads one new row a step (an 8-byte pair and two
//   words), plus the cell's force from a colour-split plane (f of colour
//   c at [c][r][q], consecutive across a warp). The 3x3 neighbourhood is
//   handed to update_cell_at as a 3 x 3 register grid.
// - Shared memory is phi and f, 8 B a window cell (10 before), and the
//   tile and thread count are chosen on the host
//   (chan_vese_tpu_torch/ops/_cuda.py::band_geometry) so that two or more
//   blocks fit on an SM at the main path's shapes.
// - On a shard canvas only the blocks whose window holds a replica row or
//   column and its source run the rim refresh (a test uniform across the
//   block); the others skip its two barriers.
// - One block reduction for all partial slots (one barrier), and the
//   shared-memory attribute set once per instantiation and device.

#pragma once

#include "redblack.cuh"

namespace cv {
namespace {

constexpr int kBandThreads = 512;  // most threads a block (16 warps)
constexpr int kBandRows = 12;      // rows of a thread's strip (even)
constexpr int kMaxDevices = 64;

// Window columns 2q - 1 .. 2q + 2 of one row, clamped at the window's
// sides (columns 0 and ww - 1), as update_cell_at's clamped reads see them.
struct Quad {
  float l, a, b, r;
};

__device__ __forceinline__ Quad load_quad(const float* cur, int r, int q,
                                          int ww) {
  const float* row = cur + r * ww + 2 * q;
  const float2 ab = *reinterpret_cast<const float2*>(row);
  Quad v;
  v.a = ab.x;
  v.b = ab.y;
  v.l = q > 0 ? row[-1] : ab.x;
  v.r = 2 * q + 2 < ww ? row[2] : ab.y;
  return v;
}

// Reads (r, c) of a 3 x 3 register grid held row-major.
struct Grid3 {
  __device__ __forceinline__ int operator()(int r, int c) const {
    return r * 3 + c;
  }
};

// The block's window and tile, shared by every phase of the kernel.
struct BandWin {
  int wr0, wh, wc0, ww, hw;  // window origin and size, hw = ww / 2 pairs
  int tr0, tr1, tc0, tc1;    // the tile (owned cells)
  int par;                   // lattice parity (0 on a whole image)
};

// One half-sweep's update of a thread's strip rows [r0s, r0s + ROWS) of
// pair q: the active colour's new values into nv, each from
// cell(r, odd, g9) with the cell's 3 x 3 neighbourhood g9 (band_kernel's
// BandCell; K9's band body in mp2_band.cu has its own). ODD0 is the active
// cell's column offset (0: 2q, 1: 2q + 1) in the strip's first row; it
// alternates down the strip.
template <int ODD0, int ROWS, class Cell>
__device__ __forceinline__ void band_rows(const float* cur, const BandWin& B,
                                          int r0s, int q, const Cell& cell,
                                          float (&nv)[ROWS]) {
  Quad n = load_quad(cur, max(r0s - 1, 0), q, B.ww);
  Quad x = load_quad(cur, r0s, q, B.ww);
  Quad s = load_quad(cur, min(r0s + 1, B.wh - 1), q, B.ww);
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = r0s + j;
    if (r < B.wh) {
      const bool odd = ((ODD0 + j) & 1) != 0;  // folded once unrolled
      const float g9[9] = {odd ? n.a : n.l, odd ? n.b : n.a, odd ? n.r : n.b,
                           odd ? x.a : x.l, odd ? x.b : x.a, odd ? x.r : x.b,
                           odd ? s.a : s.l, odd ? s.b : s.a, odd ? s.r : s.b};
      nv[j] = cell(r, odd, g9);
      n = x;
      x = s;
      s = load_quad(cur, min(r + 2, B.wh - 1), q, B.ww);
    }
  }
}

// band_kernel's cell: the force from the colour's plane fc; in the last
// iteration (`last`) the cell's old value takes its place there, which no
// later half-sweep reads: the partials pass finds it there.
struct BandCell {
  float* fc;
  int hw, q;
  bool last;
  const Params& P;
  __device__ __forceinline__ float operator()(int r, bool,
                                              const float (&g9)[9]) const {
    const float fv = fc[r * hw + q];
    const float v =
        update_cell_at(g9, [&] { return fv; }, 1, 1, 3, 3, Grid3{}, P);
    if (last) fc[r * hw + q] = g9[4];
    return v;
  }
};

// Writes a strip's new values back (ODD0 as band_rows).
template <int ODD0, int ROWS>
__device__ __forceinline__ void band_store(float* cur, const BandWin& B,
                                           int r0s, int q,
                                           const float (&nv)[ROWS]) {
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = r0s + j;
    if (r < B.wh) cur[r * B.ww + 2 * q + ((ODD0 + j) & 1)] = nv[j];
  }
}

// The depth-2 rim refresh of redblack.cuh::resync_rim, rows then columns,
// in a block that holds a replica and its source (the caller's test).
__device__ __forceinline__ void band_rim(float* cur, const BandWin& B,
                                         const Shard& S) {
  const int wr1 = B.wr0 + B.wh, wc1 = B.wc0 + B.ww;
  for (int c = threadIdx.x; c < B.ww; c += blockDim.x) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool top = t < 2;
      const int dst = top ? S.r0 - 1 - t : S.r1 + t - 2;
      const int src = top ? S.r0 : S.r1 - 1;
      if ((top ? S.top : S.bottom) && dst >= B.wr0 && dst < wr1 &&
          src >= B.wr0 && src < wr1)
        cur[(dst - B.wr0) * B.ww + c] = cur[(src - B.wr0) * B.ww + c];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < B.wh; r += blockDim.x) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool left = t < 2;
      const int dst = left ? S.c0 - 1 - t : S.c1 + t - 2;
      const int src = left ? S.c0 : S.c1 - 1;
      if ((left ? S.left : S.right) && dst >= B.wc0 && dst < wc1 &&
          src >= B.wc0 && src < wc1)
        cur[r * B.ww + dst - B.wc0] = cur[r * B.ww + src - B.wc0];
    }
  }
  __syncthreads();
}

// Whether the window holds a replica row or column of a flagged side and
// its source (uniform across the block).
__device__ __forceinline__ bool band_needs_rim(const BandWin& B,
                                               const Shard& S) {
  const int wr1 = B.wr0 + B.wh, wc1 = B.wc0 + B.ww;
  const bool top = S.top && S.r0 - 1 >= B.wr0 && S.r0 < wr1;
  const bool bottom = S.bottom && S.r1 < wr1 && S.r1 - 1 >= B.wr0;
  const bool left = S.left && S.c0 - 1 >= B.wc0 && S.c0 < wc1;
  const bool right = S.right && S.c1 < wc1 && S.c1 - 1 >= B.wc0;
  return top || bottom || left || right;
}

// One half-sweep of colour `color` over strips of ROWS rows, each cell
// updated by cell (as band_rows): compute into registers, barrier, write
// back, barrier, and on a shard canvas the rim refresh where the window
// needs it.
template <bool SHARD, int ROWS, class Cell>
__device__ __forceinline__ void band_half_sweep(float* cur, const BandWin& B,
                                                const Shard& S, int color,
                                                bool busy, bool rim, int r0s,
                                                int q, const Cell& cell) {
  float nv[ROWS];
  // r0s is even, so the strip's first row has the block's colour offset
  const bool odd0 = ((B.wr0 + color + B.par) & 1) != 0;
  if (busy) {
    if (odd0)
      band_rows<1>(cur, B, r0s, q, cell, nv);
    else
      band_rows<0>(cur, B, r0s, q, cell, nv);
  }
  __syncthreads();
  if (busy) {
    if (odd0)
      band_store<1>(cur, B, r0s, q, nv);
    else
      band_store<0>(cur, B, r0s, q, nv);
  }
  __syncthreads();
  if constexpr (SHARD) {
    if (rim) band_rim(cur, B, S);
  }
}

// Every slot of acc reduced over the block at once: warp shuffles, one
// barrier, then thread t sums slot t over the warps in order into
// block_parts[block id][t].
template <int NSUMS>
__device__ __forceinline__ void band_block_sums(
    const double (&acc)[NSUMS], double (&scratch)[NSUMS][kBandThreads / 32],
    double* block_parts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < NSUMS; ++t) {
    double v = acc[t];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) scratch[t][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < NSUMS) {
    const int nwarps = (blockDim.x + 31) >> 5;
    double v = 0.0;
    for (int w = 0; w < nwarps; ++w) v += scratch[threadIdx.x][w];
    const int64_t bid = blockIdx.y * gridDim.x + blockIdx.x;
    block_parts[bid * NSUMS + threadIdx.x] = v;
  }
}

// Dynamic shared memory: cur[cap] | f planes [2][cap / 2] = 8 cap bytes,
// cap >= wh * ww of every block's window. PX * PY <= kBandThreads with
// PX >= ww / 2 and PY kBandRows >= wh; blockDim.x is PX * PY rounded up
// to whole warps. phi, u0 (each channel) and out hold the image flat or as
// parity planes (PACKED).
template <int NC, bool SHARD, bool PACKED>
__global__ void __launch_bounds__(kBandThreads, 2)
band_kernel(const float* __restrict__ phi, const float* __restrict__ u0,
            const float* __restrict__ cc, float* __restrict__ out,
            double* __restrict__ block_parts, int H, int W, int k, int TH,
            int TW, int PX, int cap, Params P, Shard S) {
  constexpr int kUh = uh_slots<NC>(), kSums = sum_slots<NC>();
  extern __shared__ __align__(16) float band_smem[];
  __shared__ double red_scratch[kSums][kBandThreads / 32];
  __shared__ float s_cc[cc_len<NC>()];
  float* cur = band_smem;
  float* fpl = band_smem + cap;

  // the tiled region: the whole image, or a shard canvas's crop
  const int ty0 = SHARD ? S.r0 : 0, ty1 = SHARD ? S.r1 : H;
  const int tx0 = SHARD ? S.c0 : 0, tx1 = SHARD ? S.c1 : W;
  BandWin B;
  B.par = SHARD ? S.parity : 0;
  B.tr0 = ty0 + blockIdx.y * TH;
  B.tc0 = tx0 + blockIdx.x * TW;
  B.tr1 = min(B.tr0 + TH, ty1);
  B.tc1 = min(B.tc0 + TW, tx1);
  B.wr0 = max(B.tr0 - 2 * k, 0);
  const int wr1 = min(B.tr1 + 2 * k, H);
  // an even start (the pairs' colour pattern) and width (W is even)
  B.wc0 = max(B.tc0 - 2 * k, 0) & ~1;
  int wc1 = min(B.tc1 + 2 * k, W);
  wc1 += (wc1 - B.wc0) & 1;
  B.wh = wr1 - B.wr0;
  B.ww = wc1 - B.wc0;
  B.hw = B.ww >> 1;
  const int64_t chan = (int64_t)H * W;

  // this thread's pair and strip
  const int q = threadIdx.x % PX;
  const int r0s = (threadIdx.x / PX) * kBandRows;
  const bool busy = q < B.hw && r0s < B.wh;

  for (int t = threadIdx.x; t < cc_len<NC>(); t += blockDim.x) s_cc[t] = cc[t];
  __syncthreads();
  if (busy) {
    // the red cell of the pair in row r is 2q + ((wr0 + r + par) & 1)
    for (int j = 0; j < kBandRows; ++j) {
      const int r = r0s + j;
      if (r >= B.wh) break;
      float f0, f1;
      if constexpr (PACKED) {
        // column 2q of planes (i & 1, 0) and (i & 1, 1), a plane apart
        const int64_t g = gaddr<true>(B.wr0 + r, B.wc0 + 2 * q, H, W);
        const int64_t g1 = g + (chan >> 2);
        *reinterpret_cast<float2*>(cur + r * B.ww + 2 * q) =
            make_float2(phi[g], phi[g1]);
        f0 = data_term<NC>(u0, g, chan, s_cc, P);
        f1 = data_term<NC>(u0, g1, chan, s_cc, P);
      } else {
        const int64_t g = (int64_t)(B.wr0 + r) * W + B.wc0 + 2 * q;
        const float2 v = *reinterpret_cast<const float2*>(phi + g);
        *reinterpret_cast<float2*>(cur + r * B.ww + 2 * q) = v;
        f0 = data_term<NC>(u0, g, chan, s_cc, P);
        f1 = data_term<NC>(u0, g + 1, chan, s_cc, P);
      }
      const int red1 = (B.wr0 + r + B.par) & 1;  // 1: the red cell is 2q+1
      fpl[(red1 ? 1 : 0) * (B.wh * B.hw) + r * B.hw + q] = f0;
      fpl[(red1 ? 0 : 1) * (B.wh * B.hw) + r * B.hw + q] = f1;
    }
  }
  __syncthreads();

  const bool rim = SHARD && band_needs_rim(B, S);
  for (int it = 0; it < k; ++it) {
    const bool last = it == k - 1;
    band_half_sweep<SHARD, kBandRows>(cur, B, S, 0, busy, rim, r0s, q,
                                      BandCell{fpl, B.hw, q, last, P});
    band_half_sweep<SHARD, kBandRows>(
        cur, B, S, 1, busy, rim, r0s, q,
        BandCell{fpl + B.wh * B.hw, B.hw, q, last, P});
  }

  // the owned cells: stored, and their partials (the old value of a cell
  // of colour c waits in plane c)
  double acc[kSums];
#pragma unroll
  for (int t = 0; t < kSums; ++t) acc[t] = 0.0;
  if (busy) {
    for (int j = 0; j < kBandRows; ++j) {
      const int r = r0s + j, gi = B.wr0 + r;
      if (r >= B.wh) break;
      if (gi < B.tr0 || gi >= B.tr1) continue;
      const int red1 = (B.wr0 + r + B.par) & 1;
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int gj = B.wc0 + 2 * q + o;
        if (gj < B.tc0 || gj >= B.tc1) continue;
        const float v = cur[r * B.ww + 2 * q + o];
        const float old = fpl[(red1 ^ o) * (B.wh * B.hw) + r * B.hw + q];
        const int64_t g = gaddr<PACKED>(gi, gj, H, W);
        out[g] = v;
        const float h = 0.5f + P.inv_pi * atanf(v / P.eps);
        const float d = v - old;
#pragma unroll
        for (int ch = 0; ch < kUh; ++ch)
          acc[ch] += (double)(u0[ch * chan + g] * h);
        acc[kUh] += (double)h;
        acc[kUh + 1] += (double)(d * d);
        acc[kUh + 2] += ((v >= 0.0f) != (old >= 0.0f)) ? 1.0 : 0.0;
        acc[kUh + 3] += (double)fabsf(d);
      }
    }
  }
  if constexpr (SHARD) {
    // the canvas outside the crop passes through: a block on the tile
    // grid's border also copies the rim cells beyond its tile, so the
    // border blocks cover the rim once
    const int er0 = blockIdx.y == 0 ? 0 : B.tr0;
    const int er1 = blockIdx.y == gridDim.y - 1 ? H : B.tr1;
    const int ec0 = blockIdx.x == 0 ? 0 : B.tc0;
    const int ec1 = blockIdx.x == gridDim.x - 1 ? W : B.tc1;
    const int ew = ec1 - ec0;
    for (int idx = threadIdx.x; idx < (er1 - er0) * ew; idx += blockDim.x) {
      const int gi = er0 + idx / ew, gj = ec0 + idx % ew;
      if (gi < B.tr0 || gi >= B.tr1 || gj < B.tc0 || gj >= B.tc1) {
        const int64_t g = gaddr<PACKED>(gi, gj, H, W);
        out[g] = phi[g];
      }
    }
  }

  band_block_sums(acc, red_scratch, block_parts);
}

// Sums the (nblocks, NSUMS) per-block partials in f64 into parts[nout]
// (slots from NSUMS on are 0) in one pass: thread t adds blocks t, t +
// 256, ... of every slot, then the warps' shuffles and warp 0's order fix
// the rest, so the result is deterministic. One barrier, where
// redblack.cuh's reduce_parts_kernel takes a tree of barriers per slot.
template <int NSUMS>
__global__ void __launch_bounds__(256)
band_reduce_kernel(const double* __restrict__ block_parts, int nblocks,
                   int nout, float* __restrict__ parts) {
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

// Raises `kernel`'s dynamic shared-memory limit to what the device's
// opt-in block maximum leaves beside its static part, once per device
// (`done`: the caller's record for this kernel).
template <class Kernel>
cudaError_t raise_smem_limit(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return err;
}

// band_kernel<NC, SHARD, PACKED>'s limit, once per device and process.
template <int NC, bool SHARD, bool PACKED>
cudaError_t band_attributes() {
  static bool done[kMaxDevices] = {};
  return raise_smem_limit(band_kernel<NC, SHARD, PACKED>, done);
}

// Host side: one chunk plus the partials reduction on `stream`. The
// caller (ops/_cuda.py::launch_band) chooses TH, TW, PX, PY and cap
// (band_geometry) and allocates out, block_parts ((nblocks,
// sum_slots<NC>()) f64) and parts (nout f32). On a shard canvas the grid
// tiles S's crop; PACKED: phi, u0 and out are parity planes.
template <int NC, bool SHARD, bool PACKED = false>
cudaError_t launch_band(const float* phi, const float* u0, const float* cc,
                        float* out, double* block_parts, float* parts, int H,
                        int W, int k, int TH, int TW, int PX, int PY,
                        int cap, int nout, Params P, cudaStream_t stream,
                        Shard S) {
  if (PX < 1 || PY < 1 || PX * PY > kBandThreads) return cudaErrorInvalidValue;
  cudaError_t err = band_attributes<NC, SHARD, PACKED>();
  if (err != cudaSuccess) return err;
  const int th = SHARD ? S.r1 - S.r0 : H, tw = SHARD ? S.c1 - S.c0 : W;
  const dim3 grid((tw + TW - 1) / TW, (th + TH - 1) / TH);
  // whole warps (the reduction's shuffles); the extra threads idle
  const int threads = (PX * PY + 31) & ~31;
  band_kernel<NC, SHARD, PACKED>
      <<<grid, threads, (size_t)cap * 8, stream>>>(
          phi, u0, cc, out, block_parts, H, W, k, TH, TW, PX, cap, P, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  band_reduce_kernel<sum_slots<NC>()><<<1, 256, 0, stream>>>(
      block_parts, (int)(grid.x * grid.y), nout, parts);
  return cudaGetLastError();
}

// blocks of band_kernel<NC, SHARD, PACKED> that fit on one SM at
// `threads` and `smem` dynamic bytes
template <int NC, bool SHARD, bool PACKED = false>
cudaError_t band_occupancy(int threads, int smem, int* blocks) {
  cudaError_t err = band_attributes<NC, SHARD, PACKED>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, band_kernel<NC, SHARD, PACKED>, (threads + 31) & ~31,
      (size_t)smem);
}

// C-channel image: the runtime channel count C (1..kMaxChannels) picks
// the kernel compiled for it.
template <bool SHARD, bool PACKED = false, int NC = 1>
cudaError_t launch_band_mc(const float* phi, const float* u0,
                           const float* cc, float* out, double* block_parts,
                           float* parts, int H, int W, int C, int k, int TH,
                           int TW, int PX, int PY, int cap, int nout,
                           Params P, cudaStream_t stream, Shard S) {
  if (C == NC)
    return launch_band<NC, SHARD, PACKED>(phi, u0, cc, out, block_parts,
                                          parts, H, W, k, TH, TW, PX, PY,
                                          cap, nout, P, stream, S);
  if constexpr (NC < kMaxChannels)
    return launch_band_mc<SHARD, PACKED, NC + 1>(
        phi, u0, cc, out, block_parts, parts, H, W, C, k, TH, TW, PX, PY,
        cap, nout, P, stream, S);
  return cudaErrorInvalidValue;
}

template <bool SHARD, bool PACKED = false, int NC = 1>
cudaError_t band_occupancy_mc(int C, int threads, int smem, int* blocks) {
  if (C == NC)
    return band_occupancy<NC, SHARD, PACKED>(threads, smem, blocks);
  if constexpr (NC < kMaxChannels)
    return band_occupancy_mc<SHARD, PACKED, NC + 1>(C, threads, smem,
                                                    blocks);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cv
