// The single-sweep body of K1 (fused.cu: whole image, batch of frames,
// shard canvas; fused_sweep.cu: the force mode, with and without a
// lattice parity) and K4 (fused_mc.cu, NC = C): one red-black iteration
// with the means frozen, then the partials of that transition, summed in
// f64 in a fixed order: redblack.cuh's contract at k = 1, every cell
// through redblack.cuh's update_cell_at and data_term. Replaces
// chan_vese_tpu/ops/pallas_sweep.py::
// _fused_band_kernel (:216; fused_iteration :381 with _resync_rim :137,
// fused_sweep :467, fused_iteration_batch :494, pallas_call in _call_fused
// :427/:430) and chan_vese_tpu/ops/pallas_sweep_mc.py::_kernel (:50,
// fused_iteration_mc :144, pallas_call :167).
//
// Bound on the card: device memory. A launch reads phi and u0 (or f, or C
// channels) and writes phi once: 12 B a pixel (8 + 4C), against about 7
// MUFU operations and ~80 FP32 ones a pixel. What the design does about
// it:
// - A halo of 2 each way (band.cuh's 2k at k = 1; tests/test_torch_
//   band_tiling.py proves 2 exact and 1 not), so a window is the tile plus
//   2 cells, cut at the image; on a shard canvas the even start and width
//   and the rim refresh after each half-sweep are band.cuh's.
// - Small blocks (at most kSweepThreads threads, __launch_bounds__ for
//   kSweepMinBlocks of them an SM) and a tile chosen on the host for k = 1
//   (ops/_cuda.py::sweep_geometry): enough blocks to fill the card at
//   512^2 and on a shard's crop, four or more resident an SM at 4K and on
//   16 x 1080p frames, so that one block's loads overlap another's sweep.
// - The window load moves whole 16-byte vectors in the body of each
//   window row and one 8-byte pair at its ragged ends, all of a thread's
//   rows of a batch issued before any is stored.
// - band.cuh's column-pair strips (kSweepRows rows a thread): results in
//   registers across one barrier, no half buffer, no division in the sweep
//   loops, the rim refresh only in blocks whose window holds a replica.
//   The black half-sweep is the last: its results stay in the registers of
//   the thread that stores the pair and sums its partials, so it has no
//   write-back, no barrier and no rim refresh.
// - Shared memory is phi, the old value of each swept cell (colour-split,
//   for the partials) and u0 (f in the force mode, C planes for K4): 12 B
//   a window cell, 8 + 4C for K4. The force is computed from u0 in shared
//   memory where the cell is swept (each cell is swept once at k = 1), so
//   the partials read u0 from shared memory and device memory sees u0 once.
// - One launch a call: the block sums are one pass (band_block_sums), and
//   the last block of a frame to finish (a per-frame counter, reset by
//   that block, in a buffer of the launch's stream: launches on one stream
//   never run at once) sums the frame's rows in fixed block order into
//   its partials. The shared-memory attribute is set once per device and
//   instantiation.
// Frames (K1's batch mode): blockIdx.z is the frame; each frame reads its
// own means, writes its own block rows and partials and has its own
// counter, with the tiles and summation order of the same image launched
// alone, so frame n is bitwise the single-image launch.

#pragma once

#include "band.cuh"

namespace cv {
namespace {

constexpr int kSweepThreads = 256;  // most threads a block (8 warps)
constexpr int kSweepMinBlocks = 4;  // blocks an SM the registers allow
constexpr int kSweepRows = 6;       // rows of a thread's strip (even)
constexpr int kSweepLoad = 2;       // window rows a thread loads at once

// The swept cell: the force from u0 in shared memory (data_term over the
// window's planes, plane stride cap), the cell's old value left in its
// colour's plane oc for the partials.
template <int NC>
struct SweepCell {
  const float* upl;
  float* oc;
  const float* cc;
  int ww, hw, q, cap;
  const Params& P;
  __device__ __forceinline__ float operator()(int r, bool odd,
                                              const float (&g9)[9]) const {
    const float fv =
        data_term<NC>(upl, r * ww + 2 * q + (odd ? 1 : 0), cap, cc, P);
    const float v =
        update_cell_at(g9, [&] { return fv; }, 1, 1, 3, 3, Grid3{}, P);
    oc[r * hw + q] = g9[4];
    return v;
  }
};

// Loads the window of the frame's phi and u0 (uh_slots<NC>() planes of
// H W) into cur and upl (flat, width ww; upl's planes cap apart). Row r
// of the window starts at element g0 = (wr0 + r) W + wc0; with phi and u0
// 16-byte aligned (the wrapper's check) and H W a multiple of 4, an odd
// pair index g0 / 2 starts the row with one pair, then whole vectors,
// then a pair where two columns remain. Thread t takes slot t % nslot of
// rows t / nslot, t / nslot + rstep, ...
template <int NC>
__device__ __forceinline__ void sweep_load(const float* __restrict__ phi,
                                           const float* __restrict__ u0,
                                           float* cur, float* upl,
                                           const BandWin& B, int W,
                                           int64_t chan, int cap) {
  constexpr int kU = uh_slots<NC>();
  // rows at once: kSweepLoad, one where C channels ride along (registers)
  constexpr int kL = kU > 1 ? 1 : kSweepLoad;
  const int nslot = (B.ww >> 2) + 2;
  const int rstep = blockDim.x / nslot;
  const int s = threadIdx.x % nslot;
  if ((int)threadIdx.x >= rstep * nslot) return;
  for (int r0 = threadIdx.x / nslot; r0 < B.wh; r0 += kL * rstep) {
    float4 pv[kL], uv[kL][kU];
    int col[kL], cnt[kL];
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const int r = r0 + i * rstep;
      cnt[i] = 0;
      col[i] = 0;
      if (r < B.wh) {
        const int64_t g0 = (int64_t)(B.wr0 + r) * W + B.wc0;
        const int lead = (g0 & 3) ? 2 : 0;
        const int nvec = (B.ww - lead) >> 2;
        if (s == 0) {
          cnt[i] = lead;
        } else if (s <= nvec) {
          col[i] = lead + 4 * (s - 1);
          cnt[i] = 4;
        } else if (s == nvec + 1) {
          col[i] = lead + 4 * nvec;
          cnt[i] = B.ww - col[i];
        }
        const int64_t g = g0 + col[i];
        if (cnt[i] == 4) {
          pv[i] = *reinterpret_cast<const float4*>(phi + g);
#pragma unroll
          for (int c = 0; c < kU; ++c)
            uv[i][c] = *reinterpret_cast<const float4*>(u0 + c * chan + g);
        } else if (cnt[i] == 2) {
          const float2 a = *reinterpret_cast<const float2*>(phi + g);
          pv[i] = make_float4(a.x, a.y, 0.0f, 0.0f);
#pragma unroll
          for (int c = 0; c < kU; ++c) {
            const float2 b =
                *reinterpret_cast<const float2*>(u0 + c * chan + g);
            uv[i][c] = make_float4(b.x, b.y, 0.0f, 0.0f);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kL; ++i) {
      const int w = (r0 + i * rstep) * B.ww + col[i];
      if (cnt[i] >= 2) {
        *reinterpret_cast<float2*>(cur + w) = make_float2(pv[i].x, pv[i].y);
#pragma unroll
        for (int c = 0; c < kU; ++c)
          *reinterpret_cast<float2*>(upl + c * cap + w) =
              make_float2(uv[i][c].x, uv[i][c].y);
      }
      if (cnt[i] == 4) {
        *reinterpret_cast<float2*>(cur + w + 2) =
            make_float2(pv[i].z, pv[i].w);
#pragma unroll
        for (int c = 0; c < kU; ++c)
          *reinterpret_cast<float2*>(upl + c * cap + w + 2) =
              make_float2(uv[i][c].z, uv[i][c].w);
      }
    }
  }
}

// The frame's partials from its block rows (nblocks, NSUMS), in the last
// block of the frame to finish: thread t sums rows t, t + blockDim.x, ...
// of every slot, then the warps' shuffles and the warps in order, into
// parts[nout] (slots from NSUMS on are 0). The counter goes back to 0 for
// the stream's next launch. Every block's row is written (band_block_sums)
// before this is called.
template <int NSUMS>
__device__ __forceinline__ void sweep_finish(
    const double* block_parts, unsigned int* counter, float* parts,
    int nblocks, int nout, double (&scratch)[NSUMS][kBandThreads / 32]) {
  __shared__ bool last;
  if (threadIdx.x < NSUMS) __threadfence();  // this block's row, then its count
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == (unsigned int)(nblocks - 1);
    if (last) *counter = 0u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every row counted before this block reads them
  double a[NSUMS];
#pragma unroll
  for (int t = 0; t < NSUMS; ++t) a[t] = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) {
#pragma unroll
    for (int t = 0; t < NSUMS; ++t)
      a[t] += __ldcg(block_parts + (int64_t)b * NSUMS + t);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < NSUMS; ++t) {
    double v = a[t];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) scratch[t][warp] = v;
  }
  __syncthreads();
  if ((int)threadIdx.x < nout) {
    double v = 0.0;
    if (threadIdx.x < NSUMS) {
      const int nwarps = (blockDim.x + 31) >> 5;
      for (int w = 0; w < nwarps; ++w) v += scratch[threadIdx.x][w];
    }
    parts[threadIdx.x] = (float)v;
  }
}

// Dynamic shared memory: cur[cap] | old planes [2][cap / 2] | u planes
// [uh_slots<NC>()][cap] = (8 + 4 uh_slots) cap bytes, cap >= wh * ww of
// every block's window. PX * PY <= kSweepThreads with PX >= ww / 2 and PY
// kSweepRows >= wh; blockDim.x is PX * PY rounded up to whole warps. The
// grid is (tiles across, tiles down, frames); phi, u0 (C planes a frame
// for K4) and out hold the frames stacked, cc a row of means a frame,
// block_parts (frames, nblocks, NSUMS), counters one a frame (0 on entry),
// parts (frames, nout).
template <int NC, bool SHARD>
__global__ void __launch_bounds__(kSweepThreads, kSweepMinBlocks)
sweep_kernel(const float* __restrict__ phi, const float* __restrict__ u0,
             const float* __restrict__ cc, float* __restrict__ out,
             double* __restrict__ block_parts,
             unsigned int* __restrict__ counters, float* __restrict__ parts,
             int nout, int H, int W, int TH, int TW, int PX, int cap,
             Params P, Shard S) {
  constexpr int kU = uh_slots<NC>(), kSums = sum_slots<NC>();
  extern __shared__ __align__(16) float sweep_smem[];
  __shared__ double red_scratch[kSums][kBandThreads / 32];
  __shared__ float s_cc[cc_len<NC>()];
  float* cur = sweep_smem;
  float* old = sweep_smem + cap;
  float* upl = sweep_smem + 2 * cap;

  // the tiled region: the whole image, or a shard canvas's crop
  const int ty0 = SHARD ? S.r0 : 0, ty1 = SHARD ? S.r1 : H;
  const int tx0 = SHARD ? S.c0 : 0, tx1 = SHARD ? S.c1 : W;
  BandWin B;
  B.par = SHARD ? S.parity : 0;
  B.tr0 = ty0 + blockIdx.y * TH;
  B.tc0 = tx0 + blockIdx.x * TW;
  B.tr1 = min(B.tr0 + TH, ty1);
  B.tc1 = min(B.tc0 + TW, tx1);
  B.wr0 = max(B.tr0 - 2, 0);
  const int wr1 = min(B.tr1 + 2, H);
  // an even start (the pairs' colour pattern) and width (W is even)
  B.wc0 = max(B.tc0 - 2, 0) & ~1;
  int wc1 = min(B.tc1 + 2, W);
  wc1 += (wc1 - B.wc0) & 1;
  B.wh = wr1 - B.wr0;
  B.ww = wc1 - B.wc0;
  B.hw = B.ww >> 1;
  const int64_t chan = (int64_t)H * W;
  const int nblocks = gridDim.x * gridDim.y;

  // this block's frame (0 unless the launch carries a stack)
  const int64_t frame = blockIdx.z;
  phi += frame * chan;
  out += frame * chan;
  u0 += frame * chan * kU;
  cc += frame * cc_len<NC>();
  block_parts += frame * nblocks * kSums;
  parts += frame * nout;

  // this thread's pair and strip
  const int q = threadIdx.x % PX;
  const int r0s = (threadIdx.x / PX) * kSweepRows;
  const bool busy = q < B.hw && r0s < B.wh;

  for (int t = threadIdx.x; t < cc_len<NC>(); t += blockDim.x) s_cc[t] = cc[t];
  sweep_load<NC>(phi, u0, cur, upl, B, W, chan, cap);
  __syncthreads();

  const bool rim = SHARD && band_needs_rim(B, S);
  const int half = B.wh * B.hw;
  // red: swept and written back, for the black half-sweep to read
  band_half_sweep<SHARD, kSweepRows>(
      cur, B, S, 0, busy, rim, r0s, q,
      SweepCell<NC>{upl, old, s_cc, B.ww, B.hw, q, cap, P}, B.wh);
  // black: the last half-sweep; its new values stay in registers, where the
  // store and the partials below take them (no write-back, no rim refresh:
  // a replica cell is never stored or summed)
  float nb[kSweepRows];
  if (busy) {
    const SweepCell<NC> cell{upl, old + half, s_cc, B.ww, B.hw, q, cap, P};
    if ((B.wr0 + 1 + B.par) & 1)
      band_rows<1>(cur, B, r0s, q, cell, nb, B.wh);
    else
      band_rows<0>(cur, B, r0s, q, cell, nb, B.wh);
  }

  // the owned cells: stored, and their partials (the old value of a cell
  // of colour c waits in plane c)
  double acc[kSums];
#pragma unroll
  for (int t = 0; t < kSums; ++t) acc[t] = 0.0;
#pragma unroll
  for (int j = 0; j < kSweepRows; ++j) {
    const int r = r0s + j, gi = B.wr0 + r;
    if (!busy || r >= B.wh || gi < B.tr0 || gi >= B.tr1) continue;
    const int red1 = (B.wr0 + r + B.par) & 1;  // 1: the red cell is 2q + 1
    const int w = r * B.ww + 2 * q;
    const int gj = B.wc0 + 2 * q;
    const float2 v2 = red1 ? make_float2(nb[j], cur[w + 1])
                           : make_float2(cur[w], nb[j]);
    const int64_t g = (int64_t)gi * W + gj;
    const bool in0 = gj >= B.tc0 && gj < B.tc1;
    const bool in1 = gj + 1 >= B.tc0 && gj + 1 < B.tc1;
    if (in0 && in1)
      *reinterpret_cast<float2*>(out + g) = v2;
    else if (in0)
      out[g] = v2.x;
    else if (in1)
      out[g + 1] = v2.y;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      if (!(o ? in1 : in0)) continue;
      const float v = o ? v2.y : v2.x;
      const float prev = old[(red1 ^ o) * half + r * B.hw + q];
      const float h = 0.5f + P.inv_pi * atanf(v / P.eps);
      const float d = v - prev;
#pragma unroll
      for (int ch = 0; ch < kU; ++ch)
        acc[ch] += (double)(upl[ch * cap + w + o] * h);
      acc[kU] += (double)h;
      acc[kU + 1] += (double)(d * d);
      acc[kU + 2] += ((v >= 0.0f) != (prev >= 0.0f)) ? 1.0 : 0.0;
      acc[kU + 3] += (double)fabsf(d);
    }
  }
  if constexpr (SHARD) {
    // the canvas outside the crop passes through: a block on the tile
    // grid's border copies the rim rows above or below its tile and the
    // rim columns beside it (corners with the rows), so the border blocks
    // cover the rim once
    const int er0 = blockIdx.y == 0 ? 0 : B.tr0;
    const int er1 = blockIdx.y == gridDim.y - 1 ? H : B.tr1;
    const int ec0 = blockIdx.x == 0 ? 0 : B.tc0;
    const int ec1 = blockIdx.x == gridDim.x - 1 ? W : B.tc1;
    const int ew = ec1 - ec0;
    const int above = B.tr0 - er0, below = er1 - B.tr1;
    for (int idx = threadIdx.x; idx < (above + below) * ew;
         idx += blockDim.x) {
      const int rr = idx / ew;
      const int gi = rr < above ? er0 + rr : B.tr1 + rr - above;
      const int64_t g = (int64_t)gi * W + ec0 + idx - rr * ew;
      out[g] = phi[g];
    }
    const int left = B.tc0 - ec0, right = ec1 - B.tc1, th = B.tr1 - B.tr0;
    const int sw = left + right;
    for (int idx = threadIdx.x; idx < th * sw; idx += blockDim.x) {
      const int rr = idx / sw, cc2 = idx - rr * sw;
      const int gj = cc2 < left ? ec0 + cc2 : B.tc1 + cc2 - left;
      const int64_t g = (int64_t)(B.tr0 + rr) * W + gj;
      out[g] = phi[g];
    }
  }

  band_block_sums(acc, red_scratch, block_parts);
  sweep_finish<kSums>(block_parts, counters + frame, parts, nblocks, nout,
                      red_scratch);
}

// sweep_kernel<NC, SHARD>'s shared-memory limit, once per device and
// process.
template <int NC, bool SHARD>
cudaError_t sweep_attributes() {
  static bool done[kMaxDevices] = {};
  return raise_smem_limit(sweep_kernel<NC, SHARD>, done);
}

// Host side: one sweep of `frames` stacked images, partials included, in
// one launch on `stream`. The caller (ops/_cuda.py::launch_sweep) chooses
// TH, TW, PX, PY and cap (sweep_geometry) and sizes block_parts for
// nblocks blocks a frame, which must be the grid's; counters (frames) are
// 0 and come back 0. On a shard canvas the grid tiles S's crop.
template <int NC, bool SHARD>
cudaError_t launch_sweep(const float* phi, const float* u0, const float* cc,
                         float* out, double* block_parts,
                         unsigned int* counters, float* parts, int H, int W,
                         int frames, int TH, int TW, int PX, int PY, int cap,
                         int nblocks, int nout, Params P, cudaStream_t stream,
                         Shard S) {
  if (TH < 1 || TW < 1 || PX < 1 || PY < 1 || PX * PY > kSweepThreads ||
      frames < 1 || frames > 65535 || nout < sum_slots<NC>())
    return cudaErrorInvalidValue;
  const int th = SHARD ? S.r1 - S.r0 : H, tw = SHARD ? S.c1 - S.c0 : W;
  const dim3 grid((tw + TW - 1) / TW, (th + TH - 1) / TH, frames);
  if ((int64_t)grid.x * grid.y != nblocks) return cudaErrorInvalidValue;
  cudaError_t err = sweep_attributes<NC, SHARD>();
  if (err != cudaSuccess) return err;
  // whole warps (the reduction's shuffles); the extra threads idle
  const int threads = (PX * PY + 31) & ~31;
  const size_t smem = (size_t)cap * (8 + 4 * uh_slots<NC>());
  sweep_kernel<NC, SHARD><<<grid, threads, smem, stream>>>(
      phi, u0, cc, out, block_parts, counters, parts, nout, H, W, TH, TW, PX,
      cap, P, S);
  return cudaGetLastError();
}

// blocks of sweep_kernel<NC, SHARD> that fit on one SM at `threads` and
// `smem` dynamic bytes
template <int NC, bool SHARD>
cudaError_t sweep_occupancy(int threads, int smem, int* blocks) {
  cudaError_t err = sweep_attributes<NC, SHARD>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sweep_kernel<NC, SHARD>, (threads + 31) & ~31, (size_t)smem);
}

// C-channel image: the runtime channel count C (1..kMaxChannels) picks
// the kernel compiled for it.
template <int NC = 1>
cudaError_t launch_sweep_mc(const float* phi, const float* u0,
                            const float* cc, float* out, double* block_parts,
                            unsigned int* counters, float* parts, int H,
                            int W, int C, int TH, int TW, int PX, int PY,
                            int cap, int nblocks, int nout, Params P,
                            cudaStream_t stream) {
  if (C == NC)
    return launch_sweep<NC, false>(phi, u0, cc, out, block_parts, counters,
                                   parts, H, W, 1, TH, TW, PX, PY, cap,
                                   nblocks, nout, P, stream,
                                   Shard{0, 0, H, 0, W, 0, 0, 0, 0});
  if constexpr (NC < kMaxChannels)
    return launch_sweep_mc<NC + 1>(phi, u0, cc, out, block_parts, counters,
                                   parts, H, W, C, TH, TW, PX, PY, cap,
                                   nblocks, nout, P, stream);
  return cudaErrorInvalidValue;
}

template <int NC = 1>
cudaError_t sweep_occupancy_mc(int C, int threads, int smem, int* blocks) {
  if (C == NC) return sweep_occupancy<NC, false>(threads, smem, blocks);
  if constexpr (NC < kMaxChannels)
    return sweep_occupancy_mc<NC + 1>(C, threads, smem, blocks);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cv
