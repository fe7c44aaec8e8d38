// K9, banded mode: one coupled 4-phase iteration (two level sets) plus
// the 16 partials the next iteration's means need.
//
// Replaces chan_vese_tpu/ops/pallas_multiphase.py::_mp2_band_kernel
// (whole-image mode, reached through mp2_iteration, and shard-canvas mode,
// reached through mp2_iteration_sharded). mp2_band_kernel below, on
// mp2.cuh's forces: 2D tiles with the reach of a coupled iteration (8
// rows/cols up and left, 4 down and right), both level sets' half-sweeps in
// shared memory, one launch per iteration (mp2.cuh, "Banded mode").
//
// Shard canvases (SHARD = true, cv_mp2_iteration_shard). The image is one
// shard's halo-padded canvas of the sharded multiphase solver
// (parallel/sharded.py), and a launch computes the reference's sharded
// branch of _mp2_band_kernel with _coupled_iteration's `resync`:
// - parity: canvas cell (i, j) is red iff (i + j + parity) is even;
// - the whole canvas is swept and stored, with reads clamped at the canvas
//   edge, as the reference's bands do: the comm_k route launches K9 k
//   times on one canvas, so the halo cells must advance between launches
//   (a kernel that copied them through would read the chunk's first halo
//   from the second launch on);
// - crop [r0, r1) x [c0, c1): the shard's own cells. Only they count in
//   the partials, and the rim refresh is placed around them: after each
//   of the four half-sweeps (phi0 red, phi0 black, phi1 red, phi1 black)
//   the depth-2 replica rim on the flagged global-edge sides takes the
//   edge cells (redblack.cuh's resync_rim, rows first), so phi1's force
//   reads the refreshed new phi0;
// - tiles: each axis is cut at the crop's bounds, and tiles are counted
//   back from r0 (c0) and forward from r0 and from r1 (c1), so a window
//   that holds a replica row or column also holds its source (the window
//   of any tile not next to the crop holds no rim cell). Window columns
//   are made an even count (one more column, inside the canvas) so that
//   each thread's cell pair holds one cell of either color at any parity.
// The whole-image instantiation keeps its code: every shard branch is an
// `if constexpr`, and the shard arguments come last.
//
// Bound on the card: shared memory and the rsqrt/divide pipe; device
// memory moves 20 B/pixel per iteration plus the 1.3x halo overlap.

#include "mp2.cuh"

namespace cv {
namespace {

// shared-memory bytes per window cell: p0, p1, u0, f and half a buffer
// (ops/_cuda.py MP2_CELL_BYTES)
constexpr int kMp2CellBytes = 18;
constexpr int kMp2Sums = 10;  // live partial slots

// One half-sweep of color `color` (0 = red, global (i + j) even) over a
// shared-memory window: new active values into half, then back into cur.
// On a shard canvas (SHARD) cell (r, c) of the window is red iff
// (wr0 + r + wc0 + c + S.parity) is even, and the depth-2 replica rim is
// refreshed after the write-back.
template <bool SHARD>
__device__ __forceinline__ void window_half_sweep(float* cur, const float* f,
                                                  float* half, int wr0,
                                                  int wh, int ww, int color,
                                                  const Params& P, int wc0,
                                                  const Shard& S) {
  const int hw = ww >> 1;
  const int par = SHARD ? wc0 + S.parity : 0;
  for (int idx = threadIdx.x; idx < wh * hw; idx += blockDim.x) {
    const int r = idx / hw, q = idx - r * hw;
    const int c = 2 * q + ((wr0 + r + color + par) & 1);
    half[idx] = update_cell(cur, f, r, c, wh, ww, P);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < wh * hw; idx += blockDim.x) {
    const int r = idx / hw, q = idx - r * hw;
    const int c = 2 * q + ((wr0 + r + color + par) & 1);
    cur[r * ww + c] = half[idx];
  }
  __syncthreads();
  if constexpr (SHARD) resync_rim(cur, wr0, wr0 + wh, wc0, ww, S);
}

// Cells [t0, t1) of tile b along an axis of n cells cut at lo and hi (a
// shard canvas's crop): tiles of T cells counted back from lo, then forward
// from lo to hi and from hi to n.
__device__ __forceinline__ void crop_tile(int b, int n, int lo, int hi,
                                          int T, int& t0, int& t1) {
  const int n0 = (lo + T - 1) / T, n1 = (hi - lo + T - 1) / T;
  if (b < n0) {
    t1 = lo - (n0 - 1 - b) * T;
    t0 = max(t1 - T, 0);
  } else if (b < n0 + n1) {
    t0 = lo + (b - n0) * T;
    t1 = min(t0 + T, hi);
  } else {
    t0 = hi + (b - n0 - n1) * T;
    t1 = min(t0 + T, n);
  }
}

// The tile count of crop_tile's cut
__host__ inline int crop_tiles(int n, int lo, int hi, int T) {
  return (lo + T - 1) / T + (hi - lo + T - 1) / T + (n - hi + T - 1) / T;
}

// cap: window capacity in floats, min(H, TH + 12) * min(W, TW + 12)
// (min(H, TH + 14) * min(W, TW + 14) on a shard canvas, whose windows may
// take one more column).
// Dynamic shared memory: p0[cap] | p1[cap] | u[cap] | f[cap] | half[cap/2]
// = kMp2CellBytes cap bytes. phis and out are (2, H, W); cs holds the
// four means.
template <bool SHARD>
__global__ void __launch_bounds__(kThreads)
mp2_band_kernel(const float* __restrict__ phis, const float* __restrict__ u0,
                const float* __restrict__ cs, float* __restrict__ out,
                double* __restrict__ block_parts, int H, int W, int TH,
                int TW, int cap, Params P, Shard S) {
  extern __shared__ float smem[];
  __shared__ double red_scratch[kThreads / 32];
  __shared__ float s_c[4];
  float* p0 = smem;
  float* p1 = smem + cap;
  float* u = smem + 2 * cap;
  float* f = smem + 3 * cap;
  float* half = smem + 4 * cap;

  const int64_t plane = (int64_t)H * W;
  int tr0 = blockIdx.y * TH, tc0 = blockIdx.x * TW;
  int tr1 = min(tr0 + TH, H), tc1 = min(tc0 + TW, W);
  if constexpr (SHARD) {
    crop_tile(blockIdx.y, H, S.r0, S.r1, TH, tr0, tr1);
    crop_tile(blockIdx.x, W, S.c0, S.c1, TW, tc0, tc1);
  }
  const int wr0 = max(tr0 - 8, 0), wr1 = min(tr1 + 4, H);
  int wc0 = max(tc0 - 8, 0), wc1 = min(tc1 + 4, W);
  if constexpr (SHARD) {  // an even width (W is even)
    if ((wc1 - wc0) & 1) {
      if (wc1 < W)
        ++wc1;
      else
        --wc0;
    }
  }
  const int wh = wr1 - wr0, ww = wc1 - wc0;

  if (threadIdx.x < 4) s_c[threadIdx.x] = cs[threadIdx.x];
  __syncthreads();
  // load the window; phi0's force from the old phi1
  for (int idx = threadIdx.x; idx < wh * ww; idx += blockDim.x) {
    const int r = idx / ww, c = idx - r * ww;
    const int64_t g = (int64_t)(wr0 + r) * W + (wc0 + c);
    const float uv = u0[g], q1 = phis[plane + g];
    p0[idx] = phis[g];
    p1[idx] = q1;
    u[idx] = uv;
    f[idx] = force0(uv, q1, s_c, P);
  }
  __syncthreads();
  window_half_sweep<SHARD>(p0, f, half, wr0, wh, ww, 0, P, wc0, S);
  window_half_sweep<SHARD>(p0, f, half, wr0, wh, ww, 1, P, wc0, S);
  // phi1's force from the new phi0, cell by cell
  for (int idx = threadIdx.x; idx < wh * ww; idx += blockDim.x)
    f[idx] = force1(u[idx], p0[idx], s_c, P);
  __syncthreads();
  window_half_sweep<SHARD>(p1, f, half, wr0, wh, ww, 0, P, wc0, S);
  window_half_sweep<SHARD>(p1, f, half, wr0, wh, ww, 1, P, wc0, S);

  double acc[kMp2Sums];
#pragma unroll
  for (int t = 0; t < kMp2Sums; ++t) acc[t] = 0.0;
  const int tw = tc1 - tc0;
  for (int idx = threadIdx.x; idx < (tr1 - tr0) * tw; idx += blockDim.x) {
    const int orow = idx / tw, ocol = idx - orow * tw;
    const int gi = tr0 + orow, gj = tc0 + ocol;
    const int widx = (gi - wr0) * ww + (gj - wc0);
    const int64_t g = (int64_t)gi * W + gj;
    const float n0 = p0[widx], n1 = p1[widx];
    const float o0 = phis[g], o1 = phis[plane + g];
    out[g] = n0;
    out[plane + g] = n1;
    if constexpr (SHARD) {  // the partials count the crop only
      if (gi < S.r0 || gi >= S.r1 || gj < S.c0 || gj >= S.c1) continue;
    }
    add_phase_sums(acc, u[widx], n0, n1, P);
    acc[8] += label2(n0, n1) != label2(o0, o1) ? 1.0 : 0.0;
    const float d0 = n0 - o0, d1 = n1 - o1;
    acc[9] += (double)(d0 * d0 + d1 * d1);
  }
  const int64_t bid = blockIdx.y * gridDim.x + blockIdx.x;
#pragma unroll
  for (int t = 0; t < kMp2Sums; ++t) {
    const double s = block_sum(acc[t], red_scratch);
    if (threadIdx.x == 0) block_parts[bid * kMp2Sums + t] = s;
  }
}

// Host side: one banded iteration plus the reduction of its partials into
// parts[16] on `stream`; the caller (ops/_cuda.py) chooses TH, TW and cap
// and sizes block_parts for the grid (crop_tiles' counts on a shard canvas).
template <bool SHARD = false>
cudaError_t launch_mp2_band(const float* phis, const float* u0,
                            const float* cs, float* out, double* block_parts,
                            float* parts, int H, int W, int TH, int TW,
                            int cap, Params P, cudaStream_t stream,
                            Shard S = Shard{}) {
  const size_t smem = (size_t)cap * kMp2CellBytes;
  cudaError_t err = cudaFuncSetAttribute(
      mp2_band_kernel<SHARD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(SHARD ? crop_tiles(W, S.c0, S.c1, TW) : (W + TW - 1) / TW,
                  SHARD ? crop_tiles(H, S.r0, S.r1, TH) : (H + TH - 1) / TH);
  mp2_band_kernel<SHARD><<<grid, kThreads, smem, stream>>>(
      phis, u0, cs, out, block_parts, H, W, TH, TW, cap, P, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_parts_kernel<<<1, 256, 0, stream>>>(
      block_parts, (int)(grid.x * grid.y), kMp2Sums, 16, parts);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cv

extern "C" cudaError_t cv_mp2_iteration(
    const float* phis, const float* u0, const float* cs, float* out,
    double* block_parts, float* parts, int H, int W, int TH, int TW,
    int cap, float mu, float nu, float l1, float l2, float eta2, float gdt,
    float eps, float eps2, float inv_pi, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  return cv::launch_mp2_band(phis, u0, cs, out, block_parts, parts, H, W,
                             TH, TW, cap, P, (cudaStream_t)stream);
}

// K9's shard-canvas mode: one coupled iteration on a shard canvas (2, H, W)
// with the lattice offset by `parity`, the partials on the crop [r0, r1) x
// [c0, c1) and the depth-2 rim refreshed after every half-sweep on the
// flagged global edges (mp2_band_kernel<true>; this file's header).
extern "C" cudaError_t cv_mp2_iteration_shard(
    const float* phis, const float* u0, const float* cs, float* out,
    double* block_parts, float* parts, int H, int W, int TH, int TW, int cap,
    float mu, float nu, float l1, float l2, float eta2, float gdt, float eps,
    float eps2, float inv_pi, int parity, int r0, int r1, int c0, int c1,
    int top, int bottom, int left, int right, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  const cv::Shard S{parity, r0, r1, c0, c1, top, bottom, left, right};
  return cv::launch_mp2_band<true>(phis, u0, cs, out, block_parts, parts, H,
                                   W, TH, TW, cap, P, (cudaStream_t)stream,
                                   S);
}
