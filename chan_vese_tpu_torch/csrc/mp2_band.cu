// K9, banded mode: one coupled 4-phase iteration (two level sets) plus
// the 16 partials the next iteration's means need.
//
// Replaces chan_vese_tpu/ops/pallas_multiphase.py::_mp2_band_kernel
// (whole-image mode, reached through mp2_iteration). mp2_band_kernel below,
// on mp2.cuh's forces: 2D tiles with the reach of a coupled iteration (8
// rows/cols up and left, 4 down and right), both level sets' half-sweeps in
// shared memory, one launch per iteration (mp2.cuh, "Banded mode").
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
__device__ __forceinline__ void window_half_sweep(float* cur, const float* f,
                                                  float* half, int wr0,
                                                  int wh, int ww, int color,
                                                  const Params& P) {
  const int hw = ww >> 1;
  for (int idx = threadIdx.x; idx < wh * hw; idx += blockDim.x) {
    const int r = idx / hw, q = idx - r * hw;
    const int c = 2 * q + ((wr0 + r + color) & 1);
    half[idx] = update_cell(cur, f, r, c, wh, ww, P);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < wh * hw; idx += blockDim.x) {
    const int r = idx / hw, q = idx - r * hw;
    const int c = 2 * q + ((wr0 + r + color) & 1);
    cur[r * ww + c] = half[idx];
  }
  __syncthreads();
}

// cap: window capacity in floats, min(H, TH + 12) * min(W, TW + 12).
// Dynamic shared memory: p0[cap] | p1[cap] | u[cap] | f[cap] | half[cap/2]
// = kMp2CellBytes cap bytes. phis and out are (2, H, W); cs holds the
// four means.
__global__ void __launch_bounds__(kThreads)
mp2_band_kernel(const float* __restrict__ phis, const float* __restrict__ u0,
                const float* __restrict__ cs, float* __restrict__ out,
                double* __restrict__ block_parts, int H, int W, int TH,
                int TW, int cap, Params P) {
  extern __shared__ float smem[];
  __shared__ double red_scratch[kThreads / 32];
  __shared__ float s_c[4];
  float* p0 = smem;
  float* p1 = smem + cap;
  float* u = smem + 2 * cap;
  float* f = smem + 3 * cap;
  float* half = smem + 4 * cap;

  const int64_t plane = (int64_t)H * W;
  const int tr0 = blockIdx.y * TH, tc0 = blockIdx.x * TW;
  const int tr1 = min(tr0 + TH, H), tc1 = min(tc0 + TW, W);
  const int wr0 = max(tr0 - 8, 0), wr1 = min(tr1 + 4, H);
  const int wc0 = max(tc0 - 8, 0), wc1 = min(tc1 + 4, W);
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
  window_half_sweep(p0, f, half, wr0, wh, ww, 0, P);
  window_half_sweep(p0, f, half, wr0, wh, ww, 1, P);
  // phi1's force from the new phi0, cell by cell
  for (int idx = threadIdx.x; idx < wh * ww; idx += blockDim.x)
    f[idx] = force1(u[idx], p0[idx], s_c, P);
  __syncthreads();
  window_half_sweep(p1, f, half, wr0, wh, ww, 0, P);
  window_half_sweep(p1, f, half, wr0, wh, ww, 1, P);

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
// parts[16] on `stream`; the caller (ops/_cuda.py) chooses TH, TW and cap.
__host__ inline cudaError_t launch_mp2_band(const float* phis,
                                            const float* u0, const float* cs,
                                            float* out, double* block_parts,
                                            float* parts, int H, int W,
                                            int TH, int TW, int cap,
                                            Params P, cudaStream_t stream) {
  const size_t smem = (size_t)cap * kMp2CellBytes;
  cudaError_t err = cudaFuncSetAttribute(
      mp2_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  mp2_band_kernel<<<grid, kThreads, smem, stream>>>(
      phis, u0, cs, out, block_parts, H, W, TH, TW, cap, P);
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
