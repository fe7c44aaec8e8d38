// R1: Sussman redistancing (ops/reinit.py::reinit) of a (B, H, W) stack of
// level sets, each frame on its own, in f32 or f64, clamped boundaries.
//
// Replaces no TPU kernel: the reference's chan_vese_tpu/ops/reinit.py::
// reinit (:61) is jnp, 20 Godunov steps of ~45 elementwise operations that
// XLA fuses under fori_loop. Run op by op in eager PyTorch a 4K redistance
// is ~900 launches, each reading and writing a whole plane; the pyramid
// redistances at every level boundary and the reinit_every routes every K
// iterations, so the port computes it here.
//
// Bound on the card: operations. Each input read once and each output
// written once is 8 B a cell (f32), against ~24 operations a cell for the
// prepass and ~20 a step off the crossing (one Godunov branch and the PDE
// update; 5 for the subcell update on it): at 20 steps ~424 a cell,
// 0.05 ms at 4K against 0.02 ms of bytes.
//
// The body (reinit_tile; cv_reinit) runs a pass of up to k steps in
// one launch. A block owns a TH x TW tile of one frame (frames on
// blockIdx.z) and holds its window, the tile plus k cells each way cut at
// the image, in shared memory:
// - Deep halo. Its reads are clamped at the window's sides as at the
//   image's, so the prepass is wrong on a cut side's outermost ring and
//   each step carries a wrong value one cell further in: after n steps the
//   cells n or more from a cut side are exact, and after k the tile is.
//   A step computes only those cells (its rows and columns shrink by one
//   a step from each cut side), so the window's overhead on the tile's
//   operations is about (TH + k)(TW + k) / (TH TW), not (TH + 2k)(TW +
//   2k). ceil(steps / k) passes chain through global memory (psi read
//   and written once, phi0 read again for the prepass).
//   tests/test_torch_reinit_tiling.py holds a plain twin of this schedule
//   bitwise equal to the plain version, and a halo of k - 1 not.
// - The window: psi's two planes (a step reads one and writes the other:
//   one barrier a step) and the prepass values, each with a border of one
//   cell that holds the edge's copy (the clamped read) where the side is
//   the image's, so no read clamps an index; the edge threads refresh the
//   border after each step. 12 B a window cell in f32. Thread t owns
//   window column t % PX over a strip of RS rows, keeps the strip's flags
//   in one register (two bits a row) and walks down the column, the rows
//   above and at the cell carried in registers: four shared loads a cell
//   a step. A warp's lanes read consecutive words of one row (no bank
//   conflict). The last step stores the tile's cells.
// - Few ALU-pipe instructions, which run at half the FMA pipe's rate: the
//   Godunov gradient as differences times sign(phi0) and two NaN-keeping
//   maxima an axis (with a = c - up, b = dn - c, e = c - dn, which is -b
//   up to the sign of a zero that the square drops, and s = +-1:
//   max(pos(a)^2, neg(b)^2) = pos(max(a, e))^2 and max(neg(a)^2,
//   pos(b)^2) = pos(max(-a, -e))^2 bitwise, since pos, neg and the square
//   are monotone on their ranges, rounding keeps the order and s x is
//   exact; max.NaN in f32 returns NaN for a NaN operand, as
//   torch.maximum), and both updates computed, the subcell one kept on a
//   crossing cell, with no branch.
// - chip_reinit_variants.py times the alternatives it was chosen over
//   (the strip's prepass values and new psi in unrolled registers between
//   two barriers, a strip's rows in batches, the clamps and border copies
//   in the step, the sign of phi0 as a branch of maxima and minima).
//   The tile, the strip and k are chosen on the host
//   (chan_vese_tpu_torch/ops/_cuda.py::reinit_geometry), two blocks an SM
//   in f32 at the main path's large shapes.
//
// Every product, quotient, sum and square root is spelled with its
// round-to-nearest intrinsic, in the plain version's order, so nvcc does
// not contract a product and a sum into an FMA (it would at -fmad=true)
// and the result is bitwise the plain version's on the card; max, clamp
// and the selects propagate NaN as PyTorch's ops do.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxFrames = 65535;

template <typename T>
struct R;

template <>
struct R<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float sqrt(float a) {
    return __fsqrt_rn(a);
  }
};

template <>
struct R<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double sqrt(double a) {
    return __dsqrt_rn(a);
  }
};

template <typename T>
__device__ __forceinline__ T sq(T x) {
  return R<T>::mul(x, x);
}

constexpr int kTileThreads = 512;  // most threads a block
constexpr int kStripRows = 16;     // most rows of a thread's strip
constexpr int kMaxDevices = 64;

// blocks an SM that __launch_bounds__ asks registers for: 64 a thread in
// f32, 128 in f64
template <typename T>
struct TileBlocks {
  static constexpr int value = sizeof(T) == 4 ? 2 : 1;
};

// max that returns NaN where either operand is NaN (torch.maximum); -0
// and +0 may come out either way
__device__ __forceinline__ float max_nan(float x, float y) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}
__device__ __forceinline__ double max_nan(double x, double y) {
  return (x != x || x > y) ? x : y;
}

// One step of a cell: the plain version's step, bitwise. Off the crossing,
// with a = c - up, b = dn - c, e = c - dn (= -b up to the sign of a
// zero, which the squares drop) and s = sign(phi0) as +-1: phi0 > 0
// takes max(pos(a)^2, neg(b)^2) = pos(max(a, e))^2, phi0 <= 0
// max(neg(a)^2, pos(b)^2) = neg(min(a, e))^2 = pos(max(-a, -e))^2 (pos,
// neg and the square are monotone on their ranges, rounding keeps the
// order and s x is exact), so both are pos(max(s a, s e))^2; the same
// across the row with lf and rt; a NaN difference makes g NaN in both.
template <typename T>
__device__ __forceinline__ T tile_update(T c, T up, T dn, T lf, T rt, T v,
                                         uint8_t f, T dtau, T dth) {
  using O = R<T>;
  // both updates, then the cell's, with no branch (sign(phi0) is +-1 on a
  // crossing cell, phi0 != 0 there)
  const T s = (f & 1) ? T(1) : T(-1);
  const T sub = O::sub(c, O::mul(dth, O::sub(O::mul(s, fabs(c)), v)));
  const T a = O::sub(c, up), e = O::sub(c, dn), l = O::sub(c, lf),
          r = O::sub(c, rt);
  const T x = max_nan(max_nan(O::mul(s, a), O::mul(s, e)), T(0));
  const T y = max_nan(max_nan(O::mul(s, l), O::mul(s, r)), T(0));
  const T g = O::sqrt(O::add(sq(x), sq(y)));
  const T pde = O::sub(c, O::mul(O::mul(dtau, v), O::sub(g, T(1))));
  return (f & 2) ? sub : pde;
}

// One pass of `steps` steps (at most `halo`) on the tile (blockIdx.y,
// blockIdx.x) of frame blockIdx.z: phi0 gives the prepass, src the pass's
// starting psi (phi0 itself on the first pass), dst the tile's result.
// Thread t: window column t % PX, strip rows (t / PX) RS .. + RS - 1 (RS
// at most kStripRows). Shared memory: psi's two planes (a step reads one
// and writes the other) and the prepass values, each (wh + 2) x (ww + 2)
// with a border of one cell that holds a copy of the window's edge (the
// clamped read) where the window's side is the image's.
template <typename T>
__global__ void __launch_bounds__(kTileThreads, TileBlocks<T>::value)
reinit_tile(const T* __restrict__ phi0, const T* __restrict__ src,
            T* __restrict__ dst, int H, int W, int halo, int steps, int TH,
            int TW, int PX, int RS, T dtau, T dth, T h, T hh, T lo, T hi) {
  using O = R<T>;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int tr0 = blockIdx.y * TH, tc0 = blockIdx.x * TW;
  const int tr1 = min(tr0 + TH, H), tc1 = min(tc0 + TW, W);
  const int wr0 = max(tr0 - halo, 0), wr1 = min(tr1 + halo, H);
  const int wc0 = max(tc0 - halo, 0), wc1 = min(tc1 + halo, W);
  const int wh = wr1 - wr0, ww = wc1 - wc0;
  const int stride = ww + 2, plane = (wh + 2) * stride;
  T* cur = reinterpret_cast<T*>(tile_smem);
  T* nxt = cur + plane;
  T* aux = nxt + plane;
  const int q = threadIdx.x % PX, r0 = (threadIdx.x / PX) * RS;
  const int r1 = min(r0 + RS, wh);  // strip rows in the window
  const bool col = q < ww;
  const int64_t at0 = (int64_t)blockIdx.z * H * W + (int64_t)wr0 * W + wc0;
  // the cell (r, q) of a plane, and the border copies the edge cells make
  const int at = (r0 + 1) * stride + q + 1;
  const bool first_col = q == 0, last_col = q == ww - 1;

  // a strip of psi's window from global memory, every row's load in
  // flight at once, then into `cur` with the border copies
  auto fetch = [&](const T* __restrict__ from, T (&v)[kStripRows]) {
#pragma unroll
    for (int s = 0; s < kStripRows; ++s)
      if (col && r0 + s < r1)
        v[s] = __ldg(from + at0 + (int64_t)(r0 + s) * W + q);
  };
  auto place = [&](const T (&v)[kStripRows]) {
    if (!col) return;
#pragma unroll
    for (int s = 0; s < kStripRows; ++s) {
      const int r = r0 + s, i = at + s * stride;
      if (r >= r1) break;
      cur[i] = v[s];
      if (r == 0) cur[i - stride] = v[s];
      if (r == wh - 1) cur[i + stride] = v[s];
      if (first_col) cur[i - 1] = v[s];
      if (last_col) cur[i + 1] = v[s];
    }
  };
  T start[kStripRows], later[kStripRows];
  fetch(phi0, start);
  if (src != phi0) fetch(src, later);
  place(start);
  __syncthreads();

  // the prepass, on phi0's window: the value into aux, the flags into two
  // bits a row of the thread's own register (bit 0 phi0 > 0, bit 1 the
  // crossing)
  uint32_t marks = 0;
  if (col) {
    int i = at;
    for (int r = r0; r < r1; ++r, i += stride) {
      const T c = cur[i], up = cur[i - stride], dn = cur[i + stride],
              lf = cur[i - 1], rt = cur[i + 1];
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
      aux[i] = v;
      marks |= ((c > T(0) ? 1u : 0u) | (crosses ? 2u : 0u)) << (2 * (r - r0));
    }
  }
  if (src != phi0) {  // a later pass starts from the previous pass's psi
    __syncthreads();
    place(later);
  }
  __syncthreads();

  // the steps: step n computes the cells n or more from a cut side; the
  // last one stores the tile's cells
  const bool top = wr0 > 0, bottom = wr1 < H, left = wc0 > 0, right = wc1 < W;
  const bool tile_col = q >= tc0 - wc0 && q < tc1 - wc0;
  const int sr0 = tr0 - wr0, sr1 = tr1 - wr0;
  for (int n = 1; n <= steps; ++n) {
    const int rlo = max(r0, top ? n : 0);
    const int rhi = min(r1, bottom ? wh - n : wh);
    if (col && q >= (left ? n : 0) && q < (right ? ww - n : ww) &&
        rlo < rhi) {
      int i = at + (rlo - r0) * stride;
      uint32_t m = marks >> (2 * (rlo - r0));
      T up = cur[i - stride], c = cur[i];
      if (n < steps) {
        for (int r = rlo; r < rhi; ++r, i += stride, m >>= 2) {
          const T dn = cur[i + stride];
          nxt[i] = tile_update(c, up, dn, cur[i - 1], cur[i + 1], aux[i],
                               (uint8_t)(m & 3u), dtau, dth);
          up = c;
          c = dn;
        }
        // the border copies of the computed edge cells, where the side is
        // the image's (at a cut side only cells that are no longer exact
        // read the border); each thread copies cells it wrote
        const int i0 = at + (rlo - r0) * stride;
        if (first_col && !left)
          for (int j = i0; j < i; j += stride) nxt[j - 1] = nxt[j];
        if (last_col && !right)
          for (int j = i0; j < i; j += stride) nxt[j + 1] = nxt[j];
        if (rlo == 0) nxt[i0 - stride] = nxt[i0];
        if (rhi == wh) nxt[i] = nxt[i - stride];
      } else {
        for (int r = rlo; r < rhi; ++r, i += stride, m >>= 2) {
          const T dn = cur[i + stride];
          const T v = tile_update(c, up, dn, cur[i - 1], cur[i + 1], aux[i],
                                  (uint8_t)(m & 3u), dtau, dth);
          if (tile_col && r >= sr0 && r < sr1)
            dst[at0 + (int64_t)r * W + q] = v;
          up = c;
          c = dn;
        }
      }
    }
    T* t = cur;
    cur = nxt;
    nxt = t;
    __syncthreads();
  }
}

// reinit_tile<T>'s dynamic shared-memory limit raised to the device's
// opt-in block maximum, once per device and process
template <typename T>
cudaError_t tile_attributes() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(reinit_tile<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return err;
}

// shared memory of a window of the geometry: three planes of T, each
// min(TH + 2k, H) + 2 rows by min(TW + 2k, W) + 2 columns
template <typename T>
size_t tile_smem(int H, int W, int k, int TH, int TW) {
  return (size_t)(std::min(TH + 2 * k, H) + 2) *
         (size_t)(std::min(TW + 2 * k, W) + 2) * 3 * sizeof(T);
}

template <typename T>
cudaError_t launch_tile(const T* phi, T* buf0, T* buf1, int B, int H, int W,
                        int steps, int k, int TH, int TW, int PX, int PY,
                        int RS, double dtau, double h, cudaStream_t s) {
  if (k < 1 || TH < 1 || TW < 1 || PX < 1 || PY < 1 || RS < 1 ||
      RS > kStripRows || PX * PY > kTileThreads ||
      std::min(TH + 2 * k, H) > PY * RS || std::min(TW + 2 * k, W) > PX)
    return cudaErrorInvalidValue;
  cudaError_t err = tile_attributes<T>();
  if (err != cudaSuccess) return err;
  const size_t smem = tile_smem<T>(H, W, k, TH, TW);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const int passes = (steps + k - 1) / k;
  const T* src = phi;
  for (int i = 0; i < passes; ++i) {
    T* dst = (i & 1) ? buf1 : buf0;
    const int n = steps / passes + (i < steps % passes ? 1 : 0);
    reinit_tile<T><<<grid, PX * PY, smem, s>>>(
        phi, src, dst, H, W, k, n, TH, TW, PX, RS, (T)dtau, (T)(dtau / h),
        (T)h, (T)(h * h), (T)(-1.5 * h), (T)(1.5 * h));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

// The tile body: phi (B, H, W) -> the redistanced stack, ceil(steps / k)
// passes of reinit_tile on TH x TW tiles (a halo of k), PX x PY threads of
// RS-row strips (ops/_cuda.py::reinit_geometry chooses them), the result
// in buf0 after an odd count of passes, buf1 after an even one (buf1 is
// not touched by one pass). f64 selects double. The passes go on
// `stream`, none of them synchronizing.
extern "C" cudaError_t cv_reinit(const void* phi, void* buf0, void* buf1,
                                 int B, int H, int W, int steps, int k,
                                 int TH, int TW, int PX, int PY, int RS,
                                 double dtau, double h, int f64,
                                 void* stream) {
  if (B < 1 || B > kMaxFrames || H < 1 || W < 1 || steps < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return launch_tile<double>((const double*)phi, (double*)buf0,
                               (double*)buf1, B, H, W, steps, k, TH, TW, PX,
                               PY, RS, dtau, h, s);
  return launch_tile<float>((const float*)phi, (float*)buf0, (float*)buf1, B,
                            H, W, steps, k, TH, TW, PX, PY, RS, dtau, h, s);
}

// Blocks of the tile body an SM holds at `threads` threads and `smem`
// bytes of window (f64 selects double), as the card counts them.
extern "C" cudaError_t cv_reinit_occupancy(int f64, int threads, int smem,
                                           int* blocks) {
  cudaError_t err = f64 ? tile_attributes<double>() : tile_attributes<float>();
  if (err != cudaSuccess) return err;
  return f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks, reinit_tile<double>, threads, (size_t)smem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks, reinit_tile<float>, threads, (size_t)smem);
}
