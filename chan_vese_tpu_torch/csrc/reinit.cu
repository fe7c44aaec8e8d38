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
// 0.05 ms at 4K against 0.02 ms of bytes. This first design
// is simple and memory-bound instead: one prepass launch computes what
// depends on phi0 alone into one value and one flags byte a cell (the
// subcell distance estimate on crossing cells, the smoothed sign on the
// others; bit 0 phi0 > 0, bit 1 the crossing), then one launch a step
// reads psi's five-point stencil (neighbours mostly from L1), the value and
// the flags and writes psi, ping-ponging two buffers: 13 B a cell a step
// in f32. A deep-halo tile running all steps in one pass, as band.cuh does
// for k iterations, is the redesign that would reach the operations bound.
//
// Every product, quotient, sum and square root is spelled with its
// round-to-nearest intrinsic, in the plain version's order, so nvcc does
// not contract a product and a sum into an FMA (it would at -fmad=true)
// and the result is bitwise the plain version's on the card; max, clamp
// and the selects propagate NaN as PyTorch's ops do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32, kBlockY = 8;
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
__device__ __forceinline__ bool isnan_(T x) {
  return x != x;
}

// torch.maximum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T nmax(T x, T y) {
  return isnan_(x) ? x : (isnan_(y) ? y : (x > y ? x : y));
}

// torch.clamp(x, min=0) and torch.clamp(x, max=0): NaN stays NaN
template <typename T>
__device__ __forceinline__ T pos(T x) {
  return x < T(0) ? T(0) : x;
}

template <typename T>
__device__ __forceinline__ T neg(T x) {
  return x > T(0) ? T(0) : x;
}

template <typename T>
__device__ __forceinline__ T sq(T x) {
  return R<T>::mul(x, x);
}

struct Cell {
  int64_t c, up, dn, lf, rt;
};

// the cell (i, j) of frame z and its four clamped neighbours
__device__ __forceinline__ bool locate(int H, int W, Cell& at) {
  const int j = blockIdx.x * kBlockX + threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;
  if (i >= H || j >= W) return false;
  const int64_t base = (int64_t)blockIdx.z * H * W;
  const int64_t row = base + (int64_t)i * W;
  at.c = row + j;
  at.up = base + (int64_t)(i > 0 ? i - 1 : 0) * W + j;
  at.dn = base + (int64_t)(i < H - 1 ? i + 1 : H - 1) * W + j;
  at.lf = row + (j > 0 ? j - 1 : 0);
  at.rt = row + (j < W - 1 ? j + 1 : W - 1);
  return true;
}

// what depends on phi0 alone: aux = the clipped subcell distance estimate
// on crossing cells, the smoothed sign elsewhere; flags bit 0 = phi0 > 0,
// bit 1 = crossing
template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
reinit_prepass(const T* __restrict__ phi, T* __restrict__ aux,
               uint8_t* __restrict__ flags, int H, int W, T h, T hh, T lo,
               T hi) {
  using O = R<T>;
  Cell at;
  if (!locate(H, W, at)) return;
  const T c = __ldg(phi + at.c), up = __ldg(phi + at.up),
          dn = __ldg(phi + at.dn), lf = __ldg(phi + at.lf),
          rt = __ldg(phi + at.rt);
  const T gx = O::mul(T(0.5), O::sub(dn, up));
  const T gy = O::mul(T(0.5), O::sub(rt, lf));
  const T gn2 = O::add(O::mul(gx, gx), O::mul(gy, gy));
  const bool crosses = O::mul(c, up) < T(0) || O::mul(c, dn) < T(0) ||
                       O::mul(c, lf) < T(0) || O::mul(c, rt) < T(0);
  T v;
  if (crosses) {
    T s = O::sqrt(gn2);
    s = s < T(1e-12) ? T(1e-12) : s;
    v = O::div(O::mul(h, c), s);
    v = v < lo ? lo : (v > hi ? hi : v);
  } else {
    v = O::div(c, O::sqrt(O::add(O::add(O::mul(c, c), O::mul(gn2, hh)),
                                 T(1e-30))));
  }
  aux[at.c] = v;
  flags[at.c] = (uint8_t)((c > T(0) ? 1 : 0) | (crosses ? 2 : 0));
}

// one step: the subcell relaxation on crossing cells, the upwind PDE (its
// Godunov branch by the sign of phi0) elsewhere
template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
reinit_step(const T* __restrict__ psi, const T* __restrict__ aux,
            const uint8_t* __restrict__ flags, T* __restrict__ out, int H,
            int W, T dtau, T dth) {
  using O = R<T>;
  Cell at;
  if (!locate(H, W, at)) return;
  const T c = __ldg(psi + at.c);
  const T v = __ldg(aux + at.c);
  const uint8_t f = __ldg(flags + at.c);
  T r;
  if (f & 2) {
    // sign(phi0) is +-1 on a crossing cell (phi0 != 0 there)
    const T s = (f & 1) ? T(1) : T(-1);
    r = O::sub(c, O::mul(dth, O::sub(O::mul(s, fabs(c)), v)));
  } else {
    const T up = __ldg(psi + at.up), dn = __ldg(psi + at.dn),
            lf = __ldg(psi + at.lf), rt = __ldg(psi + at.rt);
    const T a = O::sub(c, up), b = O::sub(dn, c), cc = O::sub(c, lf),
            d = O::sub(rt, c);
    T g;
    if (f & 1)
      g = O::sqrt(O::add(nmax(sq(pos(a)), sq(neg(b))),
                         nmax(sq(pos(cc)), sq(neg(d)))));
    else
      g = O::sqrt(O::add(nmax(sq(neg(a)), sq(pos(b))),
                         nmax(sq(neg(cc)), sq(pos(d)))));
    r = O::sub(c, O::mul(O::mul(dtau, v), O::sub(g, T(1))));
  }
  out[at.c] = r;
}

template <typename T>
cudaError_t launch(const T* phi, T* aux, uint8_t* flags, T* buf0, T* buf1,
                   int B, int H, int W, int steps, double dtau, double h,
                   cudaStream_t s) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY,
                  B);
  reinit_prepass<T><<<grid, block, 0, s>>>(phi, aux, flags, H, W, (T)h,
                                           (T)(h * h), (T)(-1.5 * h),
                                           (T)(1.5 * h));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* src = phi;
  for (int n = 0; n < steps; ++n) {
    T* dst = (n & 1) ? buf1 : buf0;
    reinit_step<T><<<grid, block, 0, s>>>(src, aux, flags, dst, H, W,
                                          (T)dtau, (T)(dtau / h));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

// phi (B, H, W) -> the redistanced stack in buf0 (odd steps) or buf1 (even
// steps); aux (B, H, W) of phi's type and flags (B, H, W) bytes are
// scratch. f64 selects double. The prepass and the `steps` step launches
// go on `stream`, none of them synchronizing.
extern "C" cudaError_t cv_reinit(const void* phi, void* aux, void* flags,
                                 void* buf0, void* buf1, int B, int H, int W,
                                 int steps, double dtau, double h, int f64,
                                 void* stream) {
  if (B < 1 || B > kMaxFrames || H < 1 || W < 1 || steps < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (f64)
    return launch<double>((const double*)phi, (double*)aux, (uint8_t*)flags,
                          (double*)buf0, (double*)buf1, B, H, W, steps, dtau,
                          h, s);
  return launch<float>((const float*)phi, (float*)aux, (uint8_t*)flags,
                       (float*)buf0, (float*)buf1, B, H, W, steps, dtau, h,
                       s);
}
