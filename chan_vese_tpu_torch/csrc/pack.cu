// K15 and K16: the parity pack (N, H, W) -> (N, 2, 2, H/2, W/2), plane
// (a, b) holding x[2r + a, 2c + b], and its inverse, for f32 images, frame
// stacks and channels-first images alike (N = 1 for one image).
//
// Replaces scripts/bench_pack.py::_pack_kernel_sl / _pack_kernel_rs
// (through _mk_pack) and ::_unpack_kernel_st (through _mk_unpack), the
// Pallas versions of the pack every packed route runs (K3, K6, K8, K10,
// K13 pack phi and u0 once a call and unpack the result).
//
// Bound on the card: device memory, each element read once and written
// once (8 B/element; 2 x 33.2 MB at 4K). K15: each thread reads V = 4 (or
// 2) adjacent columns of one row as one float4 (float2), neighbouring
// threads on neighbouring addresses, and writes the even columns to plane
// (a, 0) and the odd ones to plane (a, 1), V/2 each, again coalesced. K16
// reads the two halves back and writes the V columns. blockIdx.x covers a
// row's column groups and a grid-stride loop over blockIdx.y the stacked
// rows n H + i (N H < 2^31), so a thread divides once per row, in 32 bits
// (64-bit divisions per element held the copy at 2x its bound). Pure
// copies through registers, so both are bitwise the
// reshape-and-permute (denormals, signed zeros and NaN payloads kept).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kPackThreads = 256;
constexpr int kMaxGridY = 65535;

template <int V>
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const float* __restrict__ x, float* __restrict__ out, int N,
            int H, int W) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= W / V) return;
  const int64_t wp = W / 2, plane = (int64_t)(H / 2) * wp;
  for (int row = blockIdx.y; row < N * H; row += gridDim.y) {
    const int n = row / H, i = row - n * H;
    const float* src = x + (int64_t)row * W + q * V;
    float* even = out + ((int64_t)n * 4 + (i & 1) * 2) * plane +
                  (int64_t)(i >> 1) * wp + q * (V / 2);
    float* odd = even + plane;
    if constexpr (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      *reinterpret_cast<float2*>(even) = make_float2(v.x, v.z);
      *reinterpret_cast<float2*>(odd) = make_float2(v.y, v.w);
    } else {
      const float2 v = *reinterpret_cast<const float2*>(src);
      *even = v.x;
      *odd = v.y;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kPackThreads)
unpack_kernel(const float* __restrict__ planes, float* __restrict__ out,
              int N, int H, int W) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= W / V) return;
  const int64_t wp = W / 2, plane = (int64_t)(H / 2) * wp;
  for (int row = blockIdx.y; row < N * H; row += gridDim.y) {
    const int n = row / H, i = row - n * H;
    const float* even = planes + ((int64_t)n * 4 + (i & 1) * 2) * plane +
                        (int64_t)(i >> 1) * wp + q * (V / 2);
    const float* odd = even + plane;
    float* dst = out + (int64_t)row * W + q * V;
    if constexpr (V == 4) {
      const float2 e = *reinterpret_cast<const float2*>(even);
      const float2 o = *reinterpret_cast<const float2*>(odd);
      *reinterpret_cast<float4*>(dst) = make_float4(e.x, o.x, e.y, o.y);
    } else {
      *reinterpret_cast<float2*>(dst) = make_float2(*even, *odd);
    }
  }
}

cudaError_t launch(bool pack, const float* src, float* dst, int N, int H,
                   int W, int vec, void* stream) {
  if (N < 1 || H < 2 || W < 2 || (H & 1) || (W & 1) ||
      (vec != 2 && vec != 4) || W % vec || (int64_t)N * H > INT_MAX)
    return cudaErrorInvalidValue;
  const int rows = N * H;
  const dim3 grid((W / vec + kPackThreads - 1) / kPackThreads,
                  rows < kMaxGridY ? rows : kMaxGridY);
  const cudaStream_t s = (cudaStream_t)stream;
  if (pack) {
    if (vec == 4)
      pack_kernel<4><<<grid, kPackThreads, 0, s>>>(src, dst, N, H, W);
    else
      pack_kernel<2><<<grid, kPackThreads, 0, s>>>(src, dst, N, H, W);
  } else {
    if (vec == 4)
      unpack_kernel<4><<<grid, kPackThreads, 0, s>>>(src, dst, N, H, W);
    else
      unpack_kernel<2><<<grid, kPackThreads, 0, s>>>(src, dst, N, H, W);
  }
  return cudaGetLastError();
}

}  // namespace

// x (N, H, W) -> out (N, 2, 2, H/2, W/2); vec = 4 needs W % 4 == 0, x
// 16-byte and out 8-byte aligned; vec = 2 needs x 8-byte aligned
extern "C" cudaError_t cv_pack_planes(const float* x, float* out, int N,
                                      int H, int W, int vec, void* stream) {
  return launch(true, x, out, N, H, W, vec, stream);
}

// planes (N, 2, 2, H/2, W/2) -> out (N, H, W); vec = 4 needs W % 4 == 0,
// planes 8-byte and out 16-byte aligned; vec = 2 needs out 8-byte aligned
extern "C" cudaError_t cv_unpack_planes(const float* planes, float* out,
                                        int N, int H, int W, int vec,
                                        void* stream) {
  return launch(false, planes, out, N, H, W, vec, stream);
}
