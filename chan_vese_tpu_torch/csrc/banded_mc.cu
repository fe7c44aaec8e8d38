// K5: k red-black iterations per pass over device memory on a C-channel
// image, c1[C]/c2[C] frozen.
//
// Replaces chan_vese_tpu/ops/pallas_banded.py::_banded_mc_kernel and
// _banded_mc_kernel_fusej (whole-image mode, reached through
// banded_chunk_mc). K2's body (band.cuh) with NC = C: the channels enter
// the data term and the s_uH partials; partials are padded to the
// reference's 16 slots.
//
// Bound on the card: as K2, the rsqrt/divide pipe. Per chunk a block
// reads C + 1 values per window cell and writes one per owned cell (20
// B/pixel at RGB, against 12 for K2), once per k iterations.

#include "band.cuh"
#include "redblack.cuh"

// K5 on band.cuh: TH x TW tiles, PX x PY threads, windows of at most cap
// cells (ops/_cuda.py::band_geometry).
extern "C" cudaError_t cv_banded_chunk_mc(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int C, int k, int TH,
    int TW, int PX, int PY, int cap, float mu, float nu, float eta2,
    float gdt, float eps, float eps2, float inv_pi, void* stream) {
  const cv::Params P = cv::mc_params(mu, nu, eta2, gdt, eps, eps2, inv_pi);
  return cv::launch_band_mc<false>(phi, u0, cc, out, block_parts, parts, H,
                                   W, C, k, TH, TW, PX, PY, cap, 16, P,
                                   (cudaStream_t)stream, cv::Shard{});
}

// K5's shard-canvas mode on band.cuh.
extern "C" cudaError_t cv_banded_chunk_mc_shard(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int C, int k, int TH,
    int TW, int PX, int PY, int cap, float mu, float nu, float eta2,
    float gdt, float eps, float eps2, float inv_pi, int parity, int r0,
    int r1, int c0, int c1, int top, int bottom, int left, int right,
    void* stream) {
  const cv::Params P = cv::mc_params(mu, nu, eta2, gdt, eps, eps2, inv_pi);
  const cv::Shard S{parity, r0, r1, c0, c1, top, bottom, left, right};
  return cv::launch_band_mc<true>(phi, u0, cc, out, block_parts, parts, H,
                                  W, C, k, TH, TW, PX, PY, cap, 16, P,
                                  (cudaStream_t)stream, S);
}

// Blocks of K5's band kernel for C channels (shard: its shard-canvas mode)
// that fit on an SM at `threads` threads and `smem` dynamic bytes.
extern "C" cudaError_t cv_band_occupancy_mc(int C, int shard, int threads,
                                            int smem, int* blocks) {
  return shard ? cv::band_occupancy_mc<true>(C, threads, smem, blocks)
               : cv::band_occupancy_mc<false>(C, threads, smem, blocks);
}
