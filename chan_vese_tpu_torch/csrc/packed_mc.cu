// K6: the K5 chunk on parity planes: phi (2, 2, H/2, W/2), u0
// (C, 2, 2, H/2, W/2) channels-first.
//
// Replaces chan_vese_tpu/ops/pallas_packed.py::_packed_banded_mc_kernel
// and _packed_banded_mc_kernel_fusej (whole-image entry
// packed_banded_chunk_mc), the RGB main-path kernel at 4K. As K3, the
// plane layout was a Mosaic workaround; the body is K5's with plane
// addressing in the global loads and stores. Channel c's planes start at
// u0 + c H W, the same channel stride as the flat layout.
//
// Bound on the card: as K5. The launcher runs band.cuh's body with
// PACKED = true, bitwise K5's on the unpacked image.

#include "band.cuh"
#include "redblack.cuh"

// K6 on band.cuh: TH x TW tiles, PX x PY threads, windows of at most cap
// cells (ops/_cuda.py::band_geometry at the unpacked image's H x W).
extern "C" cudaError_t cv_packed_banded_chunk_mc(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int C, int k, int TH,
    int TW, int PX, int PY, int cap, float mu, float nu, float eta2,
    float gdt, float eps, float eps2, float inv_pi, void* stream) {
  const cv::Params P = cv::mc_params(mu, nu, eta2, gdt, eps, eps2, inv_pi);
  return cv::launch_band_mc<false, true>(phi, u0, cc, out, block_parts,
                                         parts, H, W, C, k, TH, TW, PX, PY,
                                         cap, 16, P, (cudaStream_t)stream,
                                         cv::Shard{});
}

// Blocks of K6's band kernel for C channels that fit on an SM at `threads`
// threads and `smem` dynamic bytes.
extern "C" cudaError_t cv_packed_band_occupancy_mc(int C, int threads,
                                                   int smem, int* blocks) {
  return cv::band_occupancy_mc<false, true>(C, threads, smem, blocks);
}
