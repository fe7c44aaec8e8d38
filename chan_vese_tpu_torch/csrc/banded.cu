// K2: k red-black iterations per pass over device memory, c1/c2 frozen.
//
// Replaces chan_vese_tpu/ops/pallas_banded.py::_banded_kernel and
// _banded_kernel_fusej (whole-image mode, reached through banded_chunk).
// The TPU kernel streamed full-width row bands with 4k/2k-row halos; a
// 4K f32 row is 15 KB, so on Hopper a block owns a 2D tile and carries
// column halos too. `fuse` and `unroll` only changed the TPU grid and do
// not reach this kernel.
//
// Bound on the card: the update's arithmetic (the rsqrt/divide pipe), not
// DRAM: device memory moves 12 B/pixel once per k iterations, while every
// iteration updates each window cell. The launchers the wrappers call run
// band.cuh's body (2k halos, 8 B of shared memory a window cell, results
// held in registers, two or more blocks an SM); the `_v1` launchers keep
// the first body, redblack.cuh's chunk_kernel (4k/2k halos, 10 B a cell,
// one block an SM), as the yardstick the smoke and the cuda-marked tests
// hold the new one against.

#include "band.cuh"
#include "redblack.cuh"

// K2 on band.cuh (the launchers the wrappers call): TH x TW tiles, PX x PY
// threads, windows of at most cap cells (ops/_cuda.py::band_geometry).
extern "C" cudaError_t cv_banded_chunk(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int k, int TH, int TW,
    int PX, int PY, int cap, float mu, float nu, float l1, float l2,
    float eta2, float gdt, float eps, float eps2, float inv_pi,
    void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  return cv::launch_band<0, false>(phi, u0, cc, out, block_parts, parts, H,
                                   W, k, TH, TW, PX, PY, cap, 8, P,
                                   (cudaStream_t)stream, cv::Shard{});
}

// K2's shard-canvas mode on band.cuh: parity, crop and global-edge flags as
// cv_banded_chunk_shard_v1.
extern "C" cudaError_t cv_banded_chunk_shard(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int k, int TH, int TW,
    int PX, int PY, int cap, float mu, float nu, float l1, float l2,
    float eta2, float gdt, float eps, float eps2, float inv_pi, int parity,
    int r0, int r1, int c0, int c1, int top, int bottom, int left,
    int right, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  const cv::Shard S{parity, r0, r1, c0, c1, top, bottom, left, right};
  return cv::launch_band<0, true>(phi, u0, cc, out, block_parts, parts, H,
                                  W, k, TH, TW, PX, PY, cap, 8, P,
                                  (cudaStream_t)stream, S);
}

// Blocks of K2's band kernel (shard: its shard-canvas mode) that fit on an
// SM at `threads` threads and `smem` bytes of dynamic shared memory.
extern "C" cudaError_t cv_band_occupancy(int shard, int threads, int smem,
                                         int* blocks) {
  return shard ? cv::band_occupancy<0, true>(threads, smem, blocks)
               : cv::band_occupancy<0, false>(threads, smem, blocks);
}

// The first K2 body (redblack.cuh chunk_kernel, 4k/2k halos), kept under
// `_v1` names as the yardstick of the band.cuh launchers above: no wrapper
// or driver reaches it.

extern "C" cudaError_t cv_banded_chunk_v1(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int k, int TH, int TW,
    int cap, float mu, float nu, float l1, float l2, float eta2, float gdt,
    float eps, float eps2, float inv_pi, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  return cv::launch_chunk<false, 0>(phi, u0, cc, out, block_parts, parts, H,
                                    W, k, TH, TW, cap, 8, P,
                                    (cudaStream_t)stream);
}

// K2's shard-canvas mode: k frozen-means iterations on a shard canvas whose
// halo (D = 4 comm_k) covers the chunk's reach, with parity, crop and
// global-edge flags as cv_fused_iteration_shard (redblack.cuh, SHARD).
//
// Replaces chan_vese_tpu/ops/pallas_banded.py::_banded_kernel's sharded
// branch (reached through banded_chunk_sharded). The TPU kernel streamed
// full-width bands of the canvas, so it never needed column halos; here the
// tiles carry them, and the left/right rim refresh runs per window. Bound:
// as the whole-image mode.
extern "C" cudaError_t cv_banded_chunk_shard_v1(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int k, int TH, int TW,
    int cap, float mu, float nu, float l1, float l2, float eta2, float gdt,
    float eps, float eps2, float inv_pi, int parity, int r0, int r1, int c0,
    int c1, int top, int bottom, int left, int right, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  const cv::Shard S{parity, r0, r1, c0, c1, top, bottom, left, right};
  return cv::launch_chunk<false, 0, true>(phi, u0, cc, out, block_parts,
                                          parts, H, W, k, TH, TW, cap, 8, P,
                                          (cudaStream_t)stream, 1, S);
}
