// K1: one red-black iteration plus the partials the next iteration needs.
//
// Replaces chan_vese_tpu/ops/pallas_sweep.py::_fused_band_kernel (whole-
// image mode, reached through fused_iteration; batch mode, reached through
// fused_iteration_batch, whose frame axis is the leading grid axis; shard-
// canvas mode, reached through fused_iteration(parity, crop, edges) with
// _resync_rim).
//
// Bound on the card: device memory. Each iteration reads phi and u0 and
// writes phi (12 B/pixel), so at 4K one call moves about 100 MB. The
// launchers run sweep.cuh's single-sweep body (a halo of 2, small blocks,
// 16-byte window loads, u0 read once, the partials summed in the same
// launch).

#include "redblack.cuh"
#include "sweep.cuh"

// K1 on sweep.cuh (the launchers the wrappers call): TH x TW tiles, PX x PY
// threads, windows of at most cap cells, nblocks blocks a frame
// (ops/_cuda.py::sweep_geometry; cudaErrorInvalidValue where the grid
// differs), counters: one zero word of the stream's (_cuda.launch_sweep).
extern "C" cudaError_t cv_fused_iteration(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, unsigned int* counters, float* parts, int H, int W,
    int TH, int TW, int PX, int PY, int cap, int nblocks, float mu, float nu,
    float l1, float l2, float eta2, float gdt, float eps, float eps2,
    float inv_pi, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  return cv::launch_sweep<0, false>(phi, u0, cc, out, block_parts, counters,
                                    parts, H, W, 1, TH, TW, PX, PY, cap,
                                    nblocks, 8, P, (cudaStream_t)stream,
                                    cv::Shard{0, 0, H, 0, W, 0, 0, 0, 0});
}

// K1's batch mode on sweep.cuh: one red-black iteration of each frame of an
// (N, H, W) stack with per-frame means (cc is (N, 2)) and per-frame
// partials (parts is (N, 8)), N counters; each frame bitwise the
// single-image launch.
extern "C" cudaError_t cv_fused_iteration_batch(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, unsigned int* counters, float* parts, int H, int W,
    int N, int TH, int TW, int PX, int PY, int cap, int nblocks, float mu,
    float nu, float l1, float l2, float eta2, float gdt, float eps,
    float eps2, float inv_pi, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  return cv::launch_sweep<0, false>(phi, u0, cc, out, block_parts, counters,
                                    parts, H, W, N, TH, TW, PX, PY, cap,
                                    nblocks, 8, P, (cudaStream_t)stream,
                                    cv::Shard{0, 0, H, 0, W, 0, 0, 0, 0});
}

// K1's shard-canvas mode on sweep.cuh: one red-black iteration on a
// halo-padded shard canvas of the sharded solver, with the lattice offset
// by `parity`, the tiles and partials on the crop [r0, r1) x [c0, c1), the
// depth-2 replica rim refreshed after each half-sweep on the flagged
// global edges and the canvas outside the crop copied through.
extern "C" cudaError_t cv_fused_iteration_shard(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, unsigned int* counters, float* parts, int H, int W,
    int TH, int TW, int PX, int PY, int cap, int nblocks, float mu, float nu,
    float l1, float l2, float eta2, float gdt, float eps, float eps2,
    float inv_pi, int parity, int r0, int r1, int c0, int c1, int top,
    int bottom, int left, int right, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  const cv::Shard S{parity, r0, r1, c0, c1, top, bottom, left, right};
  return cv::launch_sweep<0, true>(phi, u0, cc, out, block_parts, counters,
                                   parts, H, W, 1, TH, TW, PX, PY, cap,
                                   nblocks, 8, P, (cudaStream_t)stream, S);
}

// Blocks of K1's single-sweep body (shard: its shard-canvas mode) that fit
// on an SM at `threads` threads and `smem` dynamic bytes.
extern "C" cudaError_t cv_sweep_occupancy(int shard, int threads, int smem,
                                          int* blocks) {
  return shard ? cv::sweep_occupancy<0, true>(threads, smem, blocks)
               : cv::sweep_occupancy<0, false>(threads, smem, blocks);
}

// Name of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* cv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
