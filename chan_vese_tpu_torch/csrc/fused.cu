// K1: one red-black iteration plus the partials the next iteration needs.
//
// Replaces chan_vese_tpu/ops/pallas_sweep.py::_fused_band_kernel (whole-
// image mode, reached through fused_iteration). The body is the shared
// chunk kernel of redblack.cuh at k = 1: a tile with a 4-row/col halo up
// and left and 2 down and right, one red and one black half-sweep in
// shared memory, partials of the transition.
//
// Bound on the card: device memory. Each iteration reads phi and u0 and
// writes phi (12 B/pixel, plus the halo overlap of 1.1x at 64 x 128
// tiles), so at 4K one call moves about 110 MB; the design keeps f, the
// half-sweep state and the partials on chip so nothing else touches DRAM.

#include "redblack.cuh"

extern "C" cudaError_t cv_fused_iteration(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int TH, int TW,
    int cap, float mu, float nu, float l1, float l2, float eta2, float gdt,
    float eps, float eps2, float inv_pi, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  return cv::launch_chunk<false, 0>(phi, u0, cc, out, block_parts, parts, H,
                                    W, 1, TH, TW, cap, 8, P,
                                    (cudaStream_t)stream);
}

// K1's batch mode: one red-black iteration of each frame of an (N, H, W)
// stack in one launch, with per-frame means (cc is (N, 2)) and per-frame
// partials (parts is (N, 8)).
//
// Replaces chan_vese_tpu/ops/pallas_sweep.py::_fused_band_kernel with
// batched=True (reached through fused_iteration_batch), whose frame axis
// is the leading grid axis. Here it is blockIdx.z of the same tiles; the
// reduction runs one block per frame, so each frame is bitwise the
// single-image launch. Bound: as above, 12 B/pixel per frame.
extern "C" cudaError_t cv_fused_iteration_batch(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int N, int TH, int TW,
    int cap, float mu, float nu, float l1, float l2, float eta2, float gdt,
    float eps, float eps2, float inv_pi, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  return cv::launch_chunk<false, 0>(phi, u0, cc, out, block_parts, parts, H,
                                    W, 1, TH, TW, cap, 8, P,
                                    (cudaStream_t)stream, N);
}

// K1's shard-canvas mode: one red-black iteration on a halo-padded shard
// canvas of the sharded solver, with the lattice offset by `parity`, the
// tiles and partials on the crop [r0, r1) x [c0, c1), and the depth-2
// replica rim refreshed after each half-sweep on the flagged global edges.
//
// Replaces chan_vese_tpu/ops/pallas_sweep.py::_fused_band_kernel with
// parity, crop and edges (reached through fused_iteration(parity, crop,
// edges), with _resync_rim). Bound: as the whole-image mode, 12 B/pixel of
// the crop plus the canvas rim.
extern "C" cudaError_t cv_fused_iteration_shard(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int TH, int TW, int cap,
    float mu, float nu, float l1, float l2, float eta2, float gdt, float eps,
    float eps2, float inv_pi, int parity, int r0, int r1, int c0, int c1,
    int top, int bottom, int left, int right, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  const cv::Shard S{parity, r0, r1, c0, c1, top, bottom, left, right};
  return cv::launch_chunk<false, 0, true>(phi, u0, cc, out, block_parts,
                                          parts, H, W, 1, TH, TW, cap, 8, P,
                                          (cudaStream_t)stream, 1, S);
}

// Name of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* cv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
