// K2: k red-black iterations per pass over device memory, c1/c2 frozen.
//
// Replaces chan_vese_tpu/ops/pallas_banded.py::_banded_kernel and
// _banded_kernel_fusej (whole-image mode, reached through banded_chunk).
// The TPU kernel streamed full-width row bands with 4k/2k-row halos; a
// 4K f32 row is 15 KB, so on Hopper a block owns a 2D tile and carries
// column halos too (redblack.cuh). `fuse` and `unroll` only changed the
// TPU grid and do not reach this kernel.
//
// Bound on the card: shared-memory bandwidth and the rsqrt/divide pipe,
// not DRAM: device memory moves 12 B/pixel once per k iterations, while
// every iteration re-reads each cell's 3x3 neighborhood from shared
// memory and recomputes the halo ((TH + 6k)(TW + 6k) / (TH TW) = 2.4x
// cells at k = 8, 64 x 128 tiles). The tile is as large as 227 KB of
// shared memory allows (10 B per window cell) to keep that factor down.

#include "redblack.cuh"

extern "C" cudaError_t cv_banded_chunk(
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
extern "C" cudaError_t cv_banded_chunk_shard(
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
