// K4: one red-black iteration on a C-channel image plus the partials the
// next iteration needs.
//
// Replaces chan_vese_tpu/ops/pallas_sweep_mc.py::_kernel (reached through
// fused_iteration_mc). The launcher the wrapper calls runs sweep.cuh's
// single-sweep body with NC = C: the level set and the update stay scalar,
// the window holds the C channels of u0 beside phi, the swept cell
// computes the data term (the channel average of the weighted squared
// distances) from them, and the partials carry one s_uH per channel, C + 4
// slots in all, read from the same window.
//
// Bound on the card: device memory. Each iteration reads phi and the C
// channels of u0 and writes phi (8 + 4C B/pixel: 20 at RGB, against 12
// for K1); the design reads each channel once, in 16-byte vectors.

#include "redblack.cuh"
#include "sweep.cuh"

// K4 on sweep.cuh: geometry as cv_fused_iteration (fused.cu), for C
// channels (1..8).
extern "C" cudaError_t cv_fused_iteration_mc(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, unsigned int* counters, float* parts, int H, int W,
    int C, int TH, int TW, int PX, int PY, int cap, int nblocks, float mu,
    float nu, float eta2, float gdt, float eps, float eps2, float inv_pi,
    void* stream) {
  const cv::Params P = cv::mc_params(mu, nu, eta2, gdt, eps, eps2, inv_pi);
  return cv::launch_sweep_mc(phi, u0, cc, out, block_parts, counters, parts,
                             H, W, C, TH, TW, PX, PY, cap, nblocks, C + 4, P,
                             (cudaStream_t)stream);
}

// Blocks of K4's single-sweep body for C channels that fit on an SM at
// `threads` threads and `smem` dynamic bytes.
extern "C" cudaError_t cv_sweep_occupancy_mc(int C, int threads, int smem,
                                             int* blocks) {
  return cv::sweep_occupancy_mc(C, threads, smem, blocks);
}
