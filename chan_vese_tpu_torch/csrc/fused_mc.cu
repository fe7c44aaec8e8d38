// K4: one red-black iteration on a C-channel image plus the partials the
// next iteration needs.
//
// Replaces chan_vese_tpu/ops/pallas_sweep_mc.py::_kernel (reached through
// fused_iteration_mc). The body is the shared chunk kernel of redblack.cuh
// at k = 1 with NC = C: the level set and the update stay scalar, the data
// term averages the C channels' weighted squared distances (computed once
// at window load), and the partials carry one s_uH per channel, C + 4
// slots in all.
//
// Bound on the card: device memory. Each iteration reads phi and the C
// channels of u0 and writes phi (8 + 4C B/pixel: 20 at RGB, against 12
// for K1), so the design keeps f, the half-sweep state and the partials
// on chip as K1 does; the extra bytes are the channels, read once each.

#include "redblack.cuh"

extern "C" cudaError_t cv_fused_iteration_mc(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int C, int TH, int TW,
    int cap, float mu, float nu, float eta2, float gdt, float eps,
    float eps2, float inv_pi, void* stream) {
  const cv::Params P = cv::mc_params(mu, nu, eta2, gdt, eps, eps2, inv_pi);
  return cv::launch_chunk_mc<false>(phi, u0, cc, out, block_parts, parts, H,
                                    W, C, 1, TH, TW, cap, C + 4, P,
                                    (cudaStream_t)stream);
}
