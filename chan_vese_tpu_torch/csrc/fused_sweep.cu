// K1, force mode: one red-black sweep on a precomputed force f, plus the
// partials of the transition.
//
// Replaces chan_vese_tpu/ops/pallas_sweep.py::_fused_band_kernel in its
// data_is_f mode (reached through fused_sweep), the per-level-set sweep of
// the multiphase `sweeps` route. The body is fused.cu's chunk kernel at
// k = 1 with NC = kForce: the window loads f where K1 computes the data
// term. Partials [f H, H, s_dphi2, flips, s_absdphi, 0, 0, 0]; the first
// two carry no meaning in this mode, as in the reference.
//
// Bound on the card: device memory, as fused.cu (phi and f read, phi
// written: 12 B/pixel plus the halo overlap).

#include "redblack.cuh"

extern "C" cudaError_t cv_fused_sweep(
    const float* phi, const float* f, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int TH, int TW,
    int cap, float mu, float nu, float l1, float l2, float eta2, float gdt,
    float eps, float eps2, float inv_pi, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  return cv::launch_chunk<false, cv::kForce>(phi, f, cc, out, block_parts,
                                             parts, H, W, 1, TH, TW, cap, 8,
                                             P, (cudaStream_t)stream);
}
