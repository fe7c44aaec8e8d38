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

// K1's force mode with `parity`: the same sweep with the red-black lattice
// offset, cell (i, j) red iff (i + j + parity) is even.
//
// Replaces chan_vese_tpu/ops/pallas_sweep.py::_fused_band_kernel in its
// data_is_f mode with a parity (fused_sweep(parity=...) :467, the lattice
// offset in c[2] :301-302). The reference takes the parity only: no crop
// and no rim. Here that is redblack.cuh's shard-canvas instantiation with
// the crop the whole image and no edge flags, so the tiles, windows and
// partials are the whole-image ones and no rim is refreshed; the
// whole-image instantiation above stays as it was. Bound: as above.
extern "C" cudaError_t cv_fused_sweep_shard(
    const float* phi, const float* f, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int TH, int TW, int cap,
    float mu, float nu, float l1, float l2, float eta2, float gdt, float eps,
    float eps2, float inv_pi, int parity, int r0, int r1, int c0, int c1,
    int top, int bottom, int left, int right, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  const cv::Shard S{parity, r0, r1, c0, c1, top, bottom, left, right};
  return cv::launch_chunk<false, cv::kForce, true>(
      phi, f, cc, out, block_parts, parts, H, W, 1, TH, TW, cap, 8, P,
      (cudaStream_t)stream, 1, S);
}
