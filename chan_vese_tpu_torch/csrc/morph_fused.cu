// K12: K11's acwe kind with the force computed in the kernel from the image
// and four scalars, plus the region partials of the final state.
//
// Replaces chan_vese_tpu/ops/pallas_morph.py::_morph_fused_kernel (reached
// through morph_chunk_fused). The window loads u0 instead of a force plane
// and takes f = l1 (u0 - c_in)^2 - l2 (u0 - c_out)^2 per cell, rounded op
// by op as the plain version is, so its sign is the plain version's. The
// partials (sum ls, sum u0 ls) come from owned cells only, per block in
// f64, then a one-block fixed-order pass (redblack.cuh), so n_in is exact
// and the result is deterministic.
//
// Bound on the card: as K11's acwe kind (morph_band.cu); device memory
// moves 12 B/pixel per launch and no force plane is written or read
// between chunks.

#include "morph.cuh"

extern "C" cudaError_t cv_morph_fused_chunk(
    const float* ls, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int k, int s,
    int parity0, int halo, int TH, int TW, int cap, void* stream) {
  return cv::launch_morph<cv::kMorphFused>(
      ls, u0, cc, out, block_parts, parts, H, W, k, s, parity0, 0, 0.0f, halo,
      TH, TW, cap, (cudaStream_t)stream);
}
