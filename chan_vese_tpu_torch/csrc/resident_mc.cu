// K7 (mc mode): exact-means resident iterations on a flat C-channel image,
// u0 channels-first (C, H, W), in one cooperative launch.
//
// Replaces chan_vese_tpu/ops/pallas_resident.py::_kernel_mc (reached
// through resident_iterations_mc): per-channel means of the current phi
// every iteration, the Chan-Sandberg-Vese data term with weights l[c]/C,
// partials rows of C + 4 slots. The runtime C (1..8) picks the instance.
// cv_resident_iterations_mc runs resident_tiles.cuh's tile body (u0's C
// planes kept in shared memory where they fit, else read through L2).
//
// Bound on the card: as resident.cu; each channel adds a distance to the
// data term and one f64 sum a block to the grid-wide step.

#include "resident_tiles.cuh"

extern "C" cudaError_t cv_resident_iterations_mc(CV_TILE_RESIDENT_ARGS) {
  return cv::tile_resident_mc<false>(C, CV_TILE_RESIDENT_CALL);
}

extern "C" cudaError_t cv_resident_iterations_mc_grid(int C, int smem,
                                                      int* max_blocks) {
  return cv::tile_resident_mc<false>(C, {}, {}, 0, smem, nullptr,
                                        max_blocks);
}
