// K7 (mc mode): exact-means resident iterations on a flat C-channel image,
// u0 channels-first (C, H, W), in one cooperative launch.
//
// Replaces chan_vese_tpu/ops/pallas_resident.py::_kernel_mc (reached
// through resident_iterations_mc): per-channel means of the current phi
// every iteration, the Chan-Sandberg-Vese data term with weights l[c]/C,
// partials rows of C + 4 slots. The runtime C (1..8) picks the instance.
//
// Bound on the card: as resident.cu; each channel adds one read of u0 per
// half-sweep and one f64 sum per block to the fixed reduction.

#include "resident.cuh"

extern "C" cudaError_t cv_resident_iterations_mc(CV_RESIDENT_ARGS) {
  return cv::launch_resident_mc<false>(C, CV_RESIDENT_STRUCTS, nblocks,
                                       (cudaStream_t)stream);
}

extern "C" cudaError_t cv_resident_iterations_mc_grid(int C,
                                                      int* max_blocks) {
  return cv::resident_grid_mc<false>(C, max_blocks);
}
