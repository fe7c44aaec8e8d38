// K8 (mc mode): K7's mc mode on parity planes: phi (2, 2, H/2, W/2), u0
// (C, 2, 2, H/2, W/2) channels-first.
//
// Replaces chan_vese_tpu/ops/pallas_packed.py::_packed_resident_mc_kernel
// (packed_resident_iterations_mc). Channel c's planes start at
// u0 + c H W, the stride of the flat layout, as in K6.
//
// Bound on the card: as resident_mc.cu, with packed_resident.cu's halved
// coalescing.

#include "resident.cuh"

extern "C" cudaError_t cv_packed_resident_iterations_mc(CV_RESIDENT_ARGS) {
  return cv::launch_resident_mc<true>(C, CV_RESIDENT_STRUCTS, nblocks,
                                      (cudaStream_t)stream);
}

extern "C" cudaError_t cv_packed_resident_iterations_mc_grid(
    int C, int* max_blocks) {
  return cv::resident_grid_mc<true>(C, max_blocks);
}
