// K8 (mc mode): K7's mc mode on parity planes: phi (2, 2, H/2, W/2), u0
// (C, 2, 2, H/2, W/2) channels-first.
//
// Replaces chan_vese_tpu/ops/pallas_packed.py::_packed_resident_mc_kernel
// (packed_resident_iterations_mc). Channel c's planes start at
// u0 + c H W, the stride of the flat layout, as in K6. The body is
// resident_tiles.cuh's tile body with plane addressing at the loads and
// stores.
//
// Bound on the card: as resident_mc.cu.

#include "resident_tiles.cuh"

extern "C" cudaError_t cv_packed_resident_iterations_mc(
    CV_TILE_RESIDENT_ARGS) {
  return cv::tile_resident_mc<true>(C, CV_TILE_RESIDENT_CALL);
}

extern "C" cudaError_t cv_packed_resident_iterations_mc_grid(
    int C, int smem, int* max_blocks) {
  return cv::tile_resident_mc<true>(C, {}, {}, 0, smem, nullptr,
                                       max_blocks);
}
