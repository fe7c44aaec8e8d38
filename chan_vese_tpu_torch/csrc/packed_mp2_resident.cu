// K10: K9's resident mode on parity planes (2, 2, 2, H/2, W/2), one plane
// set per level set.
//
// Replaces chan_vese_tpu/ops/pallas_packed.py::_packed_mp2_resident_kernel
// (packed_mp2_resident_iterations). As K8 is to K7, the plane layout was a
// Mosaic workaround: the body is mp2.cuh's tile body with plane
// addressing (gaddr<true>) where the tiles are loaded and stored.
//
// Bound on the card: as mp2_resident.cu.

#include "mp2.cuh"

extern "C" cudaError_t cv_packed_mp2_resident_iterations(CV_MP2_TILE_ARGS) {
  return cv::mp2_tile<true>(CV_MP2_TILE_CALL);
}

extern "C" cudaError_t cv_packed_mp2_resident_iterations_grid(
    int C, int smem, int* max_blocks) {
  return cv::mp2_tile<true>({}, {}, 0, smem, nullptr, max_blocks);
}
