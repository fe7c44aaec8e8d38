// K8 (scalar and batch modes): K7 on parity planes (2, 2, H/2, W/2), or
// (N, 2, 2, H/2, W/2) for a stack.
//
// Replaces chan_vese_tpu/ops/pallas_packed.py::_packed_resident_kernel and
// ::_packed_resident_batch_kernel (packed_resident_iterations and _batch).
// As K3 is to K2, the plane layout was a Mosaic workaround: the body is
// K7's tile body (resident_tiles.cuh) with plane addressing
// (gaddr<true>) where a frame is loaded and stored (and u0 read through
// L2); the sweeps run on the shared-memory tiles, whatever the layout.
//
// Bound on the card: as resident.cu.

#include "resident_tiles.cuh"

extern "C" cudaError_t cv_packed_resident_iterations(CV_TILE_RESIDENT_ARGS) {
  return cv::tile_resident<true, 0>(CV_TILE_RESIDENT_CALL);
}

extern "C" cudaError_t cv_packed_resident_iterations_grid(int C, int smem,
                                                          int* max_blocks) {
  return cv::tile_resident<true, 0>({}, {}, 0, smem, nullptr,
                                      max_blocks);
}
