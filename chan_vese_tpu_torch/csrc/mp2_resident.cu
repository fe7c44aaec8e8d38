// K9, resident mode: `iters` coupled 4-phase iterations in one cooperative
// launch, with the four phase means exact at every iteration.
//
// Replaces chan_vese_tpu/ops/pallas_multiphase.py::_mp2_resident_kernel
// (mp2_resident_iterations). cv_mp2_resident_iterations runs mp2.cuh's
// tile body (mp2_tile_kernel) on the flat layout: each block keeps its
// tiles of phi0, phi1 and u0 in shared memory for the whole run, with two
// neighbour waits and one grid-wide step an iteration.
//
// Bound on the card: the operations of two cell updates, the forces and
// the phase sums a cell; the waits and the step are a fixed cost an
// iteration.

#include "mp2.cuh"

extern "C" cudaError_t cv_mp2_resident_iterations(CV_MP2_TILE_ARGS) {
  return cv::mp2_tile<false>(CV_MP2_TILE_CALL);
}

extern "C" cudaError_t cv_mp2_resident_iterations_grid(int C, int smem,
                                                       int* max_blocks) {
  return cv::mp2_tile<false>({}, {}, 0, smem, nullptr, max_blocks);
}
