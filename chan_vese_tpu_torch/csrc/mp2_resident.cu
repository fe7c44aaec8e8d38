// K9, resident mode: `iters` coupled 4-phase iterations in one cooperative
// launch, with the four phase means exact at every iteration.
//
// Replaces chan_vese_tpu/ops/pallas_multiphase.py::_mp2_resident_kernel
// (mp2_resident_iterations). The body is mp2.cuh's mp2_resident_kernel on
// the flat layout: three grid syncs per iteration (phi0 red; phi0 black
// with phi1 red; phi1 black with the phase sums).
//
// Bound on the card: the fixed cost of the grid syncs and the all-block
// means reduction per iteration, then the L2 reads of the neighbourhoods.

#include "mp2.cuh"

extern "C" cudaError_t cv_mp2_resident_iterations(CV_MP2_RESIDENT_ARGS) {
  return cv::launch_mp2_resident<false>(CV_MP2_RESIDENT_STRUCTS, nblocks,
                                        (cudaStream_t)stream);
}

extern "C" cudaError_t cv_mp2_resident_iterations_grid(int C,
                                                       int* max_blocks) {
  return cv::mp2_resident_grid<false>(max_blocks);
}
