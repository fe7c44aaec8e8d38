// K7 (scalar and batch modes): exact-means resident iterations on a flat
// (H, W) image, or on each frame of an (N, H, W) stack in turn, in one
// cooperative launch.
//
// Replaces chan_vese_tpu/ops/pallas_resident.py::_kernel (reached through
// resident_iterations) and ::_kernel_batch (resident_iterations_batch).
// The body is resident.cuh's persistent kernel in the flat layout; batch
// mode loops over the frames inside the launch, as the reference's outer
// grid axis does, and writes each frame's last-iteration row.
//
// Bound on the card: at 256^2-1024^2 the fixed cost of two grid syncs and
// an all-block reduction per iteration, then L2 traffic of the 3x3 reads;
// the whole working set (phi twice, u0) stays in L2.

#include "resident.cuh"

extern "C" cudaError_t cv_resident_iterations(CV_RESIDENT_ARGS) {
  return cv::launch_resident<false, 0>(CV_RESIDENT_STRUCTS, nblocks,
                                       (cudaStream_t)stream);
}

extern "C" cudaError_t cv_resident_iterations_grid(int C, int* max_blocks) {
  return cv::resident_grid<false, 0>(max_blocks);
}
