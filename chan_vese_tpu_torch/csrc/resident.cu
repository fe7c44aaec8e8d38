// K7 (scalar and batch modes): exact-means resident iterations on a flat
// (H, W) image, or on each frame of an (N, H, W) stack, in one cooperative
// launch.
//
// Replaces chan_vese_tpu/ops/pallas_resident.py::_kernel (reached through
// resident_iterations) and ::_kernel_batch (resident_iterations_batch).
// cv_resident_iterations runs resident_tiles.cuh's tile body in the flat
// layout: each block keeps its tile in shared memory for the whole run,
// with rims passed between neighbours and one grid-wide step an
// iteration; batch mode deals the frames to groups of blocks that run side
// by side (ops/_cuda.py frame_groups), each group looping over its frames
// inside the launch as the reference's outer grid axis does, and writes
// each frame's last-iteration row. cv_resident_iterations_v1 is the first
// body (resident.cuh), the yardstick it is held against.
//
// Bound on the card: the operations of the cell updates and the means;
// the neighbour wait and the grid-wide step an iteration are a fixed cost
// that sets the pace below ~512^2.

#include "resident_tiles.cuh"

extern "C" cudaError_t cv_resident_iterations(CV_TILE_RESIDENT_ARGS) {
  return cv::tile_resident<false, 0>(CV_TILE_RESIDENT_CALL);
}

extern "C" cudaError_t cv_resident_iterations_grid(int C, int smem,
                                                   int* max_blocks) {
  return cv::tile_resident<false, 0>({}, {}, 0, smem, nullptr,
                                       max_blocks);
}

extern "C" cudaError_t cv_resident_iterations_v1(CV_RESIDENT_ARGS) {
  return cv::launch_resident<false, 0>(CV_RESIDENT_STRUCTS, nblocks,
                                       (cudaStream_t)stream);
}

extern "C" cudaError_t cv_resident_iterations_v1_grid(int C,
                                                      int* max_blocks) {
  return cv::resident_grid<false, 0>(max_blocks);
}
