// K8 (scalar and batch modes): K7 on parity planes (2, 2, H/2, W/2), or
// (N, 2, 2, H/2, W/2) for a stack.
//
// Replaces chan_vese_tpu/ops/pallas_packed.py::_packed_resident_kernel and
// ::_packed_resident_batch_kernel (packed_resident_iterations and _batch).
// As K3 is to K2, the plane layout was a Mosaic workaround: the body is
// K7's with plane addressing (gaddr<true>) in every read and write.
//
// Bound on the card: as resident.cu; plane addressing splits each row of
// reads over two planes, which halves the coalescing of the L2 reads.

#include "resident.cuh"

extern "C" cudaError_t cv_packed_resident_iterations(CV_RESIDENT_ARGS) {
  return cv::launch_resident<true, 0>(CV_RESIDENT_STRUCTS, nblocks,
                                      (cudaStream_t)stream);
}

extern "C" cudaError_t cv_packed_resident_iterations_grid(int C,
                                                          int* max_blocks) {
  return cv::resident_grid<true, 0>(max_blocks);
}
