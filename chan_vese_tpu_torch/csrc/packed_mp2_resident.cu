// K10: K9's resident mode on parity planes (2, 2, 2, H/2, W/2), one plane
// set per level set.
//
// Replaces chan_vese_tpu/ops/pallas_packed.py::_packed_mp2_resident_kernel
// (packed_mp2_resident_iterations). As K8 is to K7, the plane layout was a
// Mosaic workaround: the body is mp2.cuh's mp2_resident_kernel with plane
// addressing (gaddr<true>) in every read and write.
//
// Bound on the card: as mp2_resident.cu; plane addressing splits each row
// of reads over two planes, which halves the coalescing of the L2 reads.

#include "mp2.cuh"

extern "C" cudaError_t cv_packed_mp2_resident_iterations(
    CV_MP2_RESIDENT_ARGS) {
  return cv::launch_mp2_resident<true>(CV_MP2_RESIDENT_STRUCTS, nblocks,
                                       (cudaStream_t)stream);
}

extern "C" cudaError_t cv_packed_mp2_resident_iterations_grid(
    int C, int* max_blocks) {
  return cv::mp2_resident_grid<true>(max_blocks);
}
