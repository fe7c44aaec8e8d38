// K13: k frozen-means red-black iterations with the whole image resident,
// in the flat layout (cv_resident_chunk) or on parity planes
// (cv_packed_resident_chunk), and the partials (8,) of the last iteration.
//
// Replaces chan_vese_tpu/ops/pallas_packed.py::_flat_chunk_kernel and
// ::_packed_chunk_kernel (reached through packed_chunk), the reference's
// A/B of the two layouts at one residency. The body is resident.cuh's
// persistent cooperative kernel in its frozen-means mode: the
// counterpart of "the whole image VMEM-resident" is one launch whose
// working set (phi twice, u0) stays in the 50 MB L2, as for K7/K8; the
// layout changes only the addressing (gaddr<PACKED>).
//
// Bound on the card: at 512^2-1024^2 the two grid syncs an iteration,
// then L2 traffic of the 3x3 reads; device memory is touched once a
// launch (12 B/pixel).

#include "resident.cuh"

namespace {

template <bool PACKED>
cudaError_t chunk(const float* phi_in, float* out, float* tmp,
                  const float* u0, const float* cc, double* scratch,
                  float* parts, int nblocks, int H, int W, int k, cv::Params P,
                  void* stream) {
  // one frame, one row (unroll = k: the last iteration's), 8 slots
  const cv::ResidentArgs a{phi_in, out, tmp, u0, nullptr, nullptr, scratch,
                           parts, 1, H, W, k, k, 0, 8, cc};
  return cv::launch_resident<PACKED, 0>(a, P, nblocks, (cudaStream_t)stream);
}

}  // namespace

#define CV_CHUNK_ARGS                                                     \
  const float *phi_in, float *out, float *tmp, const float *u0,          \
      const float *cc, double *scratch, float *parts, int nblocks, int H, \
      int W, int k, float mu, float nu, float l1, float l2, float eta2,  \
      float gdt, float eps, float eps2, float inv_pi, void *stream
#define CV_CHUNK_CALL                                                  \
  phi_in, out, tmp, u0, cc, scratch, parts, nblocks, H, W, k,         \
      cv::Params{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi}, stream

extern "C" cudaError_t cv_resident_chunk(CV_CHUNK_ARGS) {
  return chunk<false>(CV_CHUNK_CALL);
}

extern "C" cudaError_t cv_packed_resident_chunk(CV_CHUNK_ARGS) {
  return chunk<true>(CV_CHUNK_CALL);
}

extern "C" cudaError_t cv_resident_chunk_grid(int C, int* max_blocks) {
  return cv::resident_grid<false, 0>(max_blocks);
}

extern "C" cudaError_t cv_packed_resident_chunk_grid(int C,
                                                     int* max_blocks) {
  return cv::resident_grid<true, 0>(max_blocks);
}
