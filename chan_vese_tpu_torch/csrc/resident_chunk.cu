// K13: k frozen-means red-black iterations with the whole image resident,
// in the flat layout (cv_resident_chunk) or on parity planes
// (cv_packed_resident_chunk), and the partials (8,) of the last iteration.
//
// Replaces chan_vese_tpu/ops/pallas_packed.py::_flat_chunk_kernel and
// ::_packed_chunk_kernel (reached through packed_chunk), the reference's
// A/B of the two layouts at one residency. The body is K7/K8's tile body
// (resident_tiles.cuh tile_resident_kernel<PACKED, 0, true>) in its
// frozen-means mode: the image lives in shared memory across the SMs, one
// tile a block, the counterpart of the TPU kernel's whole-image VMEM
// residency; (c1, c2) come from cc and stay fixed, so the data term is
// computed once into the tile's shared memory, blocks pass tagged rims to
// their neighbours every iteration and take no grid-wide step until the
// last iteration, whose H sums and row sums one step adds in block order.
// The layout changes only where the tile is loaded and stored
// (gaddr<PACKED>).
//
// Bound on the card: per iteration 55 operations a cell update and the
// data term (chip_smoke.py::bound); an iteration's chain of four block
// barriers and two neighbour waits sets the pace at these sizes. Device
// memory is touched when the tile is loaded and stored.

#include "resident_tiles.cuh"

// The tile body's launchers: pointers phi_in, out, u0, cc, scratch, rims,
// sync, parts; nblocks, H, W, k, the tiling (TH, TW, GX, u0 resident,
// dynamic bytes); the nine parameters; the stream. `_grid`: (C, dynamic
// bytes, int* co-resident blocks).
#define CV_TILE_CHUNK_ARGS                                                 \
  const float *phi_in, float *out, const float *u0, const float *cc,      \
      double *scratch, void *rims, unsigned *sync, float *parts,          \
      int nblocks, int H, int W, int k, int TH, int TW, int GX, int u0res, \
      int smem, float mu, float nu, float l1, float l2, float eta2,       \
      float gdt, float eps, float eps2, float inv_pi, void *stream
#define CV_TILE_CHUNK_CALL                                                  \
  cv::TileResidentArgs{phi_in, out, u0, nullptr, cc, scratch,              \
                       (cv::Word*)rims, sync, parts, 1, H, W, k, k, 0, 8,  \
                       TH, TW, GX, GX > 0 ? nblocks / GX : 0, u0res},      \
      cv::Params{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi}, nblocks,   \
      smem, (cudaStream_t)stream, nullptr

extern "C" cudaError_t cv_resident_chunk(CV_TILE_CHUNK_ARGS) {
  return cv::tile_resident<false, 0, true>(CV_TILE_CHUNK_CALL);
}

extern "C" cudaError_t cv_packed_resident_chunk(CV_TILE_CHUNK_ARGS) {
  return cv::tile_resident<true, 0, true>(CV_TILE_CHUNK_CALL);
}

extern "C" cudaError_t cv_resident_chunk_grid(int C, int smem,
                                              int* max_blocks) {
  return cv::tile_resident<false, 0, true>({}, {}, 0, smem, nullptr,
                                           max_blocks);
}

extern "C" cudaError_t cv_packed_resident_chunk_grid(int C, int smem,
                                                     int* max_blocks) {
  return cv::tile_resident<true, 0, true>({}, {}, 0, smem, nullptr,
                                          max_blocks);
}
