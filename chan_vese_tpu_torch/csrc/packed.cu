// K3: the K2 chunk on parity planes P[a][b][r, c] = phi[2r + a, 2c + b],
// stored as (2, 2, H/2, W/2).
//
// Replaces chan_vese_tpu/ops/pallas_packed.py::_packed_banded_kernel and
// _packed_banded_kernel_fusej (whole-image entry packed_banded_chunk). The
// plane layout existed because Mosaic cannot lower stride-2 lane access;
// Hopper has no such limit, so this kernel runs K2's body and differs only
// in the global addresses: element (i, j) lives at
// planes[i & 1][j & 1][i >> 1][j >> 1].
//
// Bound on the card: as K2 (the update's arithmetic). The launchers run
// band.cuh's body with PACKED = true (2k halos, 8 B of shared memory a
// window cell, two or more blocks an SM; loads, stores and partials
// coalesced within each plane), so a launch is bitwise K2's on the
// unpacked image.

#include "band.cuh"
#include "redblack.cuh"

// K3 on band.cuh: TH x TW tiles, PX x PY threads, windows of at most cap
// cells (ops/_cuda.py::band_geometry at the unpacked image's H x W).
extern "C" cudaError_t cv_packed_banded_chunk(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int k, int TH, int TW,
    int PX, int PY, int cap, float mu, float nu, float l1, float l2,
    float eta2, float gdt, float eps, float eps2, float inv_pi,
    void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  return cv::launch_band<0, false, true>(phi, u0, cc, out, block_parts,
                                         parts, H, W, k, TH, TW, PX, PY, cap,
                                         8, P, (cudaStream_t)stream,
                                         cv::Shard{});
}

// K3's shard-canvas mode on band.cuh: K2's shard mode on a canvas stored as
// parity planes. The canvas origin lies on an even global cell and the crop
// is even (the wrapper checks both), so the lattice parity is 0; the
// window in shared memory is flat, so the rim refresh is K2's.
//
// Replaces chan_vese_tpu/ops/pallas_packed.py::_packed_banded_kernel with
// cropp (reached through packed_banded_chunk_sharded, with _packed_rim).
extern "C" cudaError_t cv_packed_banded_chunk_shard(
    const float* phi, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int k, int TH, int TW,
    int PX, int PY, int cap, float mu, float nu, float l1, float l2,
    float eta2, float gdt, float eps, float eps2, float inv_pi, int parity,
    int r0, int r1, int c0, int c1, int top, int bottom, int left,
    int right, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  const cv::Shard S{parity, r0, r1, c0, c1, top, bottom, left, right};
  return cv::launch_band<0, true, true>(phi, u0, cc, out, block_parts, parts,
                                        H, W, k, TH, TW, PX, PY, cap, 8, P,
                                        (cudaStream_t)stream, S);
}

// Blocks of K3's band kernel (shard: its shard-canvas mode) that fit on an
// SM at `threads` threads and `smem` bytes of dynamic shared memory.
extern "C" cudaError_t cv_packed_band_occupancy(int shard, int threads,
                                                int smem, int* blocks) {
  return shard ? cv::band_occupancy<0, true, true>(threads, smem, blocks)
               : cv::band_occupancy<0, false, true>(threads, smem, blocks);
}
