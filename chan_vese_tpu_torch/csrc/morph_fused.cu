// K12: K11's acwe kind with the force computed in the kernel from the image
// and four scalars, plus the region partials of the final state.
//
// Replaces chan_vese_tpu/ops/pallas_morph.py::_morph_fused_kernel (reached
// through morph_chunk_fused). The window loads u0 instead of a force plane
// and takes f = l1 (u0 - c_in)^2 - l2 (u0 - c_out)^2 per cell, rounded op
// by op as the plain version is, so its sign is the plain version's. The
// partials (sum ls, sum u0 ls) come from owned cells only.
//
// cv_morph_fused_chunk runs the bit-packed body (morph_bits.cuh, kind
// fused): the force's signs as two bit planes, sum ls an exact count, sum
// u0 ls in f64 a block, and the last block of the launch to finish sums the
// blocks in a fixed order (one launch; a counter word a stream). Bound on
// the card: device memory, 12 B/pixel a launch; no force plane is written
// or read between chunks.
//
// The first body (morph.cuh's kMorphFused, its block sums reduced by a
// second launch) stays as cv_morph_fused_chunk_v1, reached only through
// ops/_cuda.py launch_morph_fused(..., v1=True).

#include "morph.cuh"
#include "morph_bits.cuh"

// TH x TW tiles, windows of WW words and cap = rows x WW words (ops/_cuda.py
// morph_geometry); block_parts (nblocks, 2) f64, counter one word at 0
// (left at 0), parts (2,) f32; nblocks must be the grid's
extern "C" cudaError_t cv_morph_fused_chunk(
    const float* ls, const float* u0, const float* cc, float* out,
    double* block_parts, unsigned int* counter, float* parts, int H, int W,
    int k, int s, int parity0, int halo, int TH, int TW, int WW, int cap,
    int nblocks, void* stream) {
  cv::bits::BitsArgs A{};
  A.ls = ls;
  A.aux = u0;
  A.cc = cc;
  A.out = out;
  A.block_parts = block_parts;
  A.counter = counter;
  A.parts = parts;
  A.H = H;
  A.W = W;
  A.k = k;
  A.s = s;
  A.parity0 = parity0;
  A.halo = halo;
  A.TH = TH;
  A.TW = TW;
  A.WW = WW;
  A.r1 = A.br1 = H;
  A.c1 = A.bc1 = W;
  A.nblocks = nblocks;
  return cv::bits::launch<cv::bits::kFused>(A, cap, (cudaStream_t)stream);
}

extern "C" cudaError_t cv_morph_fused_bits_occupancy(int cap, int* blocks) {
  return cv::bits::occupancy<cv::bits::kFused>(cap, blocks);
}

// the first body
extern "C" cudaError_t cv_morph_fused_chunk_v1(
    const float* ls, const float* u0, const float* cc, float* out,
    double* block_parts, float* parts, int H, int W, int k, int s,
    int parity0, int halo, int TH, int TW, int cap, void* stream) {
  return cv::launch_morph<cv::kMorphFused>(
      ls, u0, cc, out, block_parts, parts, H, W, k, s, parity0, 0, 0.0f, halo,
      TH, TW, cap, (cudaStream_t)stream);
}
