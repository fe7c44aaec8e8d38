// K11: k MorphACWE (frozen force) or MorphGAC iterations per pass over
// device memory on a binary level set.
//
// Replaces chan_vese_tpu/ops/pallas_morph.py::_morph_banded_kernel
// (whole-image kinds acwe, gac and gac_pre, reached through morph_chunk and
// gac_chunk, and the shard kinds acwe_sh and gac_pre_sh, reached through
// morph_chunk_shard and gac_chunk_shard). The TPU kernel streamed
// full-width row bands with symmetric ceil8(R k) halos; a 4K row does not
// fit a block's shared memory, so here a block owns a 2D tile with halos
// on all four sides.
//
// cv_morph_chunk and cv_morph_chunk_shard run the bit-packed body
// (morph_bits.cuh): 32 cells a word, loaded with one ballot, the force
// signs and the GAC attraction kept as bit planes, an elementary op about
// one integer instruction a cell; the shard kinds clamp at the crop on the
// global-edge sides, which is the replica ring's refresh. Bound on the
// card: device memory, 12 B/pixel a launch (20 for gac_pre).

#include "morph_bits.cuh"

namespace {

// the bit body's launch arguments of a whole image or of a shard block's
// crop (pt, pb, pcl, pcr pads; the flags mark the global-edge sides, where
// the clamp box is the crop)
cv::bits::BitsArgs bits_args(const float* ls, const float* aux, float* out,
                             int H, int W, int k, int s, int parity0,
                             int balloon, float thr_b, int halo, int TH,
                             int TW, int WW, int nblocks) {
  cv::bits::BitsArgs A{};
  A.ls = ls;
  A.aux = aux;
  A.out = out;
  A.H = H;
  A.W = W;
  A.k = k;
  A.s = s;
  A.parity0 = parity0;
  A.balloon = balloon;
  A.thr_b = thr_b;
  A.halo = halo;
  A.TH = TH;
  A.TW = TW;
  A.WW = WW;
  A.r1 = A.br1 = H;
  A.c1 = A.bc1 = W;
  A.nblocks = nblocks;
  return A;
}

}  // namespace

// kind 0 acwe, 1 gac, 2 gac_pre on an (H, W) image: TH x TW tiles, windows
// of WW words and cap = rows x WW words (ops/_cuda.py morph_geometry);
// nblocks must be the grid's
extern "C" cudaError_t cv_morph_chunk(const float* ls, const float* aux,
                                      float* out, int H, int W, int kind,
                                      int k, int s, int parity0, int balloon,
                                      float thr_b, int halo, int TH, int TW,
                                      int WW, int cap, int nblocks,
                                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const cv::bits::BitsArgs A = bits_args(ls, aux, out, H, W, k, s, parity0,
                                         balloon, thr_b, halo, TH, TW, WW,
                                         nblocks);
  switch (kind) {
    case cv::bits::kAcwe:
      return cv::bits::launch<cv::bits::kAcwe>(A, cap, st);
    case cv::bits::kGac:
      return cv::bits::launch<cv::bits::kGac>(A, cap, st);
    case cv::bits::kGacPre:
      return cv::bits::launch<cv::bits::kGacPre>(A, cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// the shard kinds (4 acwe_sh, 5 gac_pre_sh) on a shard's padded (H, W)
// block whose own cells are [pt, H - pb) x [pcl, W - pcr); top, bottom,
// left, right flag the global-edge sides
extern "C" cudaError_t cv_morph_chunk_shard(
    const float* ls, const float* aux, float* out, int H, int W, int kind,
    int k, int s, int parity0, int balloon, float thr_b, int halo, int TH,
    int TW, int WW, int cap, int nblocks, int pt, int pb, int pcl, int pcr,
    int top, int bottom, int left, int right, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cv::bits::BitsArgs A = bits_args(ls, aux, out, H, W, k, s, parity0,
                                   balloon, thr_b, halo, TH, TW, WW, nblocks);
  A.r0 = pt;
  A.r1 = H - pb;
  A.c0 = pcl;
  A.c1 = W - pcr;
  A.br0 = top ? A.r0 : 0;
  A.br1 = bottom ? A.r1 : H;
  A.bc0 = left ? A.c0 : 0;
  A.bc1 = right ? A.c1 : W;
  switch (kind) {
    case cv::bits::kAcweSh:
      return cv::bits::launch<cv::bits::kAcweSh>(A, cap, st);
    case cv::bits::kGacPreSh:
      return cv::bits::launch<cv::bits::kGacPreSh>(A, cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// the bit body's blocks an SM of `kind` (0-5) at cap window words
extern "C" cudaError_t cv_morph_bits_occupancy(int kind, int cap,
                                               int* blocks) {
  switch (kind) {
    case cv::bits::kAcwe:
      return cv::bits::occupancy<cv::bits::kAcwe>(cap, blocks);
    case cv::bits::kGac:
      return cv::bits::occupancy<cv::bits::kGac>(cap, blocks);
    case cv::bits::kGacPre:
      return cv::bits::occupancy<cv::bits::kGacPre>(cap, blocks);
    case cv::bits::kAcweSh:
      return cv::bits::occupancy<cv::bits::kAcweSh>(cap, blocks);
    case cv::bits::kGacPreSh:
      return cv::bits::occupancy<cv::bits::kGacPreSh>(cap, blocks);
    default:
      return cudaErrorInvalidValue;
  }
}
