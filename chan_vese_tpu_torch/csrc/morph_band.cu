// K11: k MorphACWE (frozen force) or MorphGAC iterations per pass over
// device memory on a binary level set.
//
// Replaces chan_vese_tpu/ops/pallas_morph.py::_morph_banded_kernel
// (whole-image kinds acwe, gac and gac_pre, reached through morph_chunk and
// gac_chunk, and the shard kinds acwe_sh and gac_pre_sh, reached through
// morph_chunk_shard and gac_chunk_shard). The TPU kernel streamed
// full-width row bands with symmetric ceil8(R k) halos; a 4K row does not
// fit a block's shared memory, so here a block owns a 2D tile with halos
// on all four sides and keeps the state as bytes (morph.cuh). The shard
// kinds tile the shard's own cells and refresh the depth-1 replica ring
// on the global-edge sides before every elementary op (morph.cuh, "Shard
// blocks").
//
// Bound on the card: shared-memory byte reads of the 3x3 neighborhoods
// and the halo recompute (2.4x cells at ACWE k = 8, 1.9x at GAC k = 4 with
// 64 x 128 tiles), not DRAM: device memory moves 12 B/pixel per launch (20
// for gac_pre) while every iteration runs 3 (ACWE) to 4 (GAC) ops over the
// window at s = 1. Byte state and an int8 force sign keep ACWE at 3 B per
// window cell, so three blocks fit an SM.

#include "morph.cuh"

extern "C" cudaError_t cv_morph_chunk(const float* ls, const float* aux,
                                      float* out, int H, int W, int kind,
                                      int k, int s, int parity0, int balloon,
                                      float thr_b, int halo, int TH, int TW,
                                      int cap, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case cv::kMorphAcwe:
      return cv::launch_morph<cv::kMorphAcwe>(ls, aux, nullptr, out, nullptr,
                                              nullptr, H, W, k, s, parity0,
                                              0, 0.0f, halo, TH, TW, cap, st);
    case cv::kMorphGac:
      return cv::launch_morph<cv::kMorphGac>(ls, aux, nullptr, out, nullptr,
                                             nullptr, H, W, k, s, parity0,
                                             balloon, thr_b, halo, TH, TW,
                                             cap, st);
    case cv::kMorphGacPre:
      return cv::launch_morph<cv::kMorphGacPre>(
          ls, aux, nullptr, out, nullptr, nullptr, H, W, k, s, parity0,
          balloon, thr_b, halo, TH, TW, cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// K11's shard kinds (acwe_sh = 4, gac_pre_sh = 5) on a shard's padded
// (H, W) block whose own cells are [pt, H - pb) x [pcl, W - pcr); top,
// bottom, left, right flag the global-edge sides.
extern "C" cudaError_t cv_morph_chunk_shard(
    const float* ls, const float* aux, float* out, int H, int W, int kind,
    int k, int s, int parity0, int balloon, float thr_b, int halo, int TH,
    int TW, int cap, int pt, int pb, int pcl, int pcr, int top, int bottom,
    int left, int right, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const cv::Shard S{0, pt, H - pb, pcl, W - pcr, top, bottom, left, right};
  switch (kind) {
    case cv::kMorphAcweSh:
      return cv::launch_morph<cv::kMorphAcweSh>(
          ls, aux, nullptr, out, nullptr, nullptr, H, W, k, s, parity0, 0,
          0.0f, halo, TH, TW, cap, st, S);
    case cv::kMorphGacPreSh:
      return cv::launch_morph<cv::kMorphGacPreSh>(
          ls, aux, nullptr, out, nullptr, nullptr, H, W, k, s, parity0,
          balloon, thr_b, halo, TH, TW, cap, st, S);
    default:
      return cudaErrorInvalidValue;
  }
}
