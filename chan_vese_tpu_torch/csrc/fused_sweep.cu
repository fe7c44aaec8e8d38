// K1, force mode: one red-black sweep on a precomputed force f, plus the
// partials of the transition.
//
// Replaces chan_vese_tpu/ops/pallas_sweep.py::_fused_band_kernel in its
// data_is_f mode (reached through fused_sweep), the per-level-set sweep of
// the multiphase `sweeps` route, and that mode with a lattice parity
// (fused_sweep(parity=...) :467, the lattice offset in c[2] :301-302).
// The launchers the wrappers call run sweep.cuh's single-sweep body with
// NC = kForce: the window loads f where K1 loads u0, and the swept cell
// reads it as its force. Partials [f H, H, s_dphi2, flips, s_absdphi, 0,
// 0, 0]; the first two carry no meaning in this mode, as in the
// reference.
//
// Bound on the card: device memory, as fused.cu (phi and f read, phi
// written: 12 B/pixel). At 512^2, where the sweeps route launches it, a
// launch moves 3 MB: the design fills the card with small blocks and sums
// the partials in the same launch, so what is left is a launch's latency.

#include "redblack.cuh"
#include "sweep.cuh"

// The force mode on sweep.cuh: geometry as cv_fused_iteration (fused.cu).
extern "C" cudaError_t cv_fused_sweep(
    const float* phi, const float* f, const float* cc, float* out,
    double* block_parts, unsigned int* counters, float* parts, int H, int W,
    int TH, int TW, int PX, int PY, int cap, int nblocks, float mu, float nu,
    float l1, float l2, float eta2, float gdt, float eps, float eps2,
    float inv_pi, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  return cv::launch_sweep<cv::kForce, false>(
      phi, f, cc, out, block_parts, counters, parts, H, W, 1, TH, TW, PX, PY,
      cap, nblocks, 8, P, (cudaStream_t)stream,
      cv::Shard{0, 0, H, 0, W, 0, 0, 0, 0});
}

// The force mode with `parity`, cell (i, j) red iff (i + j + parity) is
// even. The reference takes the parity only: no crop and no rim. Here that
// is the shard-canvas instantiation with the crop the whole image and no
// edge flags, so the tiles, windows and partials are the whole-image ones
// and no rim is refreshed.
extern "C" cudaError_t cv_fused_sweep_shard(
    const float* phi, const float* f, const float* cc, float* out,
    double* block_parts, unsigned int* counters, float* parts, int H, int W,
    int TH, int TW, int PX, int PY, int cap, int nblocks, float mu, float nu,
    float l1, float l2, float eta2, float gdt, float eps, float eps2,
    float inv_pi, int parity, int r0, int r1, int c0, int c1, int top,
    int bottom, int left, int right, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  const cv::Shard S{parity, r0, r1, c0, c1, top, bottom, left, right};
  return cv::launch_sweep<cv::kForce, true>(
      phi, f, cc, out, block_parts, counters, parts, H, W, 1, TH, TW, PX, PY,
      cap, nblocks, 8, P, (cudaStream_t)stream, S);
}

// Blocks of the force mode's single-sweep body (shard: with a parity) that
// fit on an SM at `threads` threads and `smem` dynamic bytes.
extern "C" cudaError_t cv_sweep_occupancy_force(int shard, int threads,
                                                int smem, int* blocks) {
  return shard ? cv::sweep_occupancy<cv::kForce, true>(threads, smem, blocks)
               : cv::sweep_occupancy<cv::kForce, false>(threads, smem,
                                                         blocks);
}
