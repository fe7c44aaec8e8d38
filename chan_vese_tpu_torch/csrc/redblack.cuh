// Shared device code of the Hopper red-black kernels: the parameters, the
// shard-canvas arguments, the element address, the frozen data term and
// the semi-implicit cell update that band.cuh (K2 banded.cu, K3 packed.cu,
// K5 banded_mc.cu, K6 packed_mc.cu), sweep.cuh (K1 fused.cu and its force
// mode fused_sweep.cu, K4 fused_mc.cu), resident_tiles.cuh (K7, K8, K13)
// and mp2.cuh (K9, K10) are built on.
//
// What a red-black launch computes: k red-black semi-implicit iterations
// with the region means c1/c2 frozen (k = 1 for the fused kernels), then
// the partials of the LAST iteration's transition, summed over the image:
// [s_uH, s_H, s_dphi2, flips, s_absdphi, 0, 0, 0] for a scalar image,
// [s_uH per channel..., s_H, s_dphi2, flips, s_absdphi, 0...] for a
// C-channel one (C + 4 slots for K4, padded to 16 for K5/K6). This is the
// contract of chan_vese_tpu/ops/pallas_banded.py::_banded_kernel and
// ::_banded_mc_kernel (and, at k = 1, of ops/pallas_sweep.py and
// ops/pallas_sweep_mc.py).
//
// Channels. The template parameter NC is 0 for a scalar image and the
// channel count C (1..8) otherwise; u0 is then channels-first, channel c
// at u0 + c H W in both layouts. Only the data term and the s_uH partials
// see the channels: the level set and the update stay scalar. NC = 0 keeps
// the scalar kernels' arithmetic (f = -nu - l1 d1^2 + l2 d2^2); NC >= 1
// computes the reference mc kernels' f = -nu + sum_c (l2[c]/C) d2^2 -
// (l1[c]/C) d1^2 in their order, with the weights l1[c]/C, l2[c]/C
// precomputed on the host. NC = kForce (-1) is the force mode of K1
// (fused_sweep.cu, the reference's data_is_f): the second input already
// is the force f, read where the others compute the data term; its s_uH
// slot then sums f H, which carries no meaning.
//
// Shard canvases (Shard; K1's, K2's, K3's and K5's shard modes). The image
// is one shard's halo-padded canvas of the spatially sharded solver
// (parallel/sharded.py), and a launch computes the contract of
// chan_vese_tpu/ops/pallas_banded.py::_banded_kernel's sharded branch with
// pallas_sweep.py::_resync_rim:
// - parity: canvas cell (i, j) is red iff (i + j + parity) is even, which
//   puts the canvas on the global red-black lattice;
// - crop [r0, r1) x [c0, c1): the shard's own cells. The tiles tile the
//   crop only, and the partials count only its cells; cells outside the
//   crop are copied through from the input;
// - edges (top, bottom, left, right): the sides of the canvas that are
//   global image edges. There the canvas holds clamped replicas of the
//   shard's edge row or column, which the sweeps overwrite; after the
//   write-back of every half-sweep the depth-2 rim is refreshed from the
//   edge cells, rows first and then columns (so the corners come out as
//   in _resync_rim). Depth 2 suffices: a half-sweep reads one cell into
//   the rim.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cv {
// Internal linkage: every .cu that includes this header gets its own copy,
// so the launchers link into one library without clashes.
namespace {

constexpr int kMaxChannels = 8;
constexpr int kForce = -1;  // NC of the force mode

struct Params {
  float mu, nu, l1, l2, eta2;  // l1, l2: scalar image only
  float gdt;     // dt * eps / pi, computed on the host in double
  float eps, eps2, inv_pi;
};

// The shard-canvas arguments (SHARD = true; unused otherwise): lattice
// parity, crop [r0, r1) x [c0, c1), and the global-edge flags.
struct Shard {
  int parity, r0, r1, c0, c1;
  int top, bottom, left, right;
};

// s_uH slots, and all partial sums, of a block for channel count NC.
template <int NC>
__host__ __device__ constexpr int uh_slots() { return NC <= 0 ? 1 : NC; }
template <int NC>
__host__ __device__ constexpr int sum_slots() { return uh_slots<NC>() + 4; }
// floats of cc: [c1, c2] for a scalar image (unused in the force mode),
// [c1 x C, c2 x C, l1/C x C, l2/C x C] for C channels
template <int NC>
__host__ __device__ constexpr int cc_len() { return NC <= 0 ? 2 : 4 * NC; }

// Offset of image element (i, j): flat row-major, or parity planes
// P[i & 1][j & 1][i >> 1][j >> 1] of shape (2, 2, H/2, W/2).
template <bool PACKED>
__device__ __forceinline__ int64_t gaddr(int i, int j, int H, int W) {
  if (PACKED) {
    const int64_t hp = H >> 1, wp = W >> 1;
    const int64_t plane = (i & 1) * 2 + (j & 1);
    return (plane * hp + (i >> 1)) * wp + (j >> 1);
  }
  return (int64_t)i * W + j;
}

// The frozen data term at element offset g; chan is H * W, the channel
// stride of a channels-first u0.
template <int NC>
__device__ __forceinline__ float data_term(const float* __restrict__ u0,
                                           int64_t g, int64_t chan,
                                           const float* cc,
                                           const Params& P) {
  if constexpr (NC == kForce) {
    return u0[g];
  } else if constexpr (NC == 0) {
    const float u = u0[g];
    const float d1 = u - cc[0], d2 = u - cc[1];
    return -P.nu - P.l1 * (d1 * d1) + P.l2 * (d2 * d2);
  } else {
    float f = -P.nu;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float u = u0[c * chan + g];
      const float d1 = u - cc[c], d2 = u - cc[NC + c];
      f = f + cc[3 * NC + c] * (d2 * d2) - cc[2 * NC + c] * (d1 * d1);
    }
    return f;
  }
}

__device__ __forceinline__ float face(float mu, float eta2, float a,
                                      float b) {
  return mu * rsqrtf(eta2 + a * a + b * b);
}

// Semi-implicit update of cell (r, c) of an wh x ww grid whose cell
// offsets in s come from idx, with the force at the cell from force(),
// evaluated where the sum needs it (so a shared-memory window's f is
// loaded after the neighbours, as K1-K6 always did). Counterpart of
// chan_vese_tpu/ops/pallas_sweep.py::_update_all: forward coefficients
// A, B at the cell; backward ones A- = A(r-1, c) and B- = B(r, c-1)
// evaluated with clamped reads, which at the grid's first row/col gives
// the replica-eval value (am0/bm0 of the reference). The Dirac factor uses
// the cell's value before the iteration: the active color is still old
// when its half-sweep runs.
template <class Idx, class Force>
__device__ __forceinline__ float update_cell_at(const float* s, Force force,
                                                int r, int c, int wh, int ww,
                                                Idx idx, const Params& P) {
  const int rn = max(r - 1, 0), rs = min(r + 1, wh - 1);
  const int cw = max(c - 1, 0), ce = min(c + 1, ww - 1);
  const float x = s[idx(r, c)];
  const float n = s[idx(rn, c)], so = s[idx(rs, c)];
  const float w = s[idx(r, cw)], e = s[idx(r, ce)];
  const float nw = s[idx(rn, cw)], ne = s[idx(rn, ce)];
  const float sw = s[idx(rs, cw)];
  const float A = face(P.mu, P.eta2, so - x, 0.5f * (e - w));
  const float Am = face(P.mu, P.eta2, x - n, 0.5f * (ne - nw));
  const float B = face(P.mu, P.eta2, 0.5f * (so - n), e - x);
  const float Bm = face(P.mu, P.eta2, 0.5f * (sw - nw), x - w);
  const float g = P.gdt / (P.eps2 + x * x);
  const float num = x + g * (A * so + Am * n + B * e + Bm * w + force());
  const float den = 1.0f + g * (A + Am + B + Bm);
  return num / den;
}

// Params of a C-channel launch: the per-channel weights travel in cc.
__host__ inline Params mc_params(float mu, float nu, float eta2, float gdt,
                                 float eps, float eps2, float inv_pi) {
  return Params{mu, nu, 0.0f, 0.0f, eta2, gdt, eps, eps2, inv_pi};
}

}  // namespace
}  // namespace cv
