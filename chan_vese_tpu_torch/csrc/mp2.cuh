// Shared device code of the Hopper 4-phase (two level sets) kernels: K9
// banded mode mp2_band.cu, K9 resident mode mp2_resident.cu (flat layout)
// and K10 packed_mp2_resident.cu (parity planes).
//
// What an iteration computes, the contract of
// chan_vese_tpu/ops/pallas_multiphase.py::_coupled_iteration: with the four
// phase means c = [c00, c10, c01, c11] indexed by s = (phi0 >= 0) +
// 2 (phi1 >= 0) and d_s = (u0 - c_s)^2,
//   f0 = -nu + (1 - H(phi1 old)) (d0 - d1) + H(phi1 old) (d2 - d3);
//   phi0 <- red, then black half-sweep on f0 (Dirac of old phi0);
//   f1 = -nu + (1 - H(phi0 new)) (d0 - d2) + H(phi0 new) (d1 - d3),
//        pointwise at each cell;
//   phi1 <- red, then black half-sweep on f1 (Dirac of old phi1).
// The update is redblack.cuh's update_cell_at, replica-eval Neumann at the
// image edges. Partials (16 slots of the banded mode), over owned cells of
// the new level sets: [s_uw_0..3, s_w_0..3, label_flips, s_dphi2, 0 x 6],
// w_s the soft phase weights; flips are of the 2-bit label. This header
// holds the forces, the label and the phase sums every body shares; the
// banded mode's body is mp2_band.cu's.
//
// Resident mode, tile body (mp2_tile_kernel<PACKED>, the launchers
// cv_(packed_)mp2_resident_iterations): `iters` coupled iterations in one
// cooperative launch, the means exact at every iteration, on
// resident_tiles.cuh's persistent shared-memory tiles. A block keeps its
// tile of phi0 and phi1 (padded by a one-cell ring), u0 where the budget
// allows and a label byte a cell in shared memory for the whole launch.
// Per iteration (the ring cells read from the neighbours' tagged rim
// words, resident_tiles.cuh):
//   (b) phi0 red: new values into N0, committed; phi0's red border to its
//       rim; the four side neighbours' red cells of phi0 into the ring;
//   (c) phi0 black (force from old phi1) into N0 and phi1 red (force from
//       the new red phi0 at the cell, final after (b)) into N1, committed
//       together: phi1's red half reads phi0's new value only at its own
//       red cell, so the two share a phase; phi0's black and phi1's red
//       border to the rims; the side neighbours' red cells of phi1 in;
//   (d) phi1 black: N1, committed, with the next iteration's phase sums
//       and the row sums; phi1's black border to its rim; the grid-wide
//       step (means, the row), during which both rings are read for the
//       next iteration.
// So two neighbour waits and one grid-wide step an iteration. The old
// 2-bit label of a row iteration is kept at the commits of (b) and (c)
// (old phi0 at hand, phi1 still old) and compared at those of (c) and
// (d); the label flips are not the sum of each level set's own flips.
// Partials rows (8 slots, one per `unroll` iterations, the last of each
// group): [label_flips, s_dphi2, 0 x 6]. The f64 phase sums are added by
// tile, in block order.
//
// Bound on the card, tile body: the operations of two cell updates, four
// distances and two atan a cell an iteration, and the fixed cost of two
// neighbour waits and one grid-wide step.

#pragma once

#include "resident_tiles.cuh"

namespace cv {
namespace {

constexpr int kMp2Row = 8;  // slots of a resident partials row

__device__ __forceinline__ float heav(float x, const Params& P) {
  return 0.5f + P.inv_pi * atanf(x / P.eps);
}

__device__ __forceinline__ float sqd(float u, float c) {
  const float d = u - c;
  return d * d;
}

// phi0's force from the old phi1 at the cell
__device__ __forceinline__ float force0(float u, float phi1, const float* c,
                                       const Params& P) {
  const float h1 = heav(phi1, P);
  const float d0 = sqd(u, c[0]), d1 = sqd(u, c[1]);
  const float d2 = sqd(u, c[2]), d3 = sqd(u, c[3]);
  return -P.nu + (1.0f - h1) * (d0 - d1) + h1 * (d2 - d3);
}

// phi1's force from the new phi0 at the cell
__device__ __forceinline__ float force1(float u, float phi0n, const float* c,
                                       const Params& P) {
  const float h0 = heav(phi0n, P);
  const float d0 = sqd(u, c[0]), d1 = sqd(u, c[1]);
  const float d2 = sqd(u, c[2]), d3 = sqd(u, c[3]);
  return -P.nu + (1.0f - h0) * (d0 - d2) + h0 * (d1 - d3);
}

__device__ __forceinline__ int label2(float phi0, float phi1) {
  return (phi0 >= 0.0f ? 1 : 0) + (phi1 >= 0.0f ? 2 : 0);
}

// Adds u w_s to acc[s] and w_s to acc[4 + s] for the cell's four soft
// phase weights.
__device__ __forceinline__ void add_phase_sums(double* acc, float u,
                                               float phi0, float phi1,
                                               const Params& P) {
  const float h0 = heav(phi0, P), h1 = heav(phi1, P);
  const float w[4] = {(1.0f - h0) * (1.0f - h1), h0 * (1.0f - h1),
                      (1.0f - h0) * h1, h0 * h1};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    acc[s] += (double)(u * w[s]);
    acc[4 + s] += (double)w[s];
  }
}

struct Mp2TileArgs {
  const float* phi_in;  // (2, image): the start, never written
  float* out;           // (2, image): the result
  const float* u0;      // (image)
  double* scratch;      // (nblocks, 10) slots
  Word* rims;           // (2 level sets, 2 parities, nblocks, rim_len)
  unsigned* sync;       // SyncBuf, zeroed
  float* parts;         // (iters / unroll, 8) rows
  int H, W, iters, unroll, TH, TW, GX, GY, u0res;
};

template <bool PACKED>
__global__ void __launch_bounds__(kTileThreads, 1)
mp2_tile_kernel(Mp2TileArgs a, Params P) {
  // slots: the phase sums [0, 8), then label flips and s_dphi2
  constexpr int kS = 10;
  extern __shared__ float smem[];
  __shared__ double s_red[kTileWarps][kS];
  __shared__ double s_tot[kS];
  __shared__ float s_c[4];
  __shared__ int s_last;

  const int H = a.H, W = a.W, nb = gridDim.x;
  const Tile t(H, W, a.TH, a.TW, a.GX);
  const SyncBuf sync(a.sync);
  const int hw = t.tw >> 1, npairs = t.th * hw, cells = t.th * t.tw;
  const Pairs pr(hw);
  const int64_t plane = (int64_t)H * W;
  const int len = rim_len(a.TH, a.TW), pad = (a.TH + 2) * (a.TW + 2);
  float* S0 = smem;
  float* S1 = S0 + pad;
  float* N0 = S1 + pad;
  float* N1 = N0 + a.TH * a.TW / 2;
  float* U = N1 + a.TH * a.TW / 2;
  unsigned char* L = (unsigned char*)(U + (a.u0res ? a.TH * a.TW : 0));
  double* slots = a.scratch;
  unsigned step = 0, tag = 1;
  // level set m's rims of parity q, this block's
  auto rims = [&](int m, int64_t q) {
    return a.rims + (m * 2 + q) * nb * len;
  };
  auto mine = [&](int m, int64_t q) { return rims(m, q) + blockIdx.x * len; };
  auto uat = [&](int i, int j) -> float {
    return a.u0res ? U[t.u(i, j)] : a.u0[gaddr<PACKED>(i, j, H, W)];
  };
  bool f_row = false, f_more = true;
  int f_it = 0;
  int64_t ring_q = 1;
  // the last block's part of a step: the next means (the words), the row
  auto means = [&](int s, const double* tot) -> float {
    return f_more ? (float)(tot[s] / fmax(tot[4 + s], 1e-30)) : 0.0f;
  };
  auto finish = [&](const double* tot) {
    if (f_row) {
      float* dst = a.parts + (int64_t)(f_it / a.unroll) * kMp2Row;
      dst[0] = (float)tot[8];
      dst[1] = (float)tot[9];
      for (int s = 2; s < kMp2Row; ++s) dst[s] = 0.0f;
    }
  };
  // while waiting for the means: the next iteration's rings of both level
  // sets from the rims of parity ring_q (tagged `tag`)
  auto ring = [&](int first) {
    if (!f_more) return;
    fill_ring(S0, rims(0, ring_q), t, a.TH, a.TW, a.GX, a.GY, false, tag,
              first);
    fill_ring(S1, rims(1, ring_q), t, a.TH, a.TW, a.GX, a.GY, false, tag,
              first);
  };

  // the tiles (their borders into the parity-1 rims, iteration 0's
  // rings), u0 where resident, the input's phase sums
  double acc[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) acc[s] = 0.0;
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    const int i = t.r0 + k / t.tw, j = t.c0 + k % t.tw;
    const int64_t g = gaddr<PACKED>(i, j, H, W);
    const float v0 = a.phi_in[g], v1 = a.phi_in[plane + g], u = a.u0[g];
    S0[t(i, j)] = v0;
    S1[t(i, j)] = v1;
    publish(mine(0, 1), t, a.TH, a.TW, i, j, v0, tag);
    publish(mine(1, 1), t, a.TH, a.TW, i, j, v1, tag);
    if (a.u0res) U[t.u(i, j)] = u;
    add_phase_sums(acc, u, v0, v1, P);
  }
  post_sums(acc, 0, 8, slots, s_red);
  grid_step<kS>(slots, 0, 8, sync, step++, s_tot, nullptr, 0, s_c, 4,
                &s_last, means, finish, ring);

  for (int it = 0; it < a.iters; ++it) {
    const bool row = it % a.unroll == a.unroll - 1;
    const bool more = it + 1 < a.iters;
    const int64_t par = it & 1;
    const unsigned next = tag + 1;
#pragma unroll
    for (int s = 0; s < kS; ++s) acc[s] = 0.0;

    // (b) phi0 red
    for (int k = threadIdx.x, lr = pr.lr0, q = pr.q0; k < npairs;
         k += blockDim.x, pr.next(lr, q)) {
      const int i = t.r0 + lr, j = t.c0 + 2 * q + (i & 1);
      const float f0 = force0(uat(i, j), S1[t(i, j)], s_c, P);
      N0[k] = update_cell_at(S0, [f0] { return f0; }, i, j, H, W, t, P);
    }
    __syncthreads();
    for (int k = threadIdx.x, lr = pr.lr0, q = pr.q0; k < npairs;
         k += blockDim.x, pr.next(lr, q)) {
      const int i = t.r0 + lr, j = t.c0 + 2 * q + (i & 1);
      const int s = t(i, j);
      const float o = S0[s], n = N0[k];
      if (row) {
        L[t.u(i, j)] = (unsigned char)label2(o, S1[s]);
        const float d = n - o;
        acc[9] += (double)(d * d);
      }
      S0[s] = n;
      publish(mine(0, par), t, a.TH, a.TW, i, j, n, next);
    }
    fill_ring(S0, rims(0, par), t, a.TH, a.TW, a.GX, a.GY, true, next);
    __syncthreads();

    // (c) phi0 black and phi1 red
    for (int k = threadIdx.x, lr = pr.lr0, q = pr.q0; k < npairs;
         k += blockDim.x, pr.next(lr, q)) {
      const int i = t.r0 + lr;
      const int jr = t.c0 + 2 * q + (i & 1), jb = t.c0 + 2 * q + 1 - (i & 1);
      const float f0 = force0(uat(i, jb), S1[t(i, jb)], s_c, P);
      N0[k] = update_cell_at(S0, [f0] { return f0; }, i, jb, H, W, t, P);
      const float f1 = force1(uat(i, jr), S0[t(i, jr)], s_c, P);
      N1[k] = update_cell_at(S1, [f1] { return f1; }, i, jr, H, W, t, P);
    }
    __syncthreads();
    for (int k = threadIdx.x, lr = pr.lr0, q = pr.q0; k < npairs;
         k += blockDim.x, pr.next(lr, q)) {
      const int i = t.r0 + lr;
      const int jr = t.c0 + 2 * q + (i & 1), jb = t.c0 + 2 * q + 1 - (i & 1);
      const int sb = t(i, jb), sr = t(i, jr);
      const float o0 = S0[sb], n0 = N0[k];
      const float o1 = S1[sr], n1 = N1[k];
      if (row) {
        L[t.u(i, jb)] = (unsigned char)label2(o0, S1[sb]);
        const float d0 = n0 - o0, d1 = n1 - o1;
        acc[9] += (double)(d0 * d0) + (double)(d1 * d1);
        acc[8] += label2(S0[sr], n1) != (int)L[t.u(i, jr)] ? 1.0 : 0.0;
      }
      S0[sb] = n0;
      S1[sr] = n1;
      publish(mine(0, par), t, a.TH, a.TW, i, jb, n0, next);
      publish(mine(1, par), t, a.TH, a.TW, i, jr, n1, next);
      if (more) add_phase_sums(acc, uat(i, jr), S0[sr], n1, P);
    }
    fill_ring(S1, rims(1, par), t, a.TH, a.TW, a.GX, a.GY, true, next);
    __syncthreads();

    // (d) phi1 black, with the next iteration's phase sums and the row
    for (int k = threadIdx.x, lr = pr.lr0, q = pr.q0; k < npairs;
         k += blockDim.x, pr.next(lr, q)) {
      const int i = t.r0 + lr, j = t.c0 + 2 * q + 1 - (i & 1);
      const float f1 = force1(uat(i, j), S0[t(i, j)], s_c, P);
      N1[k] = update_cell_at(S1, [f1] { return f1; }, i, j, H, W, t, P);
    }
    __syncthreads();
    for (int k = threadIdx.x, lr = pr.lr0, q = pr.q0; k < npairs;
         k += blockDim.x, pr.next(lr, q)) {
      const int i = t.r0 + lr, j = t.c0 + 2 * q + 1 - (i & 1);
      const int s = t(i, j);
      const float o = S1[s], n = N1[k];
      if (row) {
        const float d = n - o;
        acc[9] += (double)(d * d);
        acc[8] += label2(S0[s], n) != (int)L[t.u(i, j)] ? 1.0 : 0.0;
      }
      S1[s] = n;
      publish(mine(1, par), t, a.TH, a.TW, i, j, n, next);
      if (more) add_phase_sums(acc, uat(i, j), S0[s], n, P);
    }
    tag = next;
    if (row || more) {
      f_row = row, f_more = more, f_it = it, ring_q = par;
      post_sums(acc, more ? 0 : 8, row ? kS : 8, slots, s_red);
      grid_step<kS>(slots, more ? 0 : 8, row ? kS : 8, sync, step++, s_tot,
                    nullptr, 0, s_c, 4, &s_last, means, finish, ring);
    }
  }

  __syncthreads();
  for (int k = threadIdx.x; k < cells; k += blockDim.x) {
    const int i = t.r0 + k / t.tw, j = t.c0 + k % t.tw;
    const int64_t g = gaddr<PACKED>(i, j, H, W);
    a.out[g] = S0[t(i, j)];
    a.out[plane + g] = S1[t(i, j)];
  }
}

// The 4-phase tile body after checking the tiling and that smem is its
// size; with `capacity`, the co-resident blocks at smem bytes instead.
template <bool PACKED>
cudaError_t mp2_tile(Mp2TileArgs a, Params P, int nblocks, int smem,
                     cudaStream_t stream, int* capacity) {
  if (capacity)
    return tile_capacity(mp2_tile_kernel<PACKED>, smem, capacity);
  if (!tile_grid_ok(a.H, a.W, a.TH, a.TW, a.GX, nblocks) ||
      smem != tile_smem_bytes(a.TH, a.TW, 1, 2, a.u0res))
    return cudaErrorInvalidValue;
  return tile_launch(mp2_tile_kernel<PACKED>, a, P, nblocks, smem, stream);
}

}  // namespace
}  // namespace cv

// The plain C interface of the two resident launchers on the tile body:
// pointers; grid size, geometry, iterations; the tiling (TH, TW, GX, u0
// resident, dynamic bytes); the parameters of the update; the stream.
// Each has a `_grid` twin (C, dynamic bytes, int* co-resident blocks).
#define CV_MP2_TILE_ARGS                                                   \
  const float *phi_in, float *out, const float *u0, double *scratch,      \
      void *rims, unsigned *sync, float *parts, int nblocks, int H,       \
      int W, int iters, int unroll, int TH, int TW, int GX, int u0res,    \
      int smem, float mu, float nu, float eta2, float gdt, float eps,     \
      float eps2, float inv_pi, void *stream
#define CV_MP2_TILE_CALL                                                   \
  cv::Mp2TileArgs{phi_in, out, u0, scratch, (cv::Word*)rims, sync, parts, \
                  H, W, iters, unroll, TH, TW, GX,                        \
                  GX > 0 ? nblocks / GX : 0, u0res},                      \
      cv::Params{mu, nu, 0.0f, 0.0f, eta2, gdt, eps, eps2, inv_pi},       \
      nblocks, smem, (cudaStream_t)stream, nullptr
