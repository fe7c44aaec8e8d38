// The bit-packed morphological body of the Hopper kernels K11 (morph_band.cu:
// kinds acwe, gac, gac_pre and the shard kinds acwe_sh, gac_pre_sh) and K12
// (morph_fused.cu: acwe with the force computed in the kernel and the region
// partials of the final state). One body, templated on the kind; the first
// body (morph.cuh, one byte a cell) stays as the `_v1` launchers.
//
// What a launch computes is morph.cuh's contract, bit for bit: k MorphACWE
// or MorphGAC iterations on a binary level set; iteration j is the force
// step (GAC: the balloon op where balloon != 0, then the attraction), then
// `s` smoothing cycles, cycle c SIoIS (inf-sup, then sup-inf) when (parity0
// + j s + c) is even and ISoSI otherwise; any k >= 1, either parity0.
//
// Bits. The state is kept as 32-bit words of 32 cells along a window row
// (bit b of word j is window column 32 j + b). An elementary op computes a
// word from three rows of three words: the left and right neighbor cells
// come in by funnel shift from the neighbor words, so on words
//   sup-inf  u & ((L & R) | (U & D) | (UL & DR) | (UR & DL))
//   inf-sup  u | ((L | R) & (U | D) & (UL | DR) & (UR | DL))
//   dilation, erosion: OR, AND of the nine,
// exactly the float min/max of the plain version on {0, 1}. The side
// information is kept as bit planes built once at load:
//   ACWE (acwe, fused): neg = f < 0 and pos = f > 0 (a zero or NaN force
//     sets neither); with g = (U ^ D) | (L ^ R) the update is
//     u' = (u & ~(g & (neg | pos))) | (g & neg).
//   GAC: the balloon mask (g > thr_b, or aux[2] > 0 for gac_pre) and the
//     attraction a = dgx dux + dgy duy, dux, duy in {-1/2, +0, 1/2},
//     rounded once (__fadd_rn of __fmul_rn). A cell's a depends on its dgx,
//     dgy only through the sign of the rounded sum for the nine (dux, duy);
//     (0, 0) always keeps the cell, and negating both factors' nonzero
//     value negates the rounded sum exactly (NaN stays NaN, a zero stays a
//     zero), so four pairs (1/2, 0), (0, 1/2), (1/2, 1/2), (1/2, -1/2) each
//     with a "> 0" and a "< 0" plane carry it: eight planes, one byte a
//     cell in place of 8 B of f32 (tests/test_torch_morph_bits.py checks
//     the identity over NaN, +-Inf, +-0, denormals and +-FLT_MAX).
//
// Load and store. A warp walks whole window rows: its lanes load 32
// consecutive floats (128 B coalesced) for word j, eight words (GAC from
// the edge map: four) in flight a lane, and __ballot_sync(~0u, ls > 0.5f)
// is the word; the planes are ballots of the same loads, and lane j keeps
// word j of the row for one shared-memory store a plane. The store gives
// each lane its bit back as 0.0f or 1.0f (K12: u0 of eight words in flight
// for the partials). Device memory moves 12 B a pixel a launch (20 for
// gac_pre), the bytes bound's count.
//
// Tiling. A block owns a TH x TW tile of the tiled region (the image, or a
// shard block's crop) and holds the window: the tile extended by `halo` =
// R k cells (R = 1 + 2s ACWE, 2 + 2s GAC) each way, cut at the clamp box,
// in whole words across (the last word's bits past the box are loaded as
// the box's last column). Reads are clamped at the window's bounds: where
// a bound is the box's edge that is exactly the replica convention (the
// right neighbor of the box's last column is that column: the last word's
// shifted-in bit is masked), elsewhere the error front moves one cell an op
// and stays in the discarded halo. So op i of a launch computes only the
// window rows at least i cells from a bound that is not the box's edge
// (the rows of the window less i each way); the columns' halo is one word.
// Two state buffers ping-pong, one barrier an op; a thread walks a run of
// rows of one word column, keeping the row above and its own in registers.
//
// Shard blocks (acwe_sh, gac_pre_sh: a shard's halo-padded (H, W) block of
// the sharded solver, own cells the crop [r0, r1) x [c0, c1)). The first
// body refreshes the depth-1 replica ring on the flagged (global-edge)
// sides before every elementary op, rows first, then columns. The crop's
// cells then read, at every op, their own edge cell where they read the
// ring: the replica convention at the crop's edge, corner included. So
// here the clamp box is the crop on the flagged sides and the block on the
// others, and the ring needs no copy at all: the op's own clamped reads
// are the refresh. The pads past a flagged side's ring never reach the
// crop. Cells outside the crop come back as they went in.
//
// K12 (fused): the force f = l1 (u0 - c_in)^2 - l2 (u0 - c_out)^2 from u0
// and cc = (c_in, c_out, l1, l2), rounded op by op as morph.cuh; the store
// sums the owned cells' ls (an exact integer) and u0 ls (f64 of the f32
// product, u0 re-read), and the last block of the launch to finish sums
// the blocks' partials in a fixed order (one counter word a stream, which
// that block sets back to 0; sweep.cuh's pattern) into parts[2].
//
// Bound on the card: device memory (12 B a pixel, 20 for gac_pre) and the
// load's latency. An op costs about one integer instruction a cell; the
// load, the planes and the store take most of a launch
// (chip_morph_variants.py's noops), and an SM's one or two blocks load,
// sweep and store in step.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace cv {
namespace bits {
namespace {

// kind codes (ops/_cuda.py MORPH_KINDS, morph.cuh's MorphKind)
enum BitsKind { kAcwe = 0, kGac = 1, kGacPre = 2, kFused = 3, kAcweSh = 4,
                kGacPreSh = 5 };

constexpr int kThreads = 512;  // ops/_cuda.py MORPH_THREADS

template <int KIND>
__host__ __device__ constexpr int base_kind() {
  return KIND == kAcweSh ? kAcwe : (KIND == kGacPreSh ? kGacPre : KIND);
}
template <int KIND>
__host__ __device__ constexpr bool is_gac() {
  return base_kind<KIND>() == kGac || base_kind<KIND>() == kGacPre;
}
// shared-memory words a window word (ops/_cuda.py MORPH_WORDS): two state
// buffers and the two force-sign planes, or the eight attraction planes,
// the balloon mask and two state buffers
template <int KIND>
__host__ __device__ constexpr int words_per_word() {
  return is_gac<KIND>() ? 11 : 4;
}

struct BitsArgs {
  const float* ls;
  const float* aux;  // f, u0 (fused), g (gac) or the (3, H, W) stack
  const float* cc;   // fused: c_in, c_out, l1, l2
  float* out;
  double* block_parts;    // fused: (nblocks, 2)
  unsigned int* counter;  // fused: one word, 0 on entry and on exit
  float* parts;           // fused: (2,)
  int H, W, k, s, parity0, balloon;
  float thr_b;
  int halo, TH, TW, WW;
  int r0, r1, c0, c1;      // the tiled region
  int br0, br1, bc0, bc1;  // the clamp box
  int nblocks;
};

// a window row's word and its left- and right-shifted neighbors: l holds
// each cell's left neighbor, r its right neighbor
struct Row {
  uint32_t l, x, r;
};

// Row r of the window at word column j: the neighbor words clamped at the
// window's sides (bit 0 replicated on the left, bit 31 on the right); emask
// (the last word only) is the bit of the box's last column, whose right
// neighbor is itself.
__device__ __forceinline__ Row row_at(const uint32_t* s, int r, int j,
                                      int ww, uint32_t emask) {
  const uint32_t* p = s + r * ww + j;
  const uint32_t x = p[0];
  const uint32_t lw = j > 0 ? p[-1] : x << 31;
  const uint32_t rw = j < ww - 1 ? p[1] : x >> 31;
  const uint32_t rr = __funnelshift_r(x, rw, 1);
  return Row{__funnelshift_l(lw, x, 1), x, rr ^ ((rr ^ x) & emask)};
}

__device__ __forceinline__ uint32_t sup_inf(const Row& a, const Row& c,
                                            const Row& b) {
  return c.x & ((c.l & c.r) | (a.x & b.x) | (a.l & b.r) | (a.r & b.l));
}
__device__ __forceinline__ uint32_t inf_sup(const Row& a, const Row& c,
                                            const Row& b) {
  return c.x | ((c.l | c.r) & (a.x | b.x) & (a.l | b.r) & (a.r | b.l));
}

// Sum over the block in a fixed order (warp shuffles, then the warps in
// order in thread 0); valid in thread 0.
__device__ __forceinline__ double block_total(double v, double* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double t = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += scratch[w];
  __syncthreads();
  return t;
}

// Dynamic shared memory, cap = window rows x WW words:
//   ACWE kinds: cur[cap] | nxt[cap] | neg[cap] | pos[cap]
//   GAC kinds:  att[cap] uint4 x 2 (A+, A-, B+, B-, C+, C-, D+, D-) |
//               mask[cap] | cur[cap] | nxt[cap]
template <int KIND>
__global__ void __launch_bounds__(kThreads, 2)
morph_bits_kernel(const BitsArgs A, int cap) {
  extern __shared__ __align__(16) uint32_t bits_smem[];
  __shared__ double red_scratch[2][kThreads / 32];
  __shared__ float s_cc[4];
  __shared__ bool s_last;
  constexpr bool kGacK = is_gac<KIND>();
  constexpr bool kShard = KIND == kAcweSh || KIND == kGacPreSh;
  constexpr int kBase = base_kind<KIND>();
  uint4* att = reinterpret_cast<uint4*>(bits_smem);
  uint32_t* mask = bits_smem + 8 * cap;
  uint32_t* cur = bits_smem + (kGacK ? 9 : 0) * cap;
  uint32_t* nxt = cur + cap;
  uint32_t* neg = cur + 2 * cap;
  uint32_t* pos = cur + 3 * cap;

  const int H = A.H, W = A.W;
  const int tr0 = A.r0 + blockIdx.y * A.TH, tc0 = A.c0 + blockIdx.x * A.TW;
  const int tr1 = min(tr0 + A.TH, A.r1), tc1 = min(tc0 + A.TW, A.c1);
  const int wr0 = max(tr0 - A.halo, A.br0), wr1 = min(tr1 + A.halo, A.br1);
  const int wc0 = max(tc0 - A.halo, A.bc0);
  const int ww = (min(tc1 + A.halo, A.bc1) - wc0 + 31) >> 5;
  const int wcr = min(wc0 + 32 * ww, A.bc1);  // past the window's last cell
  const int wh = wr1 - wr0;
  const bool top_box = wr0 == A.br0, bottom_box = wr1 == A.br1;
  const int64_t plane = (int64_t)H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  if (KIND == kFused) {
    if (threadIdx.x < 4) s_cc[threadIdx.x] = A.cc[threadIdx.x];
    __syncthreads();
  }

  // load: one window row a warp at a time, kU words in flight a lane
  constexpr int kU = KIND == kGac ? 4 : 8;
  for (int r = warp; r < wh; r += nwarps) {
    const int gr = wr0 + r;
    const int64_t grow = (int64_t)gr * W;
    uint32_t m_ls = 0, m_a = 0, m_b = 0, m_m = 0;
    uint32_t m_att[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int j0 = 0; j0 < ww; j0 += kU) {
      float v_ls[kU], v_a[kU], v_b[kU], v_c[kU], v_d[kU], v_e[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int gc = min(wc0 + 32 * (j0 + u) + lane, wcr - 1);
        const int64_t g = grow + gc;
        v_ls[u] = __ldg(A.ls + g);
        if constexpr (kBase == kAcwe || KIND == kFused) {
          v_a[u] = __ldg(A.aux + g);
        } else if constexpr (kBase == kGacPre) {
          v_a[u] = __ldg(A.aux + g);
          v_b[u] = __ldg(A.aux + plane + g);
          v_c[u] = __ldg(A.aux + 2 * plane + g);
        } else {  // gac: g and its four neighbors, clamped at the box
          v_a[u] = __ldg(A.aux + (int64_t)min(gr + 1, A.br1 - 1) * W + gc);
          v_b[u] = __ldg(A.aux + (int64_t)max(gr - 1, A.br0) * W + gc);
          v_c[u] = __ldg(A.aux + grow + min(gc + 1, A.bc1 - 1));
          v_d[u] = __ldg(A.aux + grow + max(gc - 1, A.bc0));
          v_e[u] = __ldg(A.aux + g);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const bool mine = lane == j0 + u;
        const uint32_t b_ls = __ballot_sync(~0u, v_ls[u] > 0.5f);
        m_ls = mine ? b_ls : m_ls;
        if constexpr (kGacK) {
          float dgx, dgy;
          bool msk;
          if constexpr (kBase == kGacPre) {
            dgx = v_a[u];
            dgy = v_b[u];
            msk = v_c[u] > 0.0f;
          } else {
            dgx = __fmul_rn(0.5f, __fsub_rn(v_a[u], v_b[u]));
            dgy = __fmul_rn(0.5f, __fsub_rn(v_c[u], v_d[u]));
            msk = v_e[u] > A.thr_b;
          }
          const float hx = __fmul_rn(dgx, 0.5f), hy = __fmul_rn(dgy, 0.5f);
          const float zx = __fmul_rn(dgx, 0.0f), zy = __fmul_rn(dgy, 0.0f);
          const float sums[4] = {__fadd_rn(hx, zy), __fadd_rn(zx, hy),
                                 __fadd_rn(hx, hy),
                                 __fadd_rn(hx, __fmul_rn(dgy, -0.5f))};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t bp = __ballot_sync(~0u, sums[q] > 0.0f);
            const uint32_t bn = __ballot_sync(~0u, sums[q] < 0.0f);
            m_att[2 * q] = mine ? bp : m_att[2 * q];
            m_att[2 * q + 1] = mine ? bn : m_att[2 * q + 1];
          }
          const uint32_t bm = __ballot_sync(~0u, msk);
          m_m = mine ? bm : m_m;
        } else {
          float f = v_a[u];
          if constexpr (KIND == kFused) {
            const float d1 = __fsub_rn(f, s_cc[0]);
            const float d2 = __fsub_rn(f, s_cc[1]);
            f = __fsub_rn(__fmul_rn(s_cc[2], __fmul_rn(d1, d1)),
                          __fmul_rn(s_cc[3], __fmul_rn(d2, d2)));
          }
          const uint32_t bn = __ballot_sync(~0u, f < 0.0f);
          const uint32_t bp = __ballot_sync(~0u, f > 0.0f);
          m_a = mine ? bn : m_a;
          m_b = mine ? bp : m_b;
        }
      }
    }
    if (lane < ww) {
      const int idx = r * ww + lane;
      cur[idx] = m_ls;
      if constexpr (kGacK) {
        att[2 * idx] = make_uint4(m_att[0], m_att[1], m_att[2], m_att[3]);
        att[2 * idx + 1] = make_uint4(m_att[4], m_att[5], m_att[6], m_att[7]);
        mask[idx] = m_m;
      } else {
        neg[idx] = m_a;
        pos[idx] = m_b;
      }
    }
  }
  __syncthreads();

  // the bit of the box's last column in the window's last word
  const uint32_t last_bit = 1u << ((wcr - 1 - wc0) & 31);
  int op = 0;
  // One elementary op: nxt = f(above, row, below, index) over the window
  // rows at least `op` cells from a side that is not the box's edge, each
  // thread on runs of rows of one word column; then the block syncs.
  auto pass = [&](auto f) {
    ++op;
    const int rlo = top_box ? 0 : op, rhi = bottom_box ? wh : wh - op;
    const int rows = rhi - rlo;
    const int run = max(1, (rows * ww + blockDim.x - 1) / blockDim.x);
    const int nruns = (rows + run - 1) / run;
    for (int it = threadIdx.x; it < nruns * ww; it += blockDim.x) {
      const int q = it / ww, j = it - q * ww;
      const uint32_t em = j == ww - 1 ? last_bit : 0u;
      const int rs = rlo + q * run, re = min(rs + run, rhi);
      Row a = row_at(cur, max(rs - 1, 0), j, ww, em);
      Row c = row_at(cur, rs, j, ww, em);
      for (int r = rs; r < re; ++r) {
        const Row b = row_at(cur, min(r + 1, wh - 1), j, ww, em);
        nxt[r * ww + j] = f(a, c, b, r * ww + j);
        a = c;
        c = b;
      }
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  };

  for (int j = 0; j < A.k; ++j) {
    if constexpr (kGacK) {
      if (A.balloon != 0) {
        const bool grow = A.balloon > 0;
        pass([&](const Row& a, const Row& c, const Row& b, int idx) {
          const uint32_t m = mask[idx];
          const uint32_t d =
              grow ? (a.l | a.x | a.r | c.l | c.x | c.r | b.l | b.x | b.r)
                   : (a.l & a.x & a.r & c.l & c.x & c.r & b.l & b.x & b.r);
          return (c.x & ~m) | (d & m);
        });
      }
      pass([&](const Row& a, const Row& c, const Row& b, int idx) {
        const uint4 p = att[2 * idx], n = att[2 * idx + 1];
        // dux = +1/2 where (up, down) = (0, 1), -1/2 where (1, 0); duy
        // the same of (left, right)
        const uint32_t xp = b.x & ~a.x, xn = a.x & ~b.x, xz = ~(a.x ^ b.x);
        const uint32_t yp = c.r & ~c.l, yn = c.l & ~c.r, yz = ~(c.l ^ c.r);
        const uint32_t pa = xp & yz, na = xn & yz, pb = xz & yp, nb = xz & yn;
        const uint32_t pc = xp & yp, nc = xn & yn, pd = xp & yn, nd = xn & yp;
        const uint32_t one = (pa & p.x) | (na & p.y) | (pb & p.z) |
                             (nb & p.w) | (pc & n.x) | (nc & n.y) |
                             (pd & n.z) | (nd & n.w);
        const uint32_t zero = (pa & p.y) | (na & p.x) | (pb & p.w) |
                              (nb & p.z) | (pc & n.y) | (nc & n.x) |
                              (pd & n.w) | (nd & n.z);
        return (c.x | one) & ~zero;
      });
    } else {
      pass([&](const Row& a, const Row& c, const Row& b, int idx) {
        const uint32_t g = (a.x ^ b.x) | (c.l ^ c.r);
        const uint32_t ng = neg[idx];
        return (c.x & ~(g & (ng | pos[idx]))) | (g & ng);
      });
    }
    for (int c = 0; c < A.s; ++c) {
      const bool sioi = ((A.parity0 + j * A.s + c) & 1) == 0;
      for (int half = 0; half < 2; ++half) {
        // SIoIS: inf-sup first; ISoSI: sup-inf first
        if (sioi == (half == 0))
          pass([](const Row& a, const Row& c, const Row& b, int) {
            return inf_sup(a, c, b);
          });
        else
          pass([](const Row& a, const Row& c, const Row& b, int) {
            return sup_inf(a, c, b);
          });
      }
    }
  }

  // store the tile: each lane its bit of the row's word (K12: and u0 of
  // kS words in flight for the partials)
  double acc_s = 0.0;
  int acc_n = 0;
  const int jt0 = (tc0 - wc0) >> 5, jt1 = (tc1 - 1 - wc0) >> 5;
  constexpr int kS = KIND == kFused ? 8 : 1;
  for (int r = tr0 - wr0 + warp; r < tr1 - wr0; r += nwarps) {
    const int64_t grow = (int64_t)(wr0 + r) * W;
    for (int j0 = jt0; j0 <= jt1; j0 += kS) {
      float u0v[kS];
      if constexpr (KIND == kFused) {
#pragma unroll
        for (int u = 0; u < kS; ++u) {
          const int c = wc0 + 32 * (j0 + u) + lane;
          u0v[u] = j0 + u <= jt1 && c >= tc0 && c < tc1
                       ? __ldg(A.aux + grow + c) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kS; ++u) {
        const int j = j0 + u, c = wc0 + 32 * j + lane;
        if (j > jt1) break;
        const uint32_t bit = (cur[r * ww + j] >> lane) & 1u;
        if (c >= tc0 && c < tc1) {
          const float v = bit ? 1.0f : 0.0f;
          A.out[grow + c] = v;
          if constexpr (KIND == kFused) {
            acc_n += (int)bit;
            acc_s += (double)__fmul_rn(u0v[u], v);
          }
        }
      }
    }
  }
  if constexpr (kShard) {
    // the block outside the crop passes through: a block on the tile
    // grid's border also copies the pad cells beyond its tile
    const int er0 = blockIdx.y == 0 ? 0 : tr0;
    const int er1 = blockIdx.y == gridDim.y - 1 ? H : tr1;
    const int ec0 = blockIdx.x == 0 ? 0 : tc0;
    const int ec1 = blockIdx.x == gridDim.x - 1 ? W : tc1;
    for (int r = er0 + warp; r < er1; r += nwarps) {
      for (int c = ec0 + lane; c < ec1; c += 32) {
        if (r < tr0 || r >= tr1 || c < tc0 || c >= tc1) {
          const int64_t g = (int64_t)r * W + c;
          A.out[g] = __ldg(A.ls + g);
        }
      }
    }
  }
  if constexpr (KIND == kFused) {
    const double n = block_total((double)acc_n, red_scratch[0]);
    const double t = block_total(acc_s, red_scratch[1]);
    if (threadIdx.x == 0) {
      const int64_t bid = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
      A.block_parts[2 * bid] = n;
      A.block_parts[2 * bid + 1] = t;
      __threadfence();  // this block's row, then its count
      s_last = atomicAdd(A.counter, 1u) == (unsigned int)(A.nblocks - 1);
      if (s_last) *A.counter = 0u;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();  // every row counted before this block reads them
    double a0 = 0.0, a1 = 0.0;
    for (int b = threadIdx.x; b < A.nblocks; b += blockDim.x) {
      a0 += __ldcg(A.block_parts + 2 * (int64_t)b);
      a1 += __ldcg(A.block_parts + 2 * (int64_t)b + 1);
    }
    a0 = block_total(a0, red_scratch[0]);
    a1 = block_total(a1, red_scratch[1]);
    if (threadIdx.x == 0) {
      A.parts[0] = (float)a0;
      A.parts[1] = (float)a1;
    }
  }
}

template <int KIND>
size_t smem_bytes(int cap) {
  return (size_t)cap * words_per_word<KIND>() * sizeof(uint32_t);
}

// Host side: one launch of the TH x TW tiles of the region [r0, r1) x [c0,
// c1) on `stream`. WW: window words, cap = window rows x WW (the caller's
// geometry, ops/_cuda.py morph_geometry); nblocks must be the grid's. A
// halo shorter than the launch's ops is refused.
template <int KIND>
cudaError_t launch(BitsArgs A, int cap, cudaStream_t stream) {
  const int nops =
      A.k * ((is_gac<KIND>() ? (A.balloon != 0) + 1 : 1) + 2 * A.s);
  const int th = A.r1 - A.r0, tw = A.c1 - A.c0;
  if (A.k < 1 || A.s < 0 || A.halo < nops || A.TH < 1 || A.TW < 1 ||
      th < 1 || tw < 1 || A.WW < 1 || A.WW > 32 ||
      min(A.TW + 2 * A.halo, A.bc1 - A.bc0) > 32 * A.WW ||
      min(A.TH + 2 * A.halo, A.br1 - A.br0) * A.WW > cap)
    return cudaErrorInvalidValue;
  const dim3 grid((tw + A.TW - 1) / A.TW, (th + A.TH - 1) / A.TH);
  if ((int64_t)grid.x * grid.y != A.nblocks) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<KIND>(cap);
  cudaError_t err = cudaFuncSetAttribute(
      morph_bits_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  morph_bits_kernel<KIND><<<grid, kThreads, smem, stream>>>(A, cap);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t occupancy(int cap, int* blocks) {
  const size_t smem = smem_bytes<KIND>(cap);
  cudaError_t err = cudaFuncSetAttribute(
      morph_bits_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, morph_bits_kernel<KIND>, kThreads, smem);
}

}  // namespace
}  // namespace bits
}  // namespace cv
