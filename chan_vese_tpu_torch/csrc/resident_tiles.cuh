// The Hopper exact-means resident bodies on persistent shared-memory
// tiles: the two-phase body of K7 (resident.cu, resident_mc.cu; flat
// layout) and K8 (packed_resident.cu, packed_resident_mc.cu; parity
// planes), its frozen-means mode (K13, resident_chunk.cu), and the tile,
// rim and grid-step templates that mp2.cuh's 4-phase body (K9's resident
// mode, K10) is built on.
//
// What a launch computes: `iters` full Chan-Vese iterations with the
// region means recomputed from the current phi at every iteration (no
// frozen-means chunk, no lag), the contract of
// chan_vese_tpu/ops/pallas_resident.py::_kernel/_kernel_batch/_kernel_mc
// and ops/pallas_packed.py::_packed_resident_*kernel, on a scalar image,
// on each frame of a stack, or on a C-channel image. Per iteration
//   c1 = s_uH / max(s_H, 1e-30), c2 = (sum u - s_uH) / max(n - s_H, 1e-30)
// per channel, from the phi the iteration starts from; the data term of
// redblack.cuh::data_term (l[c]/C weights for C channels); the red, then
// the black half-sweep of redblack.cuh::update_cell_at (_update_all's
// semantics, replica-eval Neumann at the image edges). The partials rows
// [s_uH per channel..., s_H, s_dphi2, flips, s_absdphi, 0...] describe
// every `unroll`-th iteration (a stack: each frame's last). The f64 sums
// behind the means are added by tile, in block order.
//
// Design:
// - Tiles. One cooperative grid of at most the co-resident blocks, one an
//   SM (ops/_cuda.py resident_tile_geometry picks a GY x GX grid of
//   TH x TW tiles, TW even, the last row and column ragged). Block b owns
//   one rectangle, loads it once a frame into dynamic shared memory padded
//   by a one-cell ring, keeps it there for all iterations and stores it
//   once. u0 (every channel) stays in shared memory too where the budget
//   allows (u0res), else it is read through L2 (read-only, never stale).
//   In shared memory the cells are split by colour (Tile's index), so a
//   warp's reads of the active colour and of its neighbours are stride 1.
// - Two values of the active colour. update_cell_at reads the diagonals
//   nw, ne and sw, which have the cell's own colour, at their values
//   before the half-sweep: an update in place would read a neighbour's new
//   value. So a half-sweep writes its new values to a half-size buffer N,
//   and after a block barrier the commit moves them into the tile (where
//   the old value is at hand for the partials) and accumulates the sums.
// - Rims between neighbours, not grid syncs. After each commit a block
//   stores the new values on its tile's border in its rim (global memory,
//   [top TW | bottom TW | left TH | right TH], one buffer per parity of the
//   iteration), each cell a 64-bit word: the value and the tag of the
//   iteration that wrote it, stored and read whole (relaxed, through L2).
//   A neighbour waits for the tag it needs on each ring cell it reads, so
//   the wait and the transfer are one read. Before the black half-sweep a
//   block reads its four side neighbours' new red border cells (the black
//   half-sweep reads no corner and no black ring cell that changed in this
//   iteration); the whole ring (sides and the nw, ne, sw corners) is read
//   from the other parity's rims while the block waits for the means.
// - One grid-wide step an iteration. After the black commit each block
//   posts its f64 sums (the next iteration's H sums, the row sums) to its
//   slots; the last block to arrive (an acq_rel atomic ticket) adds every
//   slot in block order, computes the means and the partials row, and
//   publishes each mean in a word tagged with the step (a release store);
//   the others' threads wait for the tags (relaxed reads, then an acquire
//   fence) while the rest of the block reads the next ring. The first
//   step of a frame reduces the input's H sums (iteration 0's means).
// - Ordering. Tags make each rim word self-describing; the parity buffers
//   keep a block two iterations (two grid-wide steps, whose words are
//   released and acquired) from overwriting a rim its neighbours have yet
//   to read; tags grow for the whole launch (a frame's load takes a new
//   one), and the wrapper zeroes the rims and the sync words. Spin-waits
//   need every block resident: the launch is cooperative and a grid above
//   capacity is refused.
// - Frame groups (a stack). The grid is G groups of B blocks (blocks
//   [g B, (g + 1) B) form group g, ops/_cuda.py frame_groups picks G from
//   the stack's shape); group g runs frames g, g + G, g + 2G, ... in turn,
//   its B tiles covering one frame. Everything above is scoped to the
//   group: its blocks' rims, its slots and totals in `scratch`, its own
//   SyncBuf (ticket and words), its block order for the sums, and a step
//   of its B blocks. Groups never wait on each other, so one iteration's
//   skeleton (waits, step) serves G frames. The instance with GROUPS
//   takes a stack of G > 1 groups; the others are the one-group body on
//   the whole grid (a scalar or C-channel image, K13, a stack of G = 1),
//   compiled as before the groups, as is K9/K10's body (mp2.cuh).
// Per iteration a block does two barriered half-sweeps on shared memory,
// one neighbour wait and one step of its group; device memory is touched
// when a frame is loaded and stored (and for u0 where it is not resident).
//
// Frozen-means mode (FROZEN, K13: a scalar image, (c1, c2) from `wts`,
// unroll = iters): the contract of ops/pallas_packed.py::packed_chunk and
// of banded_chunk, k iterations with (c1, c2) held fixed and one partials
// row of the last, [s_uH, s_H] of the phi it leaves and [s_dphi2, flips,
// s_absdphi] of its transition. With no means
// to wait for, the tile's shared copy of u0 holds the data term itself
// (the same expression on the same values, computed once), each black
// commit is followed by the whole ring of the next iteration read from
// the iteration's rims, and the only grid-wide step is the last
// iteration's, which adds the blocks' H sums and row sums in block order.
// The parity buffers stay safe without the steps: a block writes a
// parity's rims again two iterations on, only after its own ring waits
// have seen every side neighbour's commit of the iteration between, which
// each neighbour makes after its own reads of that parity (the corners
// included, through the side neighbours they share).
//
// Bound on the card: per iteration 55 operations a cell update plus the
// data term and the means (chip_smoke.py::bound); the neighbour wait and
// the grid-wide step are a fixed cost a few microseconds long that sets
// the pace of small images.

#pragma once

#include "redblack.cuh"

namespace cv {
namespace {

constexpr int kTileThreads = 512;  // ops/_cuda.py TILE_THREADS
constexpr int kTileWarps = kTileThreads / 32;
// cycles after which a spin-wait traps (~10 s at the H100's clock): only a
// fault of the schedule gets there, since every block is resident
constexpr long long kSpinCycles = 20000000000LL;

typedef unsigned long long Word;  // a float in the low half, a tag above

__device__ __forceinline__ Word ld_relaxed(const Word* p) {
  Word v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(Word* p, Word v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ void st_release(Word* p, Word v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p,
                                                     unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ Word tagged(float v, unsigned tag) {
  return ((Word)tag << 32) | __float_as_uint(v);
}

// The value of the word at p once it carries `tag` (relaxed reads).
__device__ __forceinline__ float wait_word(const Word* p, unsigned tag) {
  Word x = ld_relaxed(p);
  if ((unsigned)(x >> 32) != tag) {
    const long long t0 = clock64();
    do {
      if (clock64() - t0 > kSpinCycles) __trap();
      x = ld_relaxed(p);
    } while ((unsigned)(x >> 32) != tag);
  }
  return __uint_as_float((unsigned)x);
}

// The sync buffer (u32, zeroed by the wrapper for every launch): the
// grid-wide step's arrival ticket and a spare, then the words the step
// publishes (one a mean, 2 kMaxChannels at most; ops/_cuda.py TILE_SYNC).
// A frame group's starts kSyncStride u32s after the group before's, on a
// cache line of its own (ops/_cuda.py TILE_SYNC_STRIDE).
constexpr int kSyncStride = 64;
struct SyncBuf {
  unsigned* ticket;
  Word* words;
  __device__ explicit SyncBuf(unsigned* sync)
      : ticket(sync), words((Word*)(sync + 2)) {}
};

// Block b's rectangle (b: blockIdx.x unless given, a frame group's own
// block index): tile (by, bx) of a GY x GX grid of TH x TW tiles, rows
// [r0, r1) x cols [c0, c1). As an index functor: the offset of
// global cell (i, j) in the tile padded by one cell a side, split by
// colour: plane (i + j) & 1 of (th + 2) rows of pw = (tw + 2) / 2 cells,
// cell (i, j) at its row's column (j - c0 + 1) / 2 (a row's cells of one
// colour are every other one). update_cell_at reads it with its clamps at
// the image edges. u(i, j): the same split of the tile without the ring.
struct Tile {
  int by, bx, r0, r1, c0, c1, th, tw, pw;
  __device__ Tile(int H, int W, int TH, int TW, int GX) {
    place(blockIdx.x, H, W, TH, TW, GX);
  }
  __device__ Tile(int H, int W, int TH, int TW, int GX, int b) {
    place(b, H, W, TH, TW, GX);
  }
  // B: unsigned for blockIdx.x, so the one-group bodies and mp2.cuh's
  // compile to the instructions they had before the frame groups
  template <class B>
  __device__ void place(B b, int H, int W, int TH, int TW, int GX) {
    by = b / GX;
    bx = b - by * GX;
    r0 = by * TH;
    c0 = bx * TW;
    r1 = min(r0 + TH, H);
    c1 = min(c0 + TW, W);
    th = r1 - r0;
    tw = c1 - c0;
    pw = (tw + 2) >> 1;
  }
  __device__ __forceinline__ int operator()(int i, int j) const {
    return (((i + j) & 1) * (th + 2) + i - r0 + 1) * pw + ((j - c0 + 1) >> 1);
  }
  __device__ __forceinline__ int u(int i, int j) const {
    return (((i + j) & 1) * th + i - r0) * (tw >> 1) + ((j - c0) >> 1);
  }
};

// A thread's cell pairs k = threadIdx.x + m blockDim.x of a tile hw
// pairs wide, at row lr, pair q of the row, stepped without a division.
struct Pairs {
  int lr0, q0, dlr, dq, hw;
  __device__ explicit Pairs(int hw_) : hw(hw_) {
    lr0 = threadIdx.x / hw;
    q0 = threadIdx.x - lr0 * hw;
    dlr = blockDim.x / hw;
    dq = blockDim.x - dlr * hw;
  }
  __device__ __forceinline__ void next(int& lr, int& q) const {
    lr += dlr;
    q += dq;
    if (q >= hw) q -= hw, ++lr;
  }
};

// Words of a block's rim: [top row TW | bottom row TW | left col TH |
// right col TH].
__host__ __device__ constexpr int rim_len(int TH, int TW) {
  return 2 * (TH + TW);
}

// Dynamic shared memory of a body: the padded tile and the half-size new
// values per level set (two level sets: both, and a label byte a cell),
// and u0's nc planes where u0res.
__host__ __device__ constexpr int tile_smem_bytes(int TH, int TW, int nc,
                                                  int level_sets,
                                                  int u0res) {
  return level_sets == 1
             ? 4 * ((TH + 2) * (TW + 2) + TH * TW / 2 +
                    (u0res ? nc * TH * TW : 0))
             : 4 * (2 * (TH + 2) * (TW + 2) + TH * TW +
                    (u0res ? TH * TW : 0)) +
                   TH * TW;
}

// Stores cell (i, j)'s new value v, tagged, in every border of the rim it
// lies on.
__device__ __forceinline__ void publish(Word* rim, const Tile& t, int TH,
                                        int TW, int i, int j, float v,
                                        unsigned tag) {
  const int lr = i - t.r0, lc = j - t.c0;
  const Word w = tagged(v, tag);
  if (lr == 0) st_relaxed(rim + lc, w);
  if (lr == t.th - 1) st_relaxed(rim + TW + lc, w);
  if (lc == 0) st_relaxed(rim + 2 * TW + lr, w);
  if (lc == t.tw - 1) st_relaxed(rim + 2 * TW + TH + lr, w);
}

// Fills the padded tile S's ring from the neighbours' rims in `rims` (one
// parity's buffer, block b's rim at rims + b * rim_len), each cell once
// its word carries `tag`: the four sides and the nw, ne and sw corners
// (update_cell_at never reads se), on the threads from `first` on. Ring
// cells past the image edge are never read (the clamps) and stay unset.
// red_only: the sides' red cells ((i + j) even) alone, before the black
// half-sweep.
__device__ __forceinline__ void fill_ring(float* S, const Word* rims,
                                          const Tile& t, int TH, int TW,
                                          int GX, int GY, bool red_only,
                                          unsigned tag, int first = 0) {
  const int len = rim_len(TH, TW);
  const int sides = 2 * t.tw + 2 * t.th;
  for (int k = threadIdx.x - first; k < sides + 3; k += blockDim.x - first) {
    if (k < 0) break;
    int i, j, dy, dx, off;  // the cell, its owner's offset, its rim slot
    if (k < t.tw) {  // top: the bottom row of the tile above
      i = t.r0 - 1, j = t.c0 + k, dy = -1, dx = 0, off = TW + k;
    } else if (k < 2 * t.tw) {  // bottom: the top row of the one below
      i = t.r1, j = t.c0 + k - t.tw, dy = 1, dx = 0, off = k - t.tw;
    } else if (k < 2 * t.tw + t.th) {  // left: the left one's right col
      const int r = k - 2 * t.tw;
      i = t.r0 + r, j = t.c0 - 1, dy = 0, dx = -1, off = 2 * TW + TH + r;
    } else if (k < sides) {  // right: the right one's left col
      const int r = k - 2 * t.tw - t.th;
      i = t.r0 + r, j = t.c1, dy = 0, dx = 1, off = 2 * TW + r;
    } else if (k == sides) {  // nw: the last of the up-left's bottom row
      i = t.r0 - 1, j = t.c0 - 1, dy = -1, dx = -1, off = 2 * TW - 1;
    } else if (k == sides + 1) {  // ne: the first of the up-right's bottom
      i = t.r0 - 1, j = t.c1, dy = -1, dx = 1, off = TW;
    } else {  // sw: the last of the down-left's top row
      i = t.r1, j = t.c0 - 1, dy = 1, dx = -1, off = TW - 1;
    }
    const int ny = t.by + dy, nx = t.bx + dx;
    if (ny < 0 || ny >= GY || nx < 0 || nx >= GX) continue;
    if (red_only && ((dy != 0 && dx != 0) || ((i + j) & 1))) continue;
    S[t(i, j)] = wait_word(rims + (int64_t)(ny * GX + nx) * len + off, tag);
  }
}

// Posts the block's f64 sums v[lo, hi) to its row of `slots` (K a row;
// row b, blockIdx.x unless given): each warp's sum by a shuffle tree, then
// the warps' sums in warp order.
template <int K>
__device__ __forceinline__ void post_sums(const double (&v)[K], int lo,
                                          int hi, double* slots,
                                          double (*s_red)[K], int b = -1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < lo || s >= hi) continue;
    double x = v[s];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) s_red[warp][s] = x;
  }
  __syncthreads();
  const int s = threadIdx.x;
  if (s >= lo && s < hi) {
    double x = 0.0;
    for (int w = 0; w < kTileWarps; ++w) x += s_red[w][s];
    __stcg(slots + (b < 0 ? (int64_t)blockIdx.x : (int64_t)b) * K + s, x);
  }
}

// The grid-wide step `step` (0, 1, ... alike in every block) of `nblk`
// blocks (0: the grid; a frame group's B, with the group's slots and
// SyncBuf). Every block has posted its slots [lo, hi) (rows of K). The last
// block to arrive (an acq_rel ticket) adds each slot over the blocks in
// block order into s_tot[0, K) while its last warp reads the ncarry doubles
// `carry` (an earlier step's) into s_tot[K, K + ncarry); then its thread t <
// nw computes word(t, s_tot) and publishes it, tagged with the step, in
// sync.words[t] (a release store), and finish(s_tot) runs on its thread nw.
// The other blocks' threads t < nw wait for their word's tag (then an
// acquire fence). Meanwhile every block's threads from nw on run during(nw)
// (the next iteration's ring). On return s_val[t < nw] holds the words in
// every block.
template <int K, class Mean, class Finish, class During>
__device__ __forceinline__ void grid_step(const double* slots, int lo,
                                          int hi, SyncBuf sync, unsigned step,
                                          double* s_tot, const double* carry,
                                          int ncarry, float* s_val, int nw,
                                          int* s_last, Mean word,
                                          Finish finish, During during,
                                          int nblk = 0) {
  const unsigned nb = nblk > 0 ? nblk : gridDim.x;
  const unsigned tag = step + 1;
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atom_add_acq_rel(sync.ticket, 1u) == (step + 1) * nb - 1;
  __syncthreads();
  if (*s_last) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int s = lo + warp; s < hi; s += kTileWarps) {
      double v = 0.0;
      for (int b = lane; b < (int)nb; b += 32)
        v += __ldcg(slots + (int64_t)b * K + s);
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) s_tot[s] = v;
    }
    if (warp == kTileWarps - 1 && lane < ncarry)
      s_tot[K + lane] = __ldcg(carry + lane);
    __syncthreads();
    if ((int)threadIdx.x < nw) {
      const float v = word((int)threadIdx.x, s_tot);
      s_val[threadIdx.x] = v;
      st_release(sync.words + threadIdx.x, tagged(v, tag));
    } else if ((int)threadIdx.x == nw) {
      finish(s_tot);
    }
  } else if ((int)threadIdx.x < nw) {
    s_val[threadIdx.x] = wait_word(sync.words + threadIdx.x, tag);
    fence_acq_rel();
  }
  during(nw);
  __syncthreads();
}

struct TileResidentArgs {
  const float* phi_in;  // (N, image): the start, never written
  float* out;           // (N, image): the result
  const float* u0;      // (N, image) scalar frames or (C, image) channels
  const double* usum;   // sum of u0 per frame (scalar) or channel (mc)
  const float* wts;     // mc: [l1/C x C, l2/C x C]; frozen: (c1, c2)
  double* scratch;      // (nblocks, C + 4) slots | C + 4 totals a group
  Word* rims;           // (2, nblocks, rim_len) tagged borders, zeroed
  unsigned* sync;       // a SyncBuf a group, kSyncStride apart, zeroed
  float* parts;         // partials rows of nrow floats
  int N, H, W, iters, unroll, batch, nrow;
  int TH, TW, GX, GY, u0res;  // a frame group's GY x GX tiles
};

template <bool PACKED, int NC, bool FROZEN = false, bool GROUPS = false>
__global__ void __launch_bounds__(kTileThreads, 1)
tile_resident_kernel(TileResidentArgs a, Params P) {
  static_assert(!FROZEN || NC == 0, "the frozen mode takes a scalar image");
  static_assert(!GROUPS || (NC == 0 && !FROZEN),
                "frame groups take a stack of scalar frames");
  // slots: H sums [0, kM), then the row's s_dphi2, flips, s_absdphi
  constexpr int kUh = uh_slots<NC>(), kM = kUh + 1, kS = kM + 3;
  extern __shared__ float smem[];
  __shared__ double s_red[kTileWarps][kS];
  __shared__ double s_tot[kS + kM];
  __shared__ float s_cc[cc_len<NC>()];
  __shared__ int s_last;

  // this block's frame group and its index there (nb blocks a group;
  // without GROUPS the grid, and -1 and 0 pick the helpers' defaults)
  const int H = a.H, W = a.W, nb = GROUPS ? a.GX * a.GY : gridDim.x;
  const int ngroups = GROUPS ? gridDim.x / nb : 1;
  const int grp = GROUPS ? blockIdx.x / nb : 0;
  const int lb = GROUPS ? blockIdx.x - grp * nb : -1, nblk = GROUPS ? nb : 0;
  const Tile t = GROUPS ? Tile(H, W, a.TH, a.TW, a.GX, lb)
                        : Tile(H, W, a.TH, a.TW, a.GX);
  const SyncBuf sync(a.sync + grp * kSyncStride);
  const int hw = t.tw >> 1, npairs = t.th * hw, cells = t.th * t.tw;
  const Pairs pr(hw);
  const int64_t chan = (int64_t)H * W;
  const double n_pix = (double)chan;
  const int len = rim_len(a.TH, a.TW);
  float* S = smem;
  float* N = S + (a.TH + 2) * (a.TW + 2);
  float* U = N + a.TH * a.TW / 2;
  double* slots = a.scratch + (int64_t)grp * nb * kS;
  double* g_tot = a.scratch + ((int64_t)nb * ngroups + grp) * kS;
  unsigned step = 0, tag = 0;
  // the group's rims of parity q, this block's
  auto rims = [&](int64_t q) {
    if constexpr (GROUPS) return a.rims + (q * gridDim.x + grp * nb) * len;
    else return a.rims + q * nb * len;
  };
  auto mine = [&](int64_t q) {
    if constexpr (GROUPS) return rims(q) + lb * len;
    else return rims(q) + blockIdx.x * len;
  };

  if constexpr (NC > 0) {
    for (int k = threadIdx.x; k < 2 * NC; k += blockDim.x)
      s_cc[2 * NC + k] = a.wts[k];
  } else if constexpr (FROZEN) {
    if (threadIdx.x < 2) s_cc[threadIdx.x] = a.wts[threadIdx.x];
  }

  for (int fr = grp; fr < a.N; fr += ngroups) {
    const int64_t off = a.batch ? fr * chan : 0;
    const float* u0 = a.u0 + off;
    // the data term at cell (i, j) from u0's tile copy or from L2 (frozen:
    // the tile copy holds the data term itself, the means being fixed)
    auto force = [&](int i, int j) -> float {
      if constexpr (FROZEN) {
        if (a.u0res) return U[t.u(i, j)];
        return data_term<NC>(u0, gaddr<PACKED>(i, j, H, W), chan, s_cc, P);
      } else {
        return a.u0res ? data_term<NC>(U, t.u(i, j), cells, s_cc, P)
                       : data_term<NC>(u0, gaddr<PACKED>(i, j, H, W), chan,
                                       s_cc, P);
      }
    };
    auto hsums = [&](double* acc, int i, int j, float v) {
      const float h = 0.5f + P.inv_pi * atanf(v / P.eps);
      if (!FROZEN && a.u0res) {
        const int l = t.u(i, j);
#pragma unroll
        for (int ch = 0; ch < kUh; ++ch)
          acc[ch] += (double)(U[ch * cells + l] * h);
      } else {
        const int64_t g = gaddr<PACKED>(i, j, H, W);
#pragma unroll
        for (int ch = 0; ch < kUh; ++ch)
          acc[ch] += (double)(u0[ch * chan + g] * h);
      }
      acc[kUh] += (double)h;
    };
    // the last block's part of a step: the means (the words, where
    // f_more), the row of iteration f_it where f_row (its [s_uH, s_H] the
    // totals of the step before, carried in s_tot[kS, kS + kM)) and the
    // totals the next row carries
    bool f_row = false, f_more = true;
    int f_it = 0;
    auto means = [&](int w, const double* tot) -> float {
      if (!f_more) return 0.0f;
      const int ch = w < kUh ? w : w - kUh;
      if (w < kUh) return (float)(tot[ch] / fmax(tot[kUh], 1e-30));
      const double su = a.usum[NC == 0 ? fr : ch];
      return (float)((su - tot[ch]) / fmax(n_pix - tot[kUh], 1e-30));
    };
    auto finish = [&](const double* tot) {
      if (f_row) {
        float* dst =
            a.parts + (int64_t)(a.batch ? fr : f_it / a.unroll) * a.nrow;
        for (int s = 0; s < kM; ++s) dst[s] = (float)tot[kS + s];
        for (int s = kM; s < kS; ++s) dst[s] = (float)tot[s];
        for (int s = kS; s < a.nrow; ++s) dst[s] = 0.0f;
      }
      if (f_more)
        for (int s = 0; s < kM; ++s) g_tot[s] = tot[s];
    };
    // while waiting for the means: the next iteration's whole ring, from
    // the rims of parity q (tagged `tag`)
    int64_t ring_q = 1;
    auto ring = [&](int first) {
      if (f_more)
        fill_ring(S, rims(ring_q), t, a.TH, a.TW, a.GX, a.GY, false, tag,
                  first);
    };

    // the frame: the tile (its border into the parity-1 rims under a new
    // tag, iteration 0's ring), u0 where resident, the input's H sums
    double acc[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) acc[s] = 0.0;
    ++tag;
    if constexpr (FROZEN) {
      // the loads first, several in flight a thread (a rim store's
      // memory clobber between them would make each wait for the last),
      // then the border, then iteration 0's ring: no means to wait for
      __syncthreads();  // s_cc
#pragma unroll 4
      for (int k = threadIdx.x; k < cells; k += blockDim.x) {
        const int i = t.r0 + k / t.tw, j = t.c0 + k % t.tw;
        const int64_t g = gaddr<PACKED>(i, j, H, W);
        S[t(i, j)] = a.phi_in[off + g];
        if (a.u0res) U[t.u(i, j)] = data_term<NC>(u0, g, chan, s_cc, P);
      }
      __syncthreads();
      for (int k = threadIdx.x; k < 2 * (t.tw + t.th); k += blockDim.x) {
        const bool row = k < 2 * t.tw;  // top, bottom; then left, right
        const int n = row ? t.tw : t.th, side = (row ? k : k - 2 * t.tw) / n;
        const int e = (row ? k : k - 2 * t.tw) - side * n;
        const int lr = row ? side * (t.th - 1) : e;
        const int lc = row ? e : side * (t.tw - 1);
        st_relaxed(mine(1) + (row ? side * a.TW + e
                                  : 2 * a.TW + side * a.TH + e),
                   tagged(S[t(t.r0 + lr, t.c0 + lc)], tag));
      }
      fill_ring(S, rims(1), t, a.TH, a.TW, a.GX, a.GY, false, tag);
      __syncthreads();
    } else {
      for (int k = threadIdx.x; k < cells; k += blockDim.x) {
        const int i = t.r0 + k / t.tw, j = t.c0 + k % t.tw;
        const int64_t g = gaddr<PACKED>(i, j, H, W);
        const float v = a.phi_in[off + g];
        S[t(i, j)] = v;
        publish(mine(1), t, a.TH, a.TW, i, j, v, tag);
        if (a.u0res) {
#pragma unroll
          for (int ch = 0; ch < kUh; ++ch)
            U[ch * cells + t.u(i, j)] = u0[ch * chan + g];
        }
        hsums(acc, i, j, v);
      }
      f_row = false, f_more = true, ring_q = 1;
      post_sums(acc, 0, kM, slots, s_red, lb);
      grid_step<kS>(slots, 0, kM, sync, step++, s_tot, g_tot, 0, s_cc,
                    2 * kUh, &s_last, means, finish, ring, nblk);
    }

    for (int it = 0; it < a.iters; ++it) {
      const bool row = a.batch ? it == a.iters - 1
                               : it % a.unroll == a.unroll - 1;
      const bool more = it + 1 < a.iters;
      const int64_t par = it & 1;
#pragma unroll
      for (int s = 0; s < kS; ++s) acc[s] = 0.0;

      for (int color = 0; color < 2; ++color) {  // 0 = red: (i + j) even
        for (int k = threadIdx.x, lr = pr.lr0, q = pr.q0; k < npairs;
             k += blockDim.x, pr.next(lr, q)) {
          const int i = t.r0 + lr, j = t.c0 + 2 * q + ((i + color) & 1);
          const float fv = force(i, j);
          N[k] = update_cell_at(S, [fv] { return fv; }, i, j, H, W, t, P);
        }
        __syncthreads();
        for (int k = threadIdx.x, lr = pr.lr0, q = pr.q0; k < npairs;
             k += blockDim.x, pr.next(lr, q)) {
          const int i = t.r0 + lr, j = t.c0 + 2 * q + ((i + color) & 1);
          float* s = S + t(i, j);
          const float old = *s, nv = N[k];
          *s = nv;
          if (row) {
            const float d = nv - old;
            acc[kM] += (double)(d * d);
            acc[kM + 1] += ((nv >= 0.0f) != (old >= 0.0f)) ? 1.0 : 0.0;
            acc[kM + 2] += (double)fabsf(d);
          }
          if constexpr (FROZEN) {  // the H sums of the phi k iterations leave
            if (!more) hsums(acc, i, j, nv);
          } else {
            if (more) hsums(acc, i, j, nv);
          }
          publish(mine(par), t, a.TH, a.TW, i, j, nv, tag + 1);
        }
        if (color == 0) {  // the sides' new red cells for the black sweep
          fill_ring(S, rims(par), t, a.TH, a.TW, a.GX, a.GY, true, tag + 1);
          __syncthreads();
        }
      }
      ++tag;
      if constexpr (FROZEN) {
        if (more) {  // the next iteration's ring, once its owners commit
          fill_ring(S, rims(par), t, a.TH, a.TW, a.GX, a.GY, false, tag);
          __syncthreads();
        } else {  // the one grid-wide step: the row of the last iteration
          post_sums(acc, 0, kS, slots, s_red, lb);
          grid_step<kS>(
              slots, 0, kS, sync, step++, s_tot, g_tot, 0, s_cc, 0, &s_last,
              means,
              [&](const double* tot) {
                for (int s = 0; s < kS; ++s) a.parts[s] = (float)tot[s];
                for (int s = kS; s < a.nrow; ++s) a.parts[s] = 0.0f;
              },
              [](int) {}, nblk);
        }
      } else if (row || more) {
        f_row = row, f_more = more, f_it = it, ring_q = par;
        post_sums(acc, more ? 0 : kM, row ? kS : kM, slots, s_red, lb);
        grid_step<kS>(slots, more ? 0 : kM, row ? kS : kM, sync, step++,
                      s_tot, g_tot, row ? kM : 0, s_cc, 2 * kUh, &s_last,
                      means, finish, ring, nblk);
      }
    }

    __syncthreads();
    for (int k = threadIdx.x; k < cells; k += blockDim.x) {
      const int i = t.r0 + k / t.tw, j = t.c0 + k % t.tw;
      a.out[off + gaddr<PACKED>(i, j, H, W)] = S[t(i, j)];
    }
    __syncthreads();
  }
}

// Host side. Whether TH x TW tiles in a GX-wide grid of nblocks cover an
// H x W image, every tile non-empty and TW even.
inline bool tile_grid_ok(int H, int W, int TH, int TW, int GX, int nblocks) {
  if (TH < 1 || TW < 2 || (TW & 1) || GX < 1 || nblocks % GX) return false;
  const int GY = nblocks / GX;
  return (GY - 1) * TH < H && H <= GY * TH && (GX - 1) * TW < W &&
         W <= GX * TW;
}

// The most blocks of `kernel` (smem dynamic bytes each) that can be
// co-resident on the current device: occupancy per SM x SM count.
template <class K>
cudaError_t tile_capacity(K kernel, int smem, int* max_blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute((const void*)kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kTileThreads, smem);
  if (err != cudaSuccess) return err;
  *max_blocks = per_sm * sms;
  return cudaSuccess;
}

// One cooperative launch of nblocks blocks with smem dynamic bytes. A grid
// that cannot be co-resident is refused
// (cudaErrorCooperativeLaunchTooLarge), never shrunk; the wrapper raises.
template <class K, class A>
cudaError_t tile_launch(K kernel, A a, Params P, int nblocks, int smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&a, (void*)&P};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(nblocks),
                                     dim3(kTileThreads), args, smem, stream);
}

// The two-phase body (FROZEN: its frozen-means chunk mode) on `groups`
// frame groups of nblocks / groups blocks (more than one: a stack alone)
// after checking each group's tiling and that smem is its size for it;
// with `capacity`, the co-resident blocks at smem bytes instead.
template <bool PACKED, int NC, bool FROZEN = false>
cudaError_t tile_resident(TileResidentArgs a, Params P, int nblocks,
                          int smem, cudaStream_t stream, int* capacity,
                          int groups = 1) {
  if (capacity)
    return tile_capacity(tile_resident_kernel<PACKED, NC, FROZEN>, smem,
                         capacity);
  if (groups < 1 || nblocks % groups || (groups > 1 && !a.batch) ||
      !tile_grid_ok(a.H, a.W, a.TH, a.TW, a.GX, nblocks / groups) ||
      a.GX * a.GY != nblocks / groups ||
      smem != tile_smem_bytes(a.TH, a.TW, uh_slots<NC>(), 1, a.u0res))
    return cudaErrorInvalidValue;
  if (groups > 1) {
    if constexpr (NC == 0 && !FROZEN)
      return tile_launch(tile_resident_kernel<PACKED, 0, false, true>, a, P,
                         nblocks, smem, stream);
    return cudaErrorInvalidValue;
  }
  return tile_launch(tile_resident_kernel<PACKED, NC, FROZEN>, a, P, nblocks,
                     smem, stream);
}

// C-channel image: the runtime channel count C picks the instance.
template <bool PACKED, int NC = 1>
cudaError_t tile_resident_mc(int C, TileResidentArgs a, Params P,
                             int nblocks, int smem, cudaStream_t stream,
                             int* capacity, int groups = 1) {
  if (C == NC)
    return tile_resident<PACKED, NC>(a, P, nblocks, smem, stream, capacity,
                                     groups);
  if constexpr (NC < kMaxChannels)
    return tile_resident_mc<PACKED, NC + 1>(C, a, P, nblocks, smem, stream,
                                            capacity, groups);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cv

// The plain C interface of the two-phase launchers on the tile body:
// pointers; grid size, frames, geometry, channels, iterations, the rows;
// the tiling (TH, TW, GX, u0 resident, dynamic bytes, frame groups); the
// nine parameters of redblack.cuh's Params; the stream. Each has a `_grid`
// twin (C, dynamic bytes, int* co-resident blocks).
#define CV_TILE_RESIDENT_ARGS                                             \
  const float *phi_in, float *out, const float *u0, const double *usum,  \
      const float *wts, double *scratch, void *rims, unsigned *sync,     \
      float *parts, int nblocks, int N, int H, int W, int C, int iters,  \
      int unroll, int batch, int nrow, int TH, int TW, int GX, int u0res, \
      int smem, int groups, float mu, float nu, float l1, float l2,      \
      float eta2, float gdt, float eps, float eps2, float inv_pi,        \
      void *stream
// tile_resident(_mc)'s arguments (after C) from CV_TILE_RESIDENT_ARGS
#define CV_TILE_RESIDENT_CALL                                               \
  cv::TileResidentArgs{phi_in, out, u0, usum, wts, scratch,                \
                       (cv::Word*)rims, sync,                              \
                       parts, N, H, W, iters, unroll, batch, nrow, TH, TW, \
                       GX, GX > 0 && groups > 0 ? nblocks / groups / GX : 0, \
                       u0res},                                             \
      cv::Params{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi}, nblocks,   \
      smem, (cudaStream_t)stream, nullptr, groups
