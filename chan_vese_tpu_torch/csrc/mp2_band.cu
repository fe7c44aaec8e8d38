// K9, banded mode: one coupled 4-phase iteration (two level sets) plus
// the 16 partials the next iteration's means need.
//
// Replaces chan_vese_tpu/ops/pallas_multiphase.py::_mp2_band_kernel
// (whole-image mode, reached through mp2_iteration, and shard-canvas mode,
// reached through mp2_iteration_sharded) with the coupled band body
// (mp2_coupled_kernel, the launchers cv_mp2_iteration(_shard)) on mp2.cuh's
// forces, in band.cuh's style.
//
// Shard canvases (SHARD = true, cv_mp2_iteration_shard). The image is one
// shard's halo-padded canvas of the sharded multiphase solver
// (parallel/sharded.py), and a launch computes the reference's sharded
// branch of _mp2_band_kernel with _coupled_iteration's `resync`:
// - parity: canvas cell (i, j) is red iff (i + j + parity) is even;
// - the whole canvas is swept and stored, with reads clamped at the canvas
//   edge, as the reference's bands do: the comm_k route launches K9 k
//   times on one canvas, so the halo cells must advance between launches
//   (a kernel that copied them through would read the chunk's first halo
//   from the second launch on);
// - crop [r0, r1) x [c0, c1): the shard's own cells. Only they count in
//   the partials, and the rim refresh is placed around them: after each
//   of the four half-sweeps (phi0 red, phi0 black, phi1 red, phi1 black)
//   the depth-2 replica rim on the flagged global-edge sides takes the
//   edge cells (the reference's _resync_rim, rows first), so phi1's force
//   reads the refreshed new phi0;
// - tiles: each axis is cut at the crop's bounds, and tiles are counted
//   back from r0 (c0) and forward from r0 and from r1 (c1), so a window
//   that holds a replica row or column also holds its source (the window
//   of any tile not next to the crop holds no rim cell). Window columns
//   are made an even count so that each thread's cell pair holds one cell
//   of either color at any parity.
// The whole-image instantiations keep their code: every shard branch is an
// `if constexpr`, and the shard arguments come last.
//
// Design. A coupled iteration moves 20 B/pixel (phi0, phi1, u0 read,
// phi0, phi1 written) and costs two cell updates, the forces' and the
// partials' atan a cell; a body with one block an SM, a half buffer and
// shared-memory 3x3 reads an update is bound by its barriers and loads,
// not by either. So:
// - The coupled iteration's true halo, 2 cells each way. Wrong values from
//   a clamped window edge move one cell a half-sweep: phi0's red
//   half-sweep leaves them at depth 1, its black one at depth <= 2, where
//   the new phi0's red cells are right from depth 2 on. f1 is pointwise in
//   the new phi0 and phi1's red half-sweep reads f1 only at its own (red)
//   cell, so it is wrong at depth 1 only, and its black one at depth <= 2.
//   A tile that ends at the crop's first row (column) or starts at its end
//   reaches one cell more into it, so that a replica's source sits at
//   depth 3, outside the wrong zone, and the refresh copies a right value.
//   tests/test_torch_mp2_band_tiling.py holds a plain windowed twin of
//   this tiling bitwise equal to the whole plain iteration, and shows that
//   a halo of 1, or no extra cell into the crop, differs.
// - On a shard canvas the thin outer tiles (the 4-cell halo of comm_k = 1)
//   may be folded into their inner neighbour (`fold`, chosen on the host),
//   so no block pays its fixed cost for a 4-row strip.
// - band.cuh's strips: thread t owns column pair q over kMp2Rows rows,
//   keeps three rows of the swept level set in registers and holds its
//   results in registers through a barrier: no half buffer, no division
//   in the sweep loops, the rim refresh only in blocks whose window needs
//   it. Strips of 6 rows, not band.cuh's 12: the windows hold half as
//   many cells at 16 B each, so shorter strips keep ~30 warps an SM, and
//   the live results and the partials' terms fit 64 registers without
//   spilling (12-row strips spilled, and ran slower on an H100). The
//   strips, their write-back, the rim refresh and the block reduction are
//   band.cuh's templates; the cell (CoupledCell) and the half-sweep that
//   builds it (coupled_half_sweep) are this body's.
// - 16 B of shared memory a window cell: phi0 and phi1 flat, u0 and one
//   colour-split plane `aux` ([colour][row][pair], consecutive across a
//   warp). aux holds phi0's force f0 (from the old phi1) until phi0's
//   half-sweep of that colour reads it and leaves the cell's old phi0 in
//   its place. The new phi0 is then stored, and phi1's half-sweep computes
//   f1 from u0 and H(new phi0) at the active cell (one force a cell),
//   leaves H(new phi0) in phi0's slot for the partials (no second atan of
//   phi0), and in aux the cell's dphi2 term d0^2 + d1^2 with the sign bit
//   set where its 2-bit label flipped. So the partials pass reads no phi
//   from device memory, and the tile and thread count are chosen on the
//   host (ops/_cuda.py::mp2_geometry) so that two or more blocks fit an SM.
// - One block reduction for the ten live slots (one barrier) and
//   band.cuh's one-pass band_reduce_kernel.
// What then bounds the band body is its instruction stream (two updates
// and three Heavisides a cell): 0.20 ms at 4K on an H100 80GB HBM3 at
// 700 W, 4x the time of its 20 B a pixel at the DRAM rate.
// Every cell goes through redblack.cuh's update_cell_at and mp2.cuh's
// force0, heav and label2, and through force1's and add_phase_sums'
// expressions; the partials are summed in f64 by block, in a fixed order.

#include "band.cuh"
#include "mp2.cuh"

namespace cv {
namespace {

constexpr int kMp2Sums = 10;  // live partial slots

constexpr int kMp2Halo = 2;  // the coupled iteration's reach

// The tiles along one axis of n cells cut at lo and hi (a shard canvas's
// crop; 0 and n on a whole image): tiles of T cells counted back from lo,
// forward from lo to hi and forward from hi to n. With `fold`, the
// outermost tile of [0, lo) and of [hi, n), where it is partial, joins its
// inner neighbour. The first tile starts at 0 and the last ends at n.
// ops/_cuda.py::mp2_axis_tiles mirrors it.
struct Mp2Axis {
  int n, lo, hi, T, fold;

  __host__ __device__ int outer(int len) const {
    const int t = (len + T - 1) / T;
    return (fold && len % T) ? t - 1 : t;
  }
  __host__ __device__ int count() const {
    return outer(lo) + (hi - lo + T - 1) / T + outer(n - hi);
  }
  // Tile b's cells [t0, t1) and its window [w0, w1): the tile plus
  // kMp2Halo each way, cut at the axis, and one cell more into the crop
  // where the tile ends at lo or starts at hi (a replica's source then
  // lies 3 deep in the window).
  __device__ void tile(int b, int& t0, int& t1, int& w0, int& w1) const {
    const int na = outer(lo), nb = (hi - lo + T - 1) / T;
    if (b < na) {
      t1 = lo - (na - 1 - b) * T;
      t0 = t1 - T;
    } else if (b < na + nb) {
      t0 = lo + (b - na) * T;
      t1 = min(t0 + T, hi);
    } else {
      t0 = hi + (b - na - nb) * T;
      t1 = t0 + T;
    }
    if (b == 0) t0 = 0;
    if (b == count() - 1) t1 = n;
    w0 = max(t0 - kMp2Halo - (t0 == hi ? 1 : 0), 0);
    w1 = min(t1 + kMp2Halo + (t1 == lo ? 1 : 0), n);
  }
};

constexpr int kMp2Rows = 6;  // rows of a thread's strip (even)

// phi1's force at a cell from u0 and H(new phi0): mp2.cuh's force1 with
// the Heaviside given (the same expression, so the same value).
__device__ __forceinline__ float force1_h(float u, float h0, const float* c,
                                         const Params& P) {
  const float d0 = sqd(u, c[0]), d1 = sqd(u, c[1]);
  const float d2 = sqd(u, c[2]), d3 = sqd(u, c[3]);
  return -P.nu + (1.0f - h0) * (d0 - d2) + h0 * (d1 - d3);
}

// K9's cell functor for band.cuh's band_rows: the active cell's new value
// from its 3 x 3 neighbourhood g9 in row r (odd: the cell is 2q + 1). uc
// and ac are the active colour's planes of u0 and aux.
// - phi0 (PHI1 false, the half-sweep's cur = p0): the force f0 from ac,
//   whose slot then takes the cell's old phi0.
// - phi1 (PHI1 true, cur = p1): the force f1 from u0 and H(new phi0) at
//   the cell; the cell's slot of p0 then takes H(new phi0) (the partials
//   pass needs no more of it), and its slot of ac, which holds its old
//   phi0, its partials terms: d0^2 + d1^2, negative where the 2-bit label
//   flipped.
template <bool PHI1>
struct CoupledCell {
  float* p0;
  const float* uc;
  float* ac;
  int hw, ww, q;
  const float* c;
  const Params& P;
  __device__ __forceinline__ float operator()(int r, bool odd,
                                              const float (&g9)[9]) const {
    const int slot = r * hw + q;
    if constexpr (PHI1) {
      float* c0 = p0 + r * ww + 2 * q + (odd ? 1 : 0);
      const float n0 = *c0, h0 = heav(n0, P);
      const float fv = force1_h(uc[slot], h0, c, P);
      const float n1 =
          update_cell_at(g9, [&] { return fv; }, 1, 1, 3, 3, Grid3{}, P);
      *c0 = h0;
      const float o0 = ac[slot], o1 = g9[4];
      const float d0 = n0 - o0, d1 = n1 - o1;
      const bool flip = label2(n0, n1) != label2(o0, o1);
      ac[slot] = copysignf(d0 * d0 + d1 * d1, flip ? -1.0f : 1.0f);
      return n1;
    } else {
      const float fv = ac[slot];
      const float n0 =
          update_cell_at(g9, [&] { return fv; }, 1, 1, 3, 3, Grid3{}, P);
      ac[slot] = g9[4];
      return n0;
    }
  }
};

// One half-sweep of colour `color` of level set `cur` (PHI1 false: phi0,
// cur = p0; true: phi1, cur = p1) on band.cuh's band_rows, band_store and
// band_rim. It is band_half_sweep with the cell built in each branch of
// the strip's colour offset: handed to band_half_sweep built, or built
// once before that branch, the cell's plane pointers stay live across it
// and the kernel spills and runs slower, while building it inside
// band_half_sweep changes band_kernel's code.
template <bool SHARD, bool PHI1>
__device__ __forceinline__ void coupled_half_sweep(
    float* cur, float* p0, const float* upl, float* aux, const BandWin& B,
    const Shard& S, int color, bool busy, bool rim, int r0s, int q,
    const float* c, const Params& P) {
  float nv[kMp2Rows];
  const int plane = color * (B.wh * B.hw);
  // r0s is even, so the strip's first row has the block's colour offset
  const bool odd0 = ((B.wr0 + color + B.par) & 1) != 0;
  if (busy) {
    const auto cell = [&] {
      return CoupledCell<PHI1>{p0, upl + plane, aux + plane, B.hw, B.ww, q, c,
                               P};
    };
    if (odd0)
      band_rows<1>(cur, B, r0s, q, cell(), nv, B.wh);
    else
      band_rows<0>(cur, B, r0s, q, cell(), nv, B.wh);
  }
  __syncthreads();
  if (busy) {
    if (odd0)
      band_store<1>(cur, B, r0s, q, nv, B.wh);
    else
      band_store<0>(cur, B, r0s, q, nv, B.wh);
  }
  __syncthreads();
  if constexpr (SHARD) {
    if (rim) band_rim(cur, B, S);
  }
}

// Stores the tile's cells of a thread's strip of level set `src` (a
// window plane) into `dst` (an image plane).
__device__ __forceinline__ void coupled_out(const float* src, float* dst,
                                            const BandWin& B, int W,
                                            int r0s, int q) {
  for (int j = 0; j < kMp2Rows; ++j) {
    const int r = r0s + j, gi = B.wr0 + r;
    if (r >= B.wh) break;
    if (gi < B.tr0 || gi >= B.tr1) continue;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int gj = B.wc0 + 2 * q + o;
      if (gj >= B.tc0 && gj < B.tc1)
        dst[(int64_t)gi * W + gj] = src[r * B.ww + 2 * q + o];
    }
  }
}

// Dynamic shared memory: p0[cap] | p1[cap] | u0 planes [2][cap / 2] | aux
// planes [2][cap / 2] = 16 cap bytes, cap >= wh * ww of every block's
// window (even). PX * PY <= kBandThreads with PX >= ww / 2 and PY
// kMp2Rows >= wh; blockDim.x is PX * PY rounded up to whole warps. phis
// and out are (2, H, W), cs the four means. S is the whole image (crop
// [0, H) x [0, W), no flags) unless SHARD.
template <bool SHARD>
__global__ void __launch_bounds__(kBandThreads, 2)
mp2_coupled_kernel(const float* __restrict__ phis,
                   const float* __restrict__ u0, const float* __restrict__ cs,
                   float* __restrict__ out, double* __restrict__ block_parts,
                   int H, int W, int TH, int TW, int fold, int PX, int cap,
                   Params P, Shard S) {
  extern __shared__ __align__(16) float mp2_smem[];
  __shared__ double red_scratch[kMp2Sums][kBandThreads / 32];
  __shared__ float s_c[4];
  float* p0 = mp2_smem;
  float* p1 = mp2_smem + cap;
  float* upl = mp2_smem + 2 * cap;
  float* aux = mp2_smem + 3 * cap;

  BandWin B;
  B.par = SHARD ? S.parity : 0;
  int wr1, wc1;
  Mp2Axis{H, S.r0, S.r1, TH, fold}.tile(blockIdx.y, B.tr0, B.tr1, B.wr0,
                                        wr1);
  Mp2Axis{W, S.c0, S.c1, TW, fold}.tile(blockIdx.x, B.tc0, B.tc1, B.wc0,
                                        wc1);
  B.wc0 &= ~1;  // an even start and width (W is even)
  wc1 += (wc1 - B.wc0) & 1;
  B.wh = wr1 - B.wr0;
  B.ww = wc1 - B.wc0;
  B.hw = B.ww >> 1;
  const int cplane = B.wh * B.hw;
  const int64_t plane = (int64_t)H * W;

  // this thread's pair and strip
  const int q = threadIdx.x % PX;
  const int r0s = (threadIdx.x / PX) * kMp2Rows;
  const bool busy = q < B.hw && r0s < B.wh;

  if (threadIdx.x < 4) s_c[threadIdx.x] = cs[threadIdx.x];
  __syncthreads();
  if (busy) {
    for (int j = 0; j < kMp2Rows; ++j) {
      const int r = r0s + j;
      if (r >= B.wh) break;
      const int64_t g = (int64_t)(B.wr0 + r) * W + B.wc0 + 2 * q;
      const float2 a = *reinterpret_cast<const float2*>(phis + g);
      const float2 b = *reinterpret_cast<const float2*>(phis + plane + g);
      const float2 uv = *reinterpret_cast<const float2*>(u0 + g);
      *reinterpret_cast<float2*>(p0 + r * B.ww + 2 * q) = a;
      *reinterpret_cast<float2*>(p1 + r * B.ww + 2 * q) = b;
      // the red cell of the pair in row r is 2q + ((wr0 + r + par) & 1)
      const int red1 = (B.wr0 + r + B.par) & 1;
      const int s0 = red1 * cplane + r * B.hw + q;  // cell 2q's slot
      const int s1 = (red1 ^ 1) * cplane + r * B.hw + q;
      upl[s0] = uv.x;
      upl[s1] = uv.y;
      aux[s0] = force0(uv.x, b.x, s_c, P);
      aux[s1] = force0(uv.y, b.y, s_c, P);
    }
  }
  __syncthreads();

  const bool rim = SHARD && band_needs_rim(B, S);
  // phi0 on f0, then its tile stored; phi1 on f1
#pragma unroll
  for (int color = 0; color < 2; ++color)
    coupled_half_sweep<SHARD, false>(p0, p0, upl, aux, B, S, color, busy, rim,
                                     r0s, q, s_c, P);
  if (busy) coupled_out(p0, out, B, W, r0s, q);
#pragma unroll
  for (int color = 0; color < 2; ++color)
    coupled_half_sweep<SHARD, true>(p1, p0, upl, aux, B, S, color, busy, rim,
                                    r0s, q, s_c, P);
  if (busy) coupled_out(p1, out + plane, B, W, r0s, q);

  // the partials of the tile's cells in the crop, from H(new phi0) in p0's
  // slot, the new phi1 and aux's terms (mp2.cuh's add_phase_sums with the
  // Heaviside of phi0 given)
  double acc[kMp2Sums];
#pragma unroll
  for (int t = 0; t < kMp2Sums; ++t) acc[t] = 0.0;
  if (busy) {
    for (int j = 0; j < kMp2Rows; ++j) {
      const int r = r0s + j, gi = B.wr0 + r;
      if (r >= B.wh) break;
      if (gi < B.tr0 || gi >= B.tr1) continue;
      if constexpr (SHARD) {
        if (gi < S.r0 || gi >= S.r1) continue;
      }
      const int red1 = (B.wr0 + r + B.par) & 1;
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const int gj = B.wc0 + 2 * q + o;
        if (gj < B.tc0 || gj >= B.tc1) continue;
        if constexpr (SHARD) {
          if (gj < S.c0 || gj >= S.c1) continue;
        }
        const int w = r * B.ww + 2 * q + o;
        const int sl = (red1 ^ o) * cplane + r * B.hw + q;
        const float h0 = p0[w], h1 = heav(p1[w], P), u = upl[sl];
        const float wt[4] = {(1.0f - h0) * (1.0f - h1), h0 * (1.0f - h1),
                             (1.0f - h0) * h1, h0 * h1};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[t] += (double)(u * wt[t]);
          acc[4 + t] += (double)wt[t];
        }
        const float e = aux[sl];
        acc[8] += (__float_as_uint(e) >> 31) ? 1.0 : 0.0;  // the sign bit
        acc[9] += (double)fabsf(e);
      }
    }
  }

  band_block_sums(acc, red_scratch, block_parts);
}

// mp2_coupled_kernel<SHARD>'s shared-memory limit raised to the device's
// opt-in maximum (band.cuh), once per device and process.
template <bool SHARD>
cudaError_t coupled_attributes() {
  static bool done[kMaxDevices] = {};
  return raise_smem_limit(mp2_coupled_kernel<SHARD>, done);
}

// Host side: one coupled iteration plus the partials reduction into
// parts[16] on `stream`. The caller (ops/_cuda.py::launch_mp2) chooses TH,
// TW, fold, PX, PY and cap (mp2_geometry) and sizes block_parts for
// nblocks blocks (mp2_axis_tiles' counts), which must be the grid's
// (Mp2Axis's counts).
template <bool SHARD>
cudaError_t launch_coupled(const float* phis, const float* u0,
                           const float* cs, float* out, double* block_parts,
                           float* parts, int H, int W, int TH, int TW,
                           int fold, int PX, int PY, int cap, int nblocks,
                           Params P, cudaStream_t stream, Shard S) {
  if (TH < 1 || TW < 1 || PX < 1 || PY < 1 || PX * PY > kBandThreads)
    return cudaErrorInvalidValue;
  const dim3 grid(Mp2Axis{W, S.c0, S.c1, TW, fold}.count(),
                  Mp2Axis{H, S.r0, S.r1, TH, fold}.count());
  if ((int64_t)grid.x * grid.y != nblocks) return cudaErrorInvalidValue;
  cudaError_t err = coupled_attributes<SHARD>();
  if (err != cudaSuccess) return err;
  // whole warps (the reduction's shuffles); the extra threads idle
  const int threads = (PX * PY + 31) & ~31;
  mp2_coupled_kernel<SHARD><<<grid, threads, (size_t)cap * 16, stream>>>(
      phis, u0, cs, out, block_parts, H, W, TH, TW, fold, PX, cap, P, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  band_reduce_kernel<kMp2Sums><<<1, 256, 0, stream>>>(
      block_parts, (int)(grid.x * grid.y), 16, parts);
  return cudaGetLastError();
}

template <bool SHARD>
cudaError_t coupled_occupancy(int threads, int smem, int* blocks) {
  cudaError_t err = coupled_attributes<SHARD>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mp2_coupled_kernel<SHARD>, (threads + 31) & ~31, (size_t)smem);
}

}  // namespace
}  // namespace cv

// K9 on the band body (the launchers the wrappers call): TH x TW tiles
// (folded at a shard canvas's rim where `fold`), PX x PY threads, windows
// of at most cap cells (ops/_cuda.py::mp2_geometry), nblocks blocks
// (block_parts' rows; cudaErrorInvalidValue where the grid differs).
extern "C" cudaError_t cv_mp2_iteration(
    const float* phis, const float* u0, const float* cs, float* out,
    double* block_parts, float* parts, int H, int W, int TH, int TW,
    int fold, int PX, int PY, int cap, int nblocks, float mu, float nu,
    float l1, float l2, float eta2, float gdt, float eps, float eps2,
    float inv_pi, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  const cv::Shard S{0, 0, H, 0, W, 0, 0, 0, 0};
  return cv::launch_coupled<false>(phis, u0, cs, out, block_parts, parts, H,
                                   W, TH, TW, fold, PX, PY, cap, nblocks,
                                   P, (cudaStream_t)stream, S);
}

// K9's shard-canvas mode on the band body: one coupled iteration on a
// shard canvas (2, H, W) with the lattice offset by `parity`, the partials
// on the crop [r0, r1) x [c0, c1) and the depth-2 rim refreshed after
// every half-sweep on the flagged global edges (this file's header).
extern "C" cudaError_t cv_mp2_iteration_shard(
    const float* phis, const float* u0, const float* cs, float* out,
    double* block_parts, float* parts, int H, int W, int TH, int TW,
    int fold, int PX, int PY, int cap, int nblocks, float mu, float nu,
    float l1, float l2, float eta2, float gdt, float eps, float eps2,
    float inv_pi, int parity, int r0, int r1, int c0, int c1, int top,
    int bottom, int left, int right, void* stream) {
  const cv::Params P{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi};
  const cv::Shard S{parity, r0, r1, c0, c1, top, bottom, left, right};
  return cv::launch_coupled<true>(phis, u0, cs, out, block_parts, parts, H,
                                  W, TH, TW, fold, PX, PY, cap, nblocks,
                                  P, (cudaStream_t)stream, S);
}

// Blocks of the band body (shard: its shard-canvas mode) that fit on an SM
// at `threads` threads and `smem` bytes of dynamic shared memory.
extern "C" cudaError_t cv_mp2_band_occupancy(int shard, int threads,
                                             int smem, int* blocks) {
  return shard ? cv::coupled_occupancy<true>(threads, smem, blocks)
               : cv::coupled_occupancy<false>(threads, smem, blocks);
}
