// Shared device code of the Hopper morphological kernels: K11 morph_band.cu
// (kinds acwe, gac, gac_pre) and K12 morph_fused.cu (acwe with the force
// computed in the kernel). One body, templated on the kind.
//
// What a launch computes: k MorphACWE or MorphGAC iterations on a binary
// level set, the contract of chan_vese_tpu/ops/pallas_morph.py
// ::_morph_banded_kernel and ::_morph_fused_kernel (whole-image modes).
// Iteration j of a launch is the force step, then `s` smoothing cycles;
// cycle c is SIoIS (inf-sup, then sup-inf) when (parity0 + j s + c) is
// even and ISoSI otherwise. parity0 and k are runtime arguments: the TPU
// kernel baked the parity in at compile time and needed (k s) % 2 == 0,
// this one takes any k >= 1 and any parity0.
//   acwe   : aux is the frozen force f; a cell whose level set has a
//            nonzero central difference takes 1 where f < 0 and 0 where
//            f > 0 (a zero or NaN force keeps it).
//   fused  : aux is the image u0 and f = l1 (u0 - c_in)^2 - l2 (u0 -
//            c_out)^2 from the four floats cc, rounded op by op (no FMA)
//            as the plain version computes it; the launch also returns
//            (sum ls, sum u0 ls) of the final state over owned cells.
//   gac    : aux is the edge map g; dgx, dgy (central differences, halved)
//            and the balloon mask g > thr_b are computed once at load.
//   gac_pre: aux is the (3, H, W) stack (dgx, dgy, mask) of gac_aux_stack.
//   GAC iteration: where the mask is set, the 3x3 dilation (balloon > 0)
//   or erosion (balloon < 0); then the attraction a = dgx dux + dgy duy
//   with dux, duy in {-1/2, 0, 1/2}: a > 0 -> 1, a < 0 -> 0.
//
// Tiling. A block owns a TH x TW output tile and loads a window clipped to
// the image and extended by `halo` = R k cells on all four sides (R = 1 +
// 2s for ACWE, 2 + 2s for GAC: every elementary op reads distance 1).
// Neighbor reads clamp at the window bounds: where a bound is the image
// edge that is exactly the replica convention, elsewhere the error front
// moves one cell per op and stays inside the discarded halo after the R k
// ops of the launch. The gac kind's dgx/dgy are wrong on the window's
// outer ring only, which the first attraction op spoils anyway.
//
// Exactness. The state is binary and lives in shared memory as bytes, two
// ping-pong buffers (each op reads one and writes the other, then the
// block syncs: a 3x3 read in place would race). On bytes, sup-inf, inf-sup,
// dilation and erosion are AND/OR of the neighborhood, exactly the float
// min/max of the plain version on {0, 1}. The ACWE update needs only the
// sign of f, kept as int8. The GAC products dgx dux are exact, and the sum
// is rounded once (__fadd_rn of __fmul_rn, so no contraction can change
// it). So a launch is bitwise equal to its plain version.
//
// Bound on the card: shared-memory reads and integer ops of the 3x3
// neighborhoods (9 byte loads per cell per op, 1 + 2s ops per ACWE
// iteration, 2 + 2s for GAC with a balloon) and the halo recompute,
// (TH + 2Rk)(TW + 2Rk) / (TH TW) = 2.4x at ACWE k = 8 and 1.9x at GAC
// k = 4 with 64 x 128 tiles. Device memory moves once per launch (8 B read
// and 4 B written per pixel, 16 + 4 for gac_pre). Byte cells keep the
// window at 3 B per cell for ACWE and 11 B for GAC (dgx, dgy in f32).
// Each warp walks whole window rows, so no cell index is divided.
//
// Shard blocks (kinds acwe_sh and gac_pre_sh: acwe and gac_pre on one
// shard's halo-padded block of the sharded morphological solver,
// parallel/sharded_morph.py; the contract of _morph_banded_kernel with
// `pads` and its `rim` callback). The block's pads are (pt, pb, pcl, pcr)
// rows and columns deep, its own cells the crop [pt, H - pb) x [pcl,
// W - pcr) (Shard's r0, r1, c0, c1), and the flags mark the sides that are
// global image edges. Before every elementary op (the force or attraction
// step, the balloon op, each inf-sup and sup-inf) the depth-1 replica ring
// on the flagged sides takes the crop's edge cells, rows first, then
// columns (so a corner takes the corner cell), wherever the window holds
// the ring cell and its source. The ring holds the current edge value at
// every read, which makes the crop exact; refreshing only between
// iterations leaves a fraction of a percent of the cells wrong. The tiles
// cover the crop, whose windows reach `halo` cells into the pads; cells
// outside the crop come back as they went in. Parity0, k and every other
// argument are the whole-image kinds'.

#pragma once

#include "redblack.cuh"  // kThreads, block_sum, reduce_parts_kernel

namespace cv {
namespace {

enum MorphKind { kMorphAcwe = 0, kMorphGac = 1, kMorphGacPre = 2,
                 kMorphFused = 3, kMorphAcweSh = 4, kMorphGacPreSh = 5 };

// the shard kinds run their whole-image kind's iteration
template <int KIND>
__host__ __device__ constexpr bool morph_is_shard() {
  return KIND == kMorphAcweSh || KIND == kMorphGacPreSh;
}
template <int KIND>
__host__ __device__ constexpr int morph_base() {
  return KIND == kMorphAcweSh ? kMorphAcwe
                              : (KIND == kMorphGacPreSh ? kMorphGacPre : KIND);
}
template <int KIND>
__host__ __device__ constexpr bool morph_is_gac() {
  return morph_base<KIND>() == kMorphGac || morph_base<KIND>() == kMorphGacPre;
}
// dynamic shared-memory bytes per window cell (ops/_cuda.py
// MORPH_CELL_BYTES): two state buffers and the force sign, or dgx, dgy,
// two state buffers and the mask
template <int KIND>
__host__ __device__ constexpr int morph_cell_bytes() {
  return morph_is_gac<KIND>() ? 11 : 3;
}

// The 3x3 neighborhood of window cell (r, c), reads clamped to the window.
struct Nb {
  uint8_t u, up, dn, lf, rt, ul, ur, dl, dr;
};

__device__ __forceinline__ Nb load_nb(const uint8_t* s, int r, int c, int wh,
                                      int ww) {
  const uint8_t* row = s + r * ww;
  const uint8_t* rn = s + max(r - 1, 0) * ww;
  const uint8_t* rs = s + min(r + 1, wh - 1) * ww;
  const int cw = max(c - 1, 0), ce = min(c + 1, ww - 1);
  return Nb{row[c], rn[c], rs[c], row[cw], row[ce],
            rn[cw], rn[ce], rs[cw], rs[ce]};
}

// max over the four line erosions / min over the four line dilations
__device__ __forceinline__ uint8_t sup_inf(const Nb& n) {
  return n.u & ((n.lf & n.rt) | (n.up & n.dn) | (n.ul & n.dr) |
                (n.ur & n.dl));
}
__device__ __forceinline__ uint8_t inf_sup(const Nb& n) {
  return n.u | ((n.lf | n.rt) & (n.up | n.dn) & (n.ul | n.dr) &
                (n.ur | n.dl));
}

__device__ __forceinline__ int8_t sign_of(float f) {
  return (int8_t)((f > 0.0f) - (f < 0.0f));  // NaN -> 0
}

// Refreshes the depth-1 replica ring of a shard block inside the window
// [wr0, wr0 + wh) x [wc0, wc0 + ww): row r0 - 1 takes row r0 (top), row r1
// takes row r1 - 1 (bottom), then column c0 - 1 takes column c0 (left) and
// column c1 takes c1 - 1 (right), each where its flag is set and the window
// holds the ring cell and its source; then the block syncs. The
// counterpart of the `rim` callback of
// chan_vese_tpu/ops/pallas_morph.py::_morph_banded_kernel.
__device__ __forceinline__ void morph_rim(uint8_t* cur, int wr0, int wh,
                                          int wc0, int ww, const Shard& S) {
  const int wr1 = wr0 + wh, wc1 = wc0 + ww;
  for (int idx = threadIdx.x; idx < 2 * ww; idx += blockDim.x) {
    const bool top = idx < ww;
    const int c = top ? idx : idx - ww;
    const int dst = top ? S.r0 - 1 : S.r1, src = top ? S.r0 : S.r1 - 1;
    if ((top ? S.top : S.bottom) && dst >= wr0 && dst < wr1 && src >= wr0 &&
        src < wr1)
      cur[(dst - wr0) * ww + c] = cur[(src - wr0) * ww + c];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * wh; idx += blockDim.x) {
    const bool left = idx < wh;
    const int r = left ? idx : idx - wh;
    const int dst = left ? S.c0 - 1 : S.c1, src = left ? S.c0 : S.c1 - 1;
    if ((left ? S.left : S.right) && dst >= wc0 && dst < wc1 && src >= wc0 &&
        src < wc1)
      cur[r * ww + dst - wc0] = cur[r * ww + src - wc0];
  }
  __syncthreads();
}

// One elementary op over the window: nxt[cell] = op(neighborhood, cell),
// each warp on whole rows; then the block syncs.
template <class Op>
__device__ __forceinline__ void window_op(const uint8_t* cur, uint8_t* nxt,
                                          int wh, int ww, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < wh; r += nwarps)
    for (int c = lane; c < ww; c += 32)
      nxt[r * ww + c] = op(load_nb(cur, r, c, wh, ww), r * ww + c);
  __syncthreads();
}

// cap: window capacity in cells, min(H, TH + 2 halo) * min(W, TW + 2 halo).
// Dynamic shared memory, morph_cell_bytes<KIND>() cap bytes:
//   acwe, fused: cur[cap] | nxt[cap] | force sign[cap]
//   gac kinds:   dgx[cap] f32 | dgy[cap] f32 | cur | nxt | mask[cap]
// cc (fused): c_in, c_out, l1, l2. block_parts (fused): (nblocks, 2) f64.
// S (shard kinds only): the crop, in Shard's r0, r1, c0, c1, and the flags.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
morph_kernel(const float* __restrict__ ls, const float* __restrict__ aux,
             const float* __restrict__ cc, float* __restrict__ out,
             double* __restrict__ block_parts, int H, int W, int k, int s,
             int parity0, int balloon, float thr_b, int halo, int TH, int TW,
             int cap, Shard S) {
  extern __shared__ __align__(16) unsigned char morph_smem[];
  __shared__ double red_scratch[kThreads / 32];
  __shared__ float s_cc[4];
  constexpr bool kGac = morph_is_gac<KIND>();
  constexpr bool kShard = morph_is_shard<KIND>();
  constexpr int kBase = morph_base<KIND>();
  float* dgx = reinterpret_cast<float*>(morph_smem);
  float* dgy = dgx + cap;
  uint8_t* cur = morph_smem + (kGac ? 8 * (size_t)cap : 0);
  uint8_t* nxt = cur + cap;
  uint8_t* side = cur + 2 * cap;  // force sign (int8) or balloon mask

  // the tiled region: the whole image, or a shard block's crop
  const int tr0 = (kShard ? S.r0 : 0) + blockIdx.y * TH;
  const int tc0 = (kShard ? S.c0 : 0) + blockIdx.x * TW;
  const int tr1 = min(tr0 + TH, kShard ? S.r1 : H);
  const int tc1 = min(tc0 + TW, kShard ? S.c1 : W);
  const int wr0 = max(tr0 - halo, 0), wr1 = min(tr1 + halo, H);
  const int wc0 = max(tc0 - halo, 0), wc1 = min(tc1 + halo, W);
  const int wh = wr1 - wr0, ww = wc1 - wc0;
  const int64_t plane = (int64_t)H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  if (KIND == kMorphFused) {
    if (threadIdx.x < 4) s_cc[threadIdx.x] = cc[threadIdx.x];
    __syncthreads();
  }
  for (int r = warp; r < wh; r += nwarps) {
    const int64_t grow = (int64_t)(wr0 + r) * W;
    for (int c = lane; c < ww; c += 32) {
      const int idx = r * ww + c;
      const int64_t g = grow + wc0 + c;
      cur[idx] = ls[g] > 0.5f;
      if constexpr (kBase == kMorphAcwe) {
        side[idx] = (uint8_t)sign_of(aux[g]);
      } else if constexpr (KIND == kMorphFused) {
        const float d1 = __fsub_rn(aux[g], s_cc[0]);
        const float d2 = __fsub_rn(aux[g], s_cc[1]);
        side[idx] = (uint8_t)sign_of(
            __fsub_rn(__fmul_rn(s_cc[2], __fmul_rn(d1, d1)),
                      __fmul_rn(s_cc[3], __fmul_rn(d2, d2))));
      } else if constexpr (kBase == kMorphGacPre) {
        dgx[idx] = aux[g];
        dgy[idx] = aux[plane + g];
        side[idx] = aux[2 * plane + g] > 0.0f;
      } else {  // gac: the edge map's gradient, clamped to the window
        const int64_t gn = (int64_t)(wr0 + max(r - 1, 0)) * W + wc0 + c;
        const int64_t gs = (int64_t)(wr0 + min(r + 1, wh - 1)) * W + wc0 + c;
        const int64_t gw = grow + wc0 + max(c - 1, 0);
        const int64_t ge = grow + wc0 + min(c + 1, ww - 1);
        dgx[idx] = __fmul_rn(0.5f, __fsub_rn(aux[gs], aux[gn]));
        dgy[idx] = __fmul_rn(0.5f, __fsub_rn(aux[ge], aux[gw]));
        side[idx] = aux[g] > thr_b;
      }
    }
  }
  __syncthreads();

  // the shard kinds' ring refresh before each elementary op
  auto rim = [&] {
    if constexpr (kShard) morph_rim(cur, wr0, wh, wc0, ww, S);
  };
  for (int j = 0; j < k; ++j) {
    if constexpr (kGac) {
      if (balloon != 0) {
        const bool grow = balloon > 0;
        rim();
        window_op(cur, nxt, wh, ww, [&](const Nb& n, int idx) -> uint8_t {
          if (!side[idx]) return n.u;
          return grow ? (uint8_t)(n.u | n.up | n.dn | n.lf | n.rt | n.ul |
                                  n.ur | n.dl | n.dr)
                      : (uint8_t)(n.u & n.up & n.dn & n.lf & n.rt & n.ul &
                                  n.ur & n.dl & n.dr);
        });
        uint8_t* t = cur; cur = nxt; nxt = t;
      }
      rim();
      window_op(cur, nxt, wh, ww, [&](const Nb& n, int idx) -> uint8_t {
        const float dux = 0.5f * (float)((int)n.dn - (int)n.up);
        const float duy = 0.5f * (float)((int)n.rt - (int)n.lf);
        const float a = __fadd_rn(__fmul_rn(dgx[idx], dux),
                                  __fmul_rn(dgy[idx], duy));
        return a > 0.0f ? 1 : (a < 0.0f ? 0 : n.u);
      });
    } else {
      rim();
      window_op(cur, nxt, wh, ww, [&](const Nb& n, int idx) -> uint8_t {
        const int8_t sg = (int8_t)side[idx];
        if ((n.dn == n.up && n.rt == n.lf) || sg == 0) return n.u;
        return sg < 0 ? 1 : 0;
      });
    }
    { uint8_t* t = cur; cur = nxt; nxt = t; }
    for (int c = 0; c < s; ++c) {
      const bool sioi = ((parity0 + j * s + c) & 1) == 0;
      for (int half = 0; half < 2; ++half) {
        // SIoIS: inf-sup first; ISoSI: sup-inf first
        const bool inf_first = sioi == (half == 0);
        rim();
        window_op(cur, nxt, wh, ww, [&](const Nb& n, int) -> uint8_t {
          return inf_first ? inf_sup(n) : sup_inf(n);
        });
        uint8_t* t = cur; cur = nxt; nxt = t;
      }
    }
  }

  double acc0 = 0.0, acc1 = 0.0;
  const int tw = tc1 - tc0;
  for (int r = tr0 - wr0 + warp; r < tr1 - wr0; r += nwarps) {
    for (int oc = lane; oc < tw; oc += 32) {
      const int c = tc0 - wc0 + oc;
      const int64_t g = (int64_t)(wr0 + r) * W + tc0 + oc;
      const float v = cur[r * ww + c] ? 1.0f : 0.0f;
      out[g] = v;
      if (KIND == kMorphFused) {
        acc0 += (double)v;
        acc1 += (double)(aux[g] * v);
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
          out[g] = ls[g];
        }
      }
    }
  }
  if (KIND == kMorphFused) {
    const int64_t bid = blockIdx.y * gridDim.x + blockIdx.x;
    const double s0 = block_sum(acc0, red_scratch);
    if (threadIdx.x == 0) block_parts[bid * 2] = s0;
    const double s1 = block_sum(acc1, red_scratch);
    if (threadIdx.x == 0) block_parts[bid * 2 + 1] = s1;
  }
}

// Host side: one launch on `stream`; for the fused kind also the fixed-order
// reduction of the per-block sums into parts[2]. The caller
// (chan_vese_tpu_torch/ops/_cuda.py) chooses TH, TW and cap and allocates
// out, block_parts and parts.
// A shard kind's grid tiles S's crop.
template <int KIND>
cudaError_t launch_morph(const float* ls, const float* aux, const float* cc,
                         float* out, double* block_parts, float* parts, int H,
                         int W, int k, int s, int parity0, int balloon,
                         float thr_b, int halo, int TH, int TW, int cap,
                         cudaStream_t stream, Shard S = Shard{}) {
  const size_t smem = (size_t)cap * morph_cell_bytes<KIND>();
  cudaError_t err = cudaFuncSetAttribute(
      morph_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr bool kShard = morph_is_shard<KIND>();
  const int th = kShard ? S.r1 - S.r0 : H, tw = kShard ? S.c1 - S.c0 : W;
  const dim3 grid((tw + TW - 1) / TW, (th + TH - 1) / TH);
  morph_kernel<KIND><<<grid, kThreads, smem, stream>>>(
      ls, aux, cc, out, block_parts, H, W, k, s, parity0, balloon, thr_b,
      halo, TH, TW, cap, S);
  err = cudaGetLastError();
  if (err != cudaSuccess || KIND != kMorphFused) return err;
  reduce_parts_kernel<<<1, 256, 0, stream>>>(
      block_parts, (int)(grid.x * grid.y), 2, 2, parts);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cv
