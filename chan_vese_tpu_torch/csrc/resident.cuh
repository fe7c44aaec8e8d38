// Shared device code of the Hopper exact-means resident kernels: K7
// resident.cu / resident_mc.cu (flat layout) and K8 packed_resident.cu /
// packed_resident_mc.cu (parity planes), each on a scalar image, a stack
// of scalar frames, or (mc) one C-channel image; and of K13
// resident_chunk.cu, its frozen-means chunk mode in either layout. One
// body, templated on <bool PACKED, int NC> as redblack.cuh's chunk kernel
// is.
//
// What a launch computes: `iters` full Chan-Vese iterations with the
// region means recomputed from the current phi at every iteration (no
// frozen-means chunk, no lag), the contract of
// chan_vese_tpu/ops/pallas_resident.py::_kernel/_kernel_batch/_kernel_mc
// and ops/pallas_packed.py::_packed_resident_*kernel. Per iteration:
//   c1 = s_uH / max(s_H, 1e-30), c2 = (sum u - s_uH) / max(n - s_H, 1e-30)
//   per channel, from the phi the iteration starts from; the data term of
//   redblack.cuh::data_term (l[c]/C weights for C channels); the red, then
//   the black half-sweep with _update_all semantics and replica-eval
//   Neumann at the image edges.
// Partials rows [s_uH per channel..., s_H, s_dphi2, flips, s_absdphi,
// 0...] describe one iteration: the last of every `unroll` for a single
// image, the last of each frame for a stack.
//
// Shape on Hopper. A 1024^2 f32 image (4 MB) does not fit one SM's shared
// memory, but phi twice, u0 and the scratch fit the 50 MB L2, so the
// counterpart of "VMEM-resident" is one persistent cooperative launch
// whose working set stays in L2. The grid is at most what can be
// co-resident (the wrapper sizes it from the occupancy query below); each
// thread walks horizontal cell pairs (one red, one black cell) with a grid
// stride. Per iteration:
//   (b) red half-sweep: read buffer A (phi at the iteration's start, the
//       input for iteration 0), write the new red values and copies of the
//       black ones into B; grid sync;
//   (c) black half-sweep: read B, write the new black values and B's red
//       values into A; accumulate the row partials on a row iteration and
//       the next iteration's H(phi) sums; grid sync;
//   (a) means: every block sums the per-block f64 slots of (c) in the same
//       fixed order, so all blocks hold bitwise-equal c1/c2 (no atomics).
// Iteration 0's sums come from a separate pass over the input. So an
// iteration costs two grid syncs.
//
// Frozen-means chunk mode (K13, resident_chunk.cu; ResidentArgs::cc set):
// the contract of chan_vese_tpu/ops/pallas_packed.py::packed_chunk and of
// banded_chunk: k iterations with the given c1/c2 held fixed (no input
// pass, no step (a)), then one row of partials of the LAST iteration,
// [s_uH, s_H] of the phi it leaves and [s_dphi2, flips, s_absdphi] of its
// transition. The data term is evaluated from u0 and the frozen means at
// each read, the same expression on the same inputs as a plane computed
// once, at the bytes of reading one. Still two grid syncs an iteration.
//
// Coherence. Buffers written inside the launch (A, B, the scratch) are
// read with plain loads, never through __ldg or a const __restrict__
// pointer: the read-only path is not coherent across grid.sync(), plain
// loads are ordered by it.
//
// Bound on the card: per iteration each cell is read about 9 times from
// L1/L2 and written once, with 4 rsqrt, 1 divide and 1 atan; the two grid
// syncs and the all-block reduction are a fixed cost per iteration that
// dominates small images. Device memory is touched once per launch.

#pragma once

#include <cooperative_groups.h>

#include "redblack.cuh"

namespace cv {
namespace {

namespace cg = cooperative_groups;

constexpr int kResThreads = 512;

// Offset of image cell (i, j) in the flat or plane layout.
template <bool PACKED>
struct ImageIdx {
  int H, W;
  __device__ __forceinline__ int64_t operator()(int i, int j) const {
    return gaddr<PACKED>(i, j, H, W);
  }
};

struct ResidentArgs {
  const float* phi_in;  // (N, image): phi at the start, never written
  float* out;           // (N, image): buffer A, holds the result
  float* tmp;           // (image): buffer B
  const float* u0;      // (N, image) scalar frames or (C, image) channels
  const double* usum;   // sum of u0 per frame (scalar) or channel (mc)
  const float* wts;     // mc: [l1/C x C, l2/C x C]; unused for NC = 0
  double* scratch;      // (nblocks, uh + 1) H sums | (nblocks, 3) row sums
  float* parts;         // partials rows of nrow floats
  int N, H, W, iters, unroll, batch, nrow;
  // frozen-means chunk mode: (c1, c2) for every iteration (scalar image,
  // one frame, unroll = iters); null in the exact-means modes
  const float* cc;
};

template <bool PACKED, int NC>
__global__ void __launch_bounds__(kResThreads)
resident_kernel(ResidentArgs a, Params P) {
  constexpr int kUh = uh_slots<NC>(), kM = kUh + 1;
  __shared__ double red_scratch[kResThreads / 32];
  __shared__ double s_tot[kM + 3];
  __shared__ float s_cc[cc_len<NC>()];
  cg::grid_group grid = cg::this_grid();

  const int H = a.H, W = a.W, hw = W >> 1, npairs = H * hw;
  const int64_t chan = (int64_t)H * W;
  const double n_pix = (double)chan;
  const int nb = gridDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gstride = nb * blockDim.x;
  const ImageIdx<PACKED> idx{H, W};
  double* means_parts = a.scratch;
  double* row_parts = a.scratch + (int64_t)nb * kM;
  const bool frozen = a.cc != nullptr;

  if constexpr (NC > 0) {
    for (int t = threadIdx.x; t < 2 * NC; t += blockDim.x)
      s_cc[2 * NC + t] = a.wts[t];
  } else {
    if (frozen) {
      if (threadIdx.x < 2) s_cc[threadIdx.x] = a.cc[threadIdx.x];
      __syncthreads();
    }
  }

  for (int fr = 0; fr < a.N; ++fr) {
    const int64_t off = a.batch ? fr * chan : 0;
    const float* u0 = a.u0 + off;
    const float* start = a.phi_in + off;
    float* A = a.out + off;
    float* B = a.tmp;

    double acc[kM];
    // H sums of the input: iteration 0's means
    if (!frozen) {
#pragma unroll
      for (int s = 0; s < kM; ++s) acc[s] = 0.0;
      for (int t = gtid; t < npairs; t += gstride) {
        const int i = t / hw, j0 = 2 * (t - i * hw);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t g = idx(i, j0 + e);
          const float h = 0.5f + P.inv_pi * atanf(start[g] / P.eps);
#pragma unroll
          for (int ch = 0; ch < kUh; ++ch)
            acc[ch] += (double)(u0[ch * chan + g] * h);
          acc[kUh] += (double)h;
        }
      }
#pragma unroll
      for (int s = 0; s < kM; ++s) {
        const double v = block_sum(acc[s], red_scratch);
        if (threadIdx.x == 0) means_parts[blockIdx.x * kM + s] = v;
      }
      grid.sync();
    }

    for (int it = 0; it < a.iters; ++it) {
      const float* cur = it == 0 ? start : A;
      const bool row = a.batch ? it == a.iters - 1
                               : it % a.unroll == a.unroll - 1;
      // H sums of the phi this iteration leaves: the next iteration's
      // means, or in the frozen mode the last iteration's partials
      const bool more = frozen ? it + 1 == a.iters : it + 1 < a.iters;

      // (a) means: every block reduces all blocks' slots in one order
      if (!frozen) {
#pragma unroll
        for (int s = 0; s < kM; ++s) {
          double v = 0.0;
          for (int b = threadIdx.x; b < nb; b += blockDim.x)
            v += means_parts[b * kM + s];
          v = block_sum(v, red_scratch);
          if (threadIdx.x == 0) s_tot[s] = v;
        }
        if (threadIdx.x == 0) {
          const double in = fmax(s_tot[kUh], 1e-30);
          const double outside = fmax(n_pix - s_tot[kUh], 1e-30);
#pragma unroll
          for (int ch = 0; ch < kUh; ++ch) {
            const double su = a.usum[NC == 0 ? fr : ch];
            s_cc[ch] = (float)(s_tot[ch] / in);
            s_cc[kUh + ch] = (float)((su - s_tot[ch]) / outside);
          }
        }
        __syncthreads();
      }

      // (b) red half-sweep: A -> B
      for (int t = gtid; t < npairs; t += gstride) {
        const int i = t / hw, q = t - i * hw;
        const int jr = 2 * q + (i & 1), jb = 2 * q + 1 - (i & 1);
        const int64_t gr = idx(i, jr), gb = idx(i, jb);
        const float fv = data_term<NC>(u0, gr, chan, s_cc, P);
        B[gr] = update_cell_at(cur, [fv] { return fv; }, i, jr, H, W, idx, P);
        B[gb] = cur[gb];
      }
      grid.sync();

      // (c) black half-sweep: B -> A, with the row partials and the next
      // iteration's H sums
      double d2 = 0.0, fl = 0.0, ad = 0.0;
#pragma unroll
      for (int s = 0; s < kM; ++s) acc[s] = 0.0;
      for (int t = gtid; t < npairs; t += gstride) {
        const int i = t / hw, q = t - i * hw;
        const int jr = 2 * q + (i & 1), jb = 2 * q + 1 - (i & 1);
        const int64_t gr = idx(i, jr), gb = idx(i, jb);
        const float fv = data_term<NC>(u0, gb, chan, s_cc, P);
        const float nbk = update_cell_at(B, [fv] { return fv; }, i, jb, H, W,
                                         idx, P);
        const float nrd = B[gr];
        if (row) {
          const float ord = cur[gr], obk = B[gb];
          const float dr = nrd - ord, db = nbk - obk;
          d2 += (double)(dr * dr) + (double)(db * db);
          fl += (((nrd >= 0.0f) != (ord >= 0.0f)) ? 1.0 : 0.0)
                + (((nbk >= 0.0f) != (obk >= 0.0f)) ? 1.0 : 0.0);
          ad += (double)fabsf(dr) + (double)fabsf(db);
        }
        A[gr] = nrd;
        A[gb] = nbk;
        if (more) {
          const float hr = 0.5f + P.inv_pi * atanf(nrd / P.eps);
          const float hb = 0.5f + P.inv_pi * atanf(nbk / P.eps);
#pragma unroll
          for (int ch = 0; ch < kUh; ++ch)
            acc[ch] += (double)(u0[ch * chan + gr] * hr)
                       + (double)(u0[ch * chan + gb] * hb);
          acc[kUh] += (double)hr + (double)hb;
        }
      }
      if (more) {
#pragma unroll
        for (int s = 0; s < kM; ++s) {
          const double v = block_sum(acc[s], red_scratch);
          if (threadIdx.x == 0) means_parts[blockIdx.x * kM + s] = v;
        }
      }
      if (row) {
        const double v0 = block_sum(d2, red_scratch);
        const double v1 = block_sum(fl, red_scratch);
        const double v2 = block_sum(ad, red_scratch);
        if (threadIdx.x == 0) {
          row_parts[blockIdx.x * 3 + 0] = v0;
          row_parts[blockIdx.x * 3 + 1] = v1;
          row_parts[blockIdx.x * 3 + 2] = v2;
        }
      }
      grid.sync();

      // block 0 writes the row; the next write of row_parts is two grid
      // syncs away. A frozen row's [s_uH, s_H] are the H sums (c) just
      // wrote; an exact row's are the ones (a) reduced.
      if (row && blockIdx.x == 0) {
        if (frozen) {
          for (int s = 0; s < kM; ++s) {
            double v = 0.0;
            for (int b = threadIdx.x; b < nb; b += blockDim.x)
              v += means_parts[b * kM + s];
            v = block_sum(v, red_scratch);
            if (threadIdx.x == 0) s_tot[s] = v;
          }
        }
        for (int s = 0; s < 3; ++s) {
          double v = 0.0;
          for (int b = threadIdx.x; b < nb; b += blockDim.x)
            v += row_parts[b * 3 + s];
          v = block_sum(v, red_scratch);
          if (threadIdx.x == 0) s_tot[kM + s] = v;
        }
        if (threadIdx.x == 0) {
          float* dst =
              a.parts + (int64_t)(a.batch ? fr : it / a.unroll) * a.nrow;
          for (int s = 0; s < kM + 3; ++s) dst[s] = (float)s_tot[s];
          for (int s = kM + 3; s < a.nrow; ++s) dst[s] = 0.0f;
        }
        __syncthreads();
      }
    }
  }
}

// Host side. The most blocks of resident_kernel<PACKED, NC> that can be
// co-resident on the current device: occupancy per SM x SM count.
template <bool PACKED, int NC>
cudaError_t resident_grid(int* max_blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, resident_kernel<PACKED, NC>, kResThreads, 0);
  if (err != cudaSuccess) return err;
  *max_blocks = per_sm * sms;
  return cudaSuccess;
}

// One cooperative launch of nblocks blocks on `stream`. A grid that cannot
// be co-resident is refused (cudaErrorCooperativeLaunchTooLarge) and the
// error goes back to the wrapper, which raises.
template <bool PACKED, int NC>
cudaError_t launch_resident(ResidentArgs a, Params P, int nblocks,
                            cudaStream_t stream) {
  void* args[] = {(void*)&a, (void*)&P};
  return cudaLaunchCooperativeKernel((const void*)resident_kernel<PACKED, NC>,
                                     dim3(nblocks), dim3(kResThreads), args,
                                     0, stream);
}

// C-channel image: the runtime channel count C picks the instance.
template <bool PACKED, int NC = 1>
cudaError_t resident_grid_mc(int C, int* max_blocks) {
  if (C == NC) return resident_grid<PACKED, NC>(max_blocks);
  if constexpr (NC < kMaxChannels)
    return resident_grid_mc<PACKED, NC + 1>(C, max_blocks);
  return cudaErrorInvalidValue;
}

template <bool PACKED, int NC = 1>
cudaError_t launch_resident_mc(int C, ResidentArgs a, Params P, int nblocks,
                               cudaStream_t stream) {
  if (C == NC) return launch_resident<PACKED, NC>(a, P, nblocks, stream);
  if constexpr (NC < kMaxChannels)
    return launch_resident_mc<PACKED, NC + 1>(C, a, P, nblocks, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cv

// The plain C interface every resident launcher exports (one .cu per
// layout and channel mode): pointers, grid size, geometry, the nine
// parameters of redblack.cuh's Params, the stream.
#define CV_RESIDENT_ARGS                                              \
  const float *phi_in, float *out, float *tmp, const float *u0,      \
  const double *usum, const float *wts, double *scratch,             \
  float *parts, int nblocks, int N, int H, int W, int C, int iters,  \
  int unroll, int batch, int nrow, float mu, float nu, float l1,     \
  float l2, float eta2, float gdt, float eps, float eps2,            \
  float inv_pi, void *stream
// The kernel's two arguments built from CV_RESIDENT_ARGS.
#define CV_RESIDENT_STRUCTS                                           \
  cv::ResidentArgs{phi_in, out, tmp, u0, usum, wts, scratch, parts,  \
                   N, H, W, iters, unroll, batch, nrow},             \
  cv::Params{mu, nu, l1, l2, eta2, gdt, eps, eps2, inv_pi}
