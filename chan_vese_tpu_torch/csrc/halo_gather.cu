// K14: the halo exchange as one clamped gather, a launch a device.
// Replaces chan_vese_tpu/parallel/halo_rdma.py::_ring_kernel (launched by
// _ring_exchange, pl.pallas_call at :97) as exchange_halo2d_rdma uses it:
// two ring stages, rows then the columns of the row-extended blocks, each
// shard's strips sent into its neighbours' halo buffers and the strips
// that wrap round the ring overwritten by edge replicas.
//
// What an exchange computes. The two stages with their replicas are one
// clamped gather: shard (ix, iy) at global offset (r0, c0) of an H x W
// image, padded by D, gets
//   padded[..., i, j] = u[..., clamp(r0 - D + i, 0, H - 1),
//                              clamp(c0 - D + j, 0, W - 1)]
// for each leading slice on its own (a stack of level sets, parity
// planes), wherever D is at most every shard's height and width (then a
// padded row reads the shard's own grid row and its neighbours' only).
//
// Design. The reference's two stages copy whole blocks into larger ones,
// about twice the bytes the exchange needs. Here one launch on a device
// writes every padded block that lies on it. Each warp owns one
// padded destination row of one shard and slice: the global row
// clamp(r0 - D + i) is found in the grid row above, the shard's own or the
// one below, and the warp writes the row's three runs from that grid row:
// the west D cells (the last D columns of the shard to the west, or the
// replica of global column 0), the centre w cells, the east D cells (the
// first D of the shard to the east, or the replica of column W - 1).
// Every destination element is written once and every source element read
// once, plus the D-deep strips the neighbours read; no intermediate block
// is made. Lanes take neighbouring 16-byte words where the source and
// destination addresses share their alignment (a scalar head and tail
// around the words), else neighbouring elements. Sources on another card
// are read through peer pointers (unified addressing, peer access enabled
// by cv_halo_peer_access): the pull over NVLink is the counterpart of the
// TPU's remote DMA; the wrapper orders the launch after each source's
// stream and the source's later work after the launch.
//
// The geometry (shapes, strides, each shard's grid row offsets and its
// place in the launch) is built once per grid by the wrapper and cached;
// a call fills only the base pointers. Both travel by value as a
// __grid_constant__ parameter (constant memory: no allocation, no copy).
//
// Bound on the card: device memory, each source element read and each
// padded element written once (at D = 32 on four 1080 x 1920 f32 shards,
// 33.2 MB read and 36.3 MB written). Pure copies through registers, so
// bitwise for any 4- or 8-byte element type.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShards = 64;  // parallel/halo_rdma.py _MAX_SHARDS
constexpr int kMaxBlocks = 8192;

}  // namespace

// The cached geometry of one device's launch (parallel/halo_rdma.py
// _GatherGeo). Shards are numbered ix * ny + iy; strides in elements.
struct GatherGeo {
  long long src_slice[kMaxShards];  // between leading slices of a source
  int src_row[kMaxShards];          // between rows of a source
  int h[kMaxShards], w[kMaxShards];  // the shard's extent
  int rows0[kMaxShards + 1];  // global row offset of grid row ix (nx + 1)
  int dst[kMaxShards];        // the shards padded on this device, in order
  int row0[kMaxShards];       // the first launch row of dst[k]'s block
  int nx, ny, ndst, depth, slices, total;
};

namespace {

struct Table {
  GatherGeo g;
  const char* src[kMaxShards];  // every shard's block
  char* out[kMaxShards];        // the padded block of dst[k]
};

template <typename V, typename T>
__device__ __forceinline__ V splat(T v);
template <>
__device__ __forceinline__ float4 splat<float4, float>(float v) {
  return make_float4(v, v, v, v);
}
template <>
__device__ __forceinline__ double2 splat<double2, double>(double v) {
  return make_double2(v, v);
}

// d[0, n) = s[0, n) on one warp: 16-byte words where d and s share their
// alignment, four in flight a lane; else element by element.
template <typename T, typename V>
__device__ __forceinline__ void copy_run(T* d, const T* s, int n, int lane) {
  constexpr int E = sizeof(V) / sizeof(T);
  const uintptr_t da = reinterpret_cast<uintptr_t>(d);
  if (((da ^ reinterpret_cast<uintptr_t>(s)) & 15) == 0) {
    int head = (int)(((16 - (da & 15)) & 15) / sizeof(T));
    if (head > n) head = n;
    if (lane < head) d[lane] = s[lane];
    const int nv = (n - head) / E;
    const V* s4 = reinterpret_cast<const V*>(s + head);
    V* d4 = reinterpret_cast<V*>(d + head);
    int c = lane;
    for (; c + 96 < nv; c += 128) {
      const V a0 = s4[c], a1 = s4[c + 32], a2 = s4[c + 64], a3 = s4[c + 96];
      d4[c] = a0;
      d4[c + 32] = a1;
      d4[c + 64] = a2;
      d4[c + 96] = a3;
    }
    for (; c < nv; c += 32) d4[c] = s4[c];
    const int t0 = head + nv * E;
    if (lane < n - t0) d[t0 + lane] = s[t0 + lane];
  } else {
    for (int c = lane; c < n; c += 32) d[c] = s[c];
  }
}

// d[0, n) = v on one warp, 16-byte words where d's alignment allows.
template <typename T, typename V>
__device__ __forceinline__ void fill_run(T* d, T v, int n, int lane) {
  constexpr int E = sizeof(V) / sizeof(T);
  const uintptr_t da = reinterpret_cast<uintptr_t>(d);
  int head = (int)(((16 - (da & 15)) & 15) / sizeof(T));
  if (head > n) head = n;
  if (lane < head) d[lane] = v;
  const int nv = (n - head) / E;
  V* d4 = reinterpret_cast<V*>(d + head);
  const V vv = splat<V, T>(v);
  for (int c = lane; c < nv; c += 32) d4[c] = vv;
  const int t0 = head + nv * E;
  if (lane < n - t0) d[t0 + lane] = v;
}

template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
halo_gather_kernel(const __grid_constant__ Table tab) {
  const GatherGeo& g = tab.g;
  const int lane = threadIdx.x & 31, D = g.depth, ny = g.ny;
  const int H = g.rows0[g.nx];
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < g.total;
       r += gridDim.x * kWarps) {
    int k = 0;
    while (k + 1 < g.ndst && g.row0[k + 1] <= r) ++k;
    const int s = g.dst[k], ix = s / ny, iy = s - ix * ny;
    const int h = g.h[s], w = g.w[s], ph = h + 2 * D, pw = w + 2 * D;
    const int lr = r - g.row0[k], b = lr / ph, i = lr - b * ph;
    // the global row this padded row holds, and the grid row that owns it
    const int r0 = g.rows0[ix];
    const int gr = min(max(r0 - D + i, 0), H - 1);
    const int sx = gr < r0 ? ix - 1 : gr >= g.rows0[ix + 1] ? ix + 1 : ix;
    const int sr = gr - g.rows0[sx], c = sx * ny + iy;
    auto row_of = [&](int t) {
      return reinterpret_cast<const T*>(tab.src[t]) + b * g.src_slice[t] +
             (long long)sr * g.src_row[t];
    };
    const T* centre = row_of(c);
    T* d = reinterpret_cast<T*>(tab.out[k]) + ((long long)b * ph + i) * pw;
    if (iy == 0)
      fill_run<T, V>(d, centre[0], D, lane);
    else
      copy_run<T, V>(d, row_of(c - 1) + (g.w[c - 1] - D), D, lane);
    copy_run<T, V>(d + D, centre, w, lane);
    if (iy == ny - 1)
      fill_run<T, V>(d + D + w, centre[w - 1], D, lane);
    else
      copy_run<T, V>(d + D + w, row_of(c + 1), D, lane);
  }
}

}  // namespace

// One exchange's launch on device `dev`: the padded blocks of geo's dst
// shards, from every shard's block ptrs[0, nx ny) into ptrs[nx ny, nx ny +
// ndst), elements of esize bytes (4 or 8), on `stream`. Returns the
// launch's error (cudaSuccess when queued); the caller's current device is
// kept.
extern "C" cudaError_t cv_halo_gather(const GatherGeo* geo,
                                      void* const* ptrs, int esize, int dev,
                                      void* stream) {
  const int n = geo->nx * geo->ny;
  if (n < 1 || n > kMaxShards || geo->ndst < 1 || geo->ndst > n ||
      geo->depth < 1 || geo->slices < 1 || geo->total < 1 ||
      (esize != 4 && esize != 8))
    return cudaErrorInvalidValue;
  Table tab;
  tab.g = *geo;
  for (int s = 0; s < n; ++s) tab.src[s] = static_cast<const char*>(ptrs[s]);
  for (int k = 0; k < geo->ndst; ++k)
    tab.out[k] = static_cast<char*>(ptrs[n + k]);
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  if (cur != dev && (err = cudaSetDevice(dev)) != cudaSuccess) return err;
  long long blocks = (geo->total + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t s = (cudaStream_t)stream;
  if (esize == 4)
    halo_gather_kernel<float, float4><<<(int)blocks, kThreads, 0, s>>>(tab);
  else
    halo_gather_kernel<double, double2><<<(int)blocks, kThreads, 0, s>>>(tab);
  err = cudaGetLastError();
  if (cur != dev) {
    const cudaError_t back = cudaSetDevice(cur);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

// Let `dev` store into `peer`'s memory (once per ordered pair; a pair
// already enabled is no error). The caller's current device is kept.
extern "C" cudaError_t cv_halo_peer_access(int dev, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return err;
  if (!can) return cudaErrorPeerAccessUnsupported;
  int cur = 0;
  err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(dev);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the error it recorded
      err = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(cur);
  return err != cudaSuccess ? err : back;
}
