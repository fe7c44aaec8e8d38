// K14's first body (`_v1`, the yardstick of halo_gather.cu): the halo
// exchange's ring shift along one grid axis, written as the padded blocks
// themselves. Replaces chan_vese_tpu/parallel/halo_rdma.py::
// _ring_kernel (launched by _ring_exchange, pl.pallas_call at :97), the
// remote-DMA ring that sends each shard's hi strip into the next shard's
// from_lo buffer and its lo strip into the previous shard's from_hi buffer.
//
// One launch covers every shard of a grid axis whose source block lies on
// the launching device. The wrapper (parallel/halo_rdma.py) describes the
// stage as row copies, three per shard: the block itself into the centre
// of its own padded block, its hi strip into the next shard's leading
// halo, its lo strip into the previous shard's trailing halo. Where the
// ring wraps (the next shard of the last is the first), the destination
// halo lies at the global image edge, where the reference overwrites the
// wrapped strip with edge replicas: the task writes the replica in its
// place (the shard's own edge row or column, read with a zero stride), so
// no cell is written twice and the result is the reference's. Stores go
// straight into the destination's memory; on another card that memory is
// a peer pointer (unified addressing, peer access enabled once per pair by
// cv_halo_peer_access): an NVLink store, the card's counterpart of the
// TPU's remote DMA. The wrapper orders the launch after the destination's
// allocation and the destination's later work after the launch with CUDA
// events, the counterpart of the reference's barrier semaphore.
//
// The task table travels by value as a __grid_constant__ kernel parameter
// (constant memory: no allocation and no copy per launch). Each warp copies
// one row of one task, neighbouring lanes on neighbouring 16-byte words
// where the addresses, strides and widths allow it, else element by
// element. Bound on the card: device memory (each source element read and
// each destination element written once a stage; a row stage at D = 32 on
// a 1080x1920 f32 shard moves 2 x 8.3 MB). Pure copies through registers,
// so bitwise for any 4- or 8-byte element type.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTasks = 48;
constexpr int kMaxBlocks = 4096;

}  // namespace

// One copy of the stage, described by the wrapper: rows x cols elements of
// each of `batch` slices. src_row == 0 repeats source row 0 (a row replica),
// src_col == 0 repeats source column 0 (a column replica), src_col == 1
// reads the row in order. Strides are in elements.
struct RingTask {
  const void* src;
  void* dst;
  long long src_batch, dst_batch;
  int src_row, src_col, dst_row;
  int rows, cols, batch;
};

namespace {

struct DevTask {
  const char* src;
  char* dst;
  long long src_batch, dst_batch;
  int src_row, src_col, dst_row;
  int rows, cols, row0, vec;
};

struct Table {
  DevTask t[kMaxTasks];
  int n, total;
};

template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
halo_ring_kernel(const __grid_constant__ Table tab) {
  constexpr int E = sizeof(V) / sizeof(T);  // elements per 16-byte word
  const int lane = threadIdx.x & 31;
  for (int g = blockIdx.x * kWarps + (threadIdx.x >> 5); g < tab.total;
       g += gridDim.x * kWarps) {
    int t = 0;
    while (t + 1 < tab.n && tab.t[t + 1].row0 <= g) ++t;
    const DevTask& k = tab.t[t];
    const int lr = g - k.row0, b = lr / k.rows, r = lr - b * k.rows;
    const T* s = reinterpret_cast<const T*>(k.src) + b * k.src_batch +
                 (long long)r * k.src_row;
    T* d = reinterpret_cast<T*>(k.dst) + b * k.dst_batch +
           (long long)r * k.dst_row;
    if (k.vec) {
      const V* s4 = reinterpret_cast<const V*>(s);
      V* d4 = reinterpret_cast<V*>(d);
      for (int c = lane; c < k.cols / E; c += 32) d4[c] = s4[c];
    } else {
      for (int c = lane; c < k.cols; c += 32)
        d[c] = s[(long long)c * k.src_col];
    }
  }
}

bool aligned16(const void* p, long long elems, int esize) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) &&
         (elems * esize) % 16 == 0;
}

}  // namespace

// Launch one stage: n tasks (1..48) of elements of esize bytes (4 or 8) on
// `stream`. Returns the launch's error (cudaSuccess when queued).
extern "C" cudaError_t cv_halo_ring_v1(const RingTask* tasks, int n,
                                       int esize, void* stream) {
  if (n < 1 || n > kMaxTasks || (esize != 4 && esize != 8))
    return cudaErrorInvalidValue;
  Table tab;
  long long total = 0;
  for (int i = 0; i < n; ++i) {
    const RingTask& h = tasks[i];
    if (h.rows < 1 || h.cols < 1 || h.batch < 1 || h.src_col < 0 ||
        h.src_col > 1 || h.src_row < 0)
      return cudaErrorInvalidValue;
    DevTask& d = tab.t[i];
    d.src = static_cast<const char*>(h.src);
    d.dst = static_cast<char*>(h.dst);
    d.src_batch = h.src_batch;
    d.dst_batch = h.dst_batch;
    d.src_row = h.src_row;
    d.src_col = h.src_col;
    d.dst_row = h.dst_row;
    d.rows = h.rows;
    d.cols = h.cols;
    d.row0 = (int)total;
    d.vec = h.src_col == 1 && aligned16(h.src, h.src_row, esize) &&
            aligned16(h.dst, h.dst_row, esize) &&
            (h.batch == 1 || (aligned16(h.src, h.src_batch, esize) &&
                              aligned16(h.dst, h.dst_batch, esize))) &&
            ((long long)h.cols * esize) % 16 == 0;
    total += (long long)h.rows * h.batch;
    if (total > INT_MAX) return cudaErrorInvalidValue;
  }
  tab.n = n;
  tab.total = (int)total;
  long long blocks = (total + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t s = (cudaStream_t)stream;
  if (esize == 4)
    halo_ring_kernel<float, float4><<<(int)blocks, kThreads, 0, s>>>(tab);
  else
    halo_ring_kernel<double, double2><<<(int)blocks, kThreads, 0, s>>>(tab);
  return cudaGetLastError();
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
