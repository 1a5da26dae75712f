// The WCOJ level probe: mask a padded candidate tensor by every constraint
// of one generator group in one launch.
//
// Replaces the fused XLA program wukong_tpu/join/kernels.py:jit_level_probe
// (and the pair probes of the JAX whole-plan template program,
// wukong_tpu/engine/template_compile.py _build_program's filter_pair and
// filter_pair_const ops). Contract: the plain version level_probe_plain in
// wukong_tpu_torch/join/kernels.py. For every i < C:
//
//   mask[i] = valid[i]
//             AND (no glob, or cand[i] is in the sorted glob[0 .. nglob))
//             AND for every adjacency j: the edge anchors_j[i] -> cand[i]
//                 exists in the CSR (keys_j, offsets_j, edges_j)
//
// where the edge test is the JAX pair_member: a lower_bound of anchors_j[i]
// in keys_j gives the key's [start, end) edge run (empty when the key is
// absent or the CSR has no edges), then a branchless lower_bound of cand[i]
// over that run iterated exactly depth_j times (the segment's
// log2(max degree) + 1, so every run converges), then one compare at the
// cursor. Iterations after the range is empty change nothing, so a thread
// leaves the loop there: the result is the plain version's bit for bit,
// with a depth too small for a run as well.
//
// int32 throughout (ids and offsets range-checked by the wrapper's caller,
// to_device_i32), with the midpoint lo + (hi - lo) / 2: lo + hi overflows
// past 2^30 edges (the note at wukong_tpu/join/kernels.py pair_member).
//
// What bounds it on an H100: bytes. The function must read valid, cand and
// each adjacency's anchors once (1 + 4 + 4J B a row) and write the mask
// (1 B a row); every binary-search step reads one 4 B value at a
// data-dependent address, which costs a 32 B sector when it misses the
// caches. The design is the simple one: one thread a candidate, the
// adjacency descriptors passed by value in the kernel's parameters (up to
// kMaxAdj a launch; the wrapper chains launches past that), a grid of as
// many blocks as fit on the card striding over the candidates. Staging the
// glob in shared memory and sorting candidates by anchor (so neighbouring
// threads search the same run) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAdj = 8;
constexpr int kMaxDevices = 64;

}  // namespace

// one adjacency: a CSR (keys sorted unique, nkeys + 1 offsets, edges sorted
// within each key's run) and the anchor of every candidate
struct WkAdj {
  const int* keys;
  const int* offsets;
  const int* edges;
  const int* anchors;
  int nkeys;
  int nedges;
  int depth;
  int pad;
};

namespace {

struct AdjPack {
  WkAdj a[kMaxAdj];
  int n;
};

// first index in sorted a[0 .. n) whose value is not below v (n if none)
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (__ldg(a + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ bool member(const int* __restrict__ glob,
                                       int nglob, int v) {
  if (nglob <= 0) return false;
  const int i = lower_bound(glob, nglob, v);
  return i < nglob && __ldg(glob + i) == v;
}

__device__ __forceinline__ bool pair_member(const WkAdj& adj, int anchor,
                                            int v) {
  const int ne = adj.nedges;
  if (ne <= 0) return false;
  int lo = 0, hi = 0;
  if (adj.nkeys > 0) {
    const int k = lower_bound(adj.keys, adj.nkeys, anchor);
    if (k < adj.nkeys && __ldg(adj.keys + k) == anchor) {
      lo = __ldg(adj.offsets + k);
      hi = __ldg(adj.offsets + k + 1);
    }
  }
  const int end = hi;
  for (int it = 0; it < adj.depth && lo < hi; ++it) {
    const int mid = lo + (hi - lo) / 2;
    const int mc = mid < 0 ? 0 : (mid > ne - 1 ? ne - 1 : mid);
    if (__ldg(adj.edges + mc) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo >= end) return false;
  const int lc = lo < 0 ? 0 : (lo > ne - 1 ? ne - 1 : lo);
  return __ldg(adj.edges + lc) == v;
}

__global__ void __launch_bounds__(kThreads)
    level_probe_kernel(const unsigned char* valid,
                       const int* __restrict__ cand, int C,
                       const int* __restrict__ glob, int nglob, int has_glob,
                       const AdjPack pack, unsigned char* mask) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < C; i += stride) {
    bool ok = valid[i] != 0;
    const int v = cand[i];
    if (ok && has_glob) ok = member(glob, nglob, v);
    for (int j = 0; ok && j < pack.n; ++j) {
      ok = pair_member(pack.a[j], __ldg(pack.a[j].anchors + i), v);
    }
    mask[i] = ok ? 1 : 0;
  }
}

// blocks of level_probe_kernel that fit on device dev at once
int resident_blocks(int dev) {
  static std::atomic<int> known[kMaxDevices];  // 0: not asked yet
  if (dev < kMaxDevices) {
    const int n = known[dev].load(std::memory_order_relaxed);
    if (n > 0) return n;
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, level_probe_kernel,
                                                kThreads, 0);
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) known[dev].store(n, std::memory_order_relaxed);
  return n;
}

}  // namespace

extern "C" int wk_level_probe_max_adj() { return kMaxAdj; }

// valid and mask are C bytes (bool), cand C int32; glob nglob int32 (read
// only when has_glob); adjs[0 .. J) host descriptors of device tables with
// J <= kMaxAdj, each anchors array C int32. mask may alias valid. dev is
// the device of every pointer and of the stream: it is made current for the
// launch (and the caller's current device restored).
extern "C" int wk_level_probe(const unsigned char* valid, const int* cand,
                              int C, const int* glob, int nglob, int has_glob,
                              const WkAdj* adjs, int J, unsigned char* mask,
                              int dev, cudaStream_t stream) {
  if (C <= 0) return (int)cudaGetLastError();
  if (J < 0 || J > kMaxAdj) return (int)cudaErrorInvalidValue;
  AdjPack pack;
  pack.n = J;
  for (int j = 0; j < J; ++j) pack.a[j] = adjs[j];
  int was = dev;
  cudaGetDevice(&was);
  if (was != dev) cudaSetDevice(dev);
  const long long want = (C + kThreads - 1) / kThreads;
  const long long fit = resident_blocks(dev);
  const unsigned blocks = (unsigned)(want < fit ? want : fit);
  level_probe_kernel<<<blocks, kThreads, 0, stream>>>(
      valid, cand, C, glob, nglob, has_glob, pack, mask);
  const int rc = (int)cudaGetLastError();
  if (was != dev) cudaSetDevice(was);
  return rc;
}

extern "C" const char* wk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
