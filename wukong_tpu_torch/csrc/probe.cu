// K1: 8-way bucketized hash probe of a frontier against a staged segment.
//
// Replaces wukong_tpu/engine/tpu_kernels.py:pallas_probe (the Pallas kernel
// that kept the three bucket arrays resident in VMEM). Contract: the plain
// version _hash_find in wukong_tpu_torch/engine/tpu_kernels.py. For each
// frontier row i < n: hb = (cur[i] * 2654435761 mod 2^32) & (NB - 1); probe
// rounds r = 0 .. max_probe-1 read bucket (hb + r) & (NB - 1); the first lane
// (in round order, then lane order) whose key equals cur[i] gives (found,
// start, deg). Rows at or past n, and misses, give (0, 0, 0).
//
// What bounds it on an H100: bytes. Per row it reads the key (4 B), one
// 32 B bucket row per round (two 16 B loads), 8 B of start/deg on a hit, and
// writes 9 B. The bucket tables are not staged in shared memory (no VMEM-like
// residency budget): a row's bucket is a random 32 B line in global memory,
// served by the 50 MB L2 when the table fits, else by HBM. One thread per
// row keeps the design simple; rows of a warp probe independent buckets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBucket = 8;

__global__ void probe_kernel(const int* __restrict__ bkey,
                             const int* __restrict__ bstart,
                             const int* __restrict__ bdeg,
                             const int* __restrict__ cur,
                             const int* __restrict__ n_ptr, int C,
                             unsigned int bmask, int max_probe,
                             bool* __restrict__ found,
                             int* __restrict__ start,
                             int* __restrict__ deg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  bool f = false;
  int s = 0, d = 0;
  if (i < *n_ptr) {
    const int key = cur[i];
    const unsigned int hb = ((unsigned int)key * 2654435761u) & bmask;
    for (int r = 0; r < max_probe && !f; ++r) {
      const unsigned int row = (hb + (unsigned int)r) & bmask;
      const int4* p = reinterpret_cast<const int4*>(bkey + (size_t)row * kBucket);
      const int4 a = __ldg(p);
      const int4 b = __ldg(p + 1);
      int lane = -1;
      if (a.x == key) lane = 0;
      else if (a.y == key) lane = 1;
      else if (a.z == key) lane = 2;
      else if (a.w == key) lane = 3;
      else if (b.x == key) lane = 4;
      else if (b.y == key) lane = 5;
      else if (b.z == key) lane = 6;
      else if (b.w == key) lane = 7;
      if (lane >= 0) {
        const size_t slot = (size_t)row * kBucket + lane;
        f = true;
        s = bstart[slot];
        d = bdeg[slot];
      }
    }
  }
  found[i] = f;
  start[i] = s;
  deg[i] = d;
}

}  // namespace

extern "C" int wk_probe(const int* bkey, const int* bstart, const int* bdeg,
                        const int* cur, const int* n_ptr, int C, int nb,
                        int max_probe, bool* found, int* start, int* deg,
                        cudaStream_t stream) {
  const int blocks = (C + kThreads - 1) / kThreads;
  probe_kernel<<<blocks, kThreads, 0, stream>>>(
      bkey, bstart, bdeg, cur, n_ptr, C, (unsigned int)(nb - 1), max_probe,
      found, start, deg);
  return (int)cudaGetLastError();
}

extern "C" const char* wk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
