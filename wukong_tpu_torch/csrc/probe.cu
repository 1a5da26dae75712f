// K1: 8-way bucketized hash probe of a frontier against a staged segment.
//
// Replaces wukong_tpu/engine/tpu_kernels.py:pallas_probe (the Pallas kernel
// that kept the three bucket arrays resident in VMEM). Contract: the plain
// version _hash_find in wukong_tpu_torch/engine/tpu_kernels.py. For each
// frontier row i < n: hb = (cur[i] * 2654435761 mod 2^32) & (NB - 1); probe
// rounds r = 0 .. max_probe-1 read bucket (hb + r) & (NB - 1); the first lane
// (in round order, then lane order) whose key equals cur[i] gives (found,
// start, deg). Rows at or past n, and misses, give (0, 0, 0). A key of -1
// meets the empty lanes (key -1, start 0, deg 0) like any other key.
//
// The staged table (device_store.line_table) is bline int32 [NB, 16], one
// 64 B line a bucket: its 8 keys, then the (start, deg) pairs of lanes 0-3;
// and bhi int2 [NB*4], the pairs of lanes 4-7. Placement fills lanes in
// order and buckets are sized for half load, so most hits sit in lanes 0-3.
//
// What bounds it on an H100: bytes. The function must read the key of each
// live row (4 B), each bucket's keys that some probe round reaches (32 B),
// the pair of each hit (8 B), and write found, start and deg over all C rows
// (9 B a row). The bucket reads are random; the frontier and the outputs
// stream. On a dense frontier (every key of a segment, about four rows a
// bucket) a table of tens of MB is read at random four times over, so what
// costs is the L2 misses and the DRAM bursts they take.
//
// The design:
// - One line a hit: a row loads its bucket's whole 64 B line (four 16 B
//   loads, one DRAM burst on a miss), so a hit in lanes 0-3 has its pair
//   with its keys: no dependent load and no second burst. A hit in lanes
//   4-7 loads its 8 B pair from bhi afterwards.
// - Memory-level parallelism: a thread owns kRows = 2 consecutive rows (a
//   group). It loads their keys with one 8 B load (scalar loads on the
//   ragged group at n), issues both line loads of a probe round before the
//   first compare, then both bhi loads.
// - The frontier is read, and the outputs written, with the streaming cache
//   hint (evict first), so they pass through the L2 without pushing out the
//   lines that later rows of the frontier probe.
// - Wide stores: a group writes its found bytes as one 2 B store and start
//   and deg as one 8 B store each; a warp writes 64 consecutive rows.
//   Groups past n load nothing and only store zeros (the capacity padding).
// - A persistent grid: as many blocks as fit on the card at once, striding
//   over the groups.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kBucket = 8;
constexpr int kRows = 2;
constexpr unsigned kHashMult = 2654435761u;
constexpr int kLineInts = 16;  // a bucket's 64 B line: 8 keys, 4 pairs
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
    probe_kernel(const int* __restrict__ table, const int2* __restrict__ pairs,
                 const int* __restrict__ cur, const int* __restrict__ n_ptr,
                 int C, unsigned bmask, int max_probe, bool vec_keys,
                 unsigned char* __restrict__ found, int* __restrict__ start,
                 int* __restrict__ deg) {
  const int n = max(0, min(__ldg(n_ptr), C));
  const int groups = (C + kRows - 1) / kRows;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += gridDim.x * kThreads) {
    const int base = g * kRows;
    int key[kRows];
    bool live[kRows];
    if (vec_keys && base + kRows <= n) {
      const int2 v = __ldcs(reinterpret_cast<const int2*>(cur + base));
      key[0] = v.x;
      key[1] = v.y;
#pragma unroll
      for (int j = 0; j < kRows; ++j) live[j] = true;
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        live[j] = base + j < n;
        key[j] = live[j] ? __ldcs(cur + base + j) : 0;
      }
    }
    unsigned hb[kRows];
    int slot[kRows];  // the int2 index of the hit's pair, or -1
    int s[kRows], d[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      hb[j] = ((unsigned)key[j] * kHashMult) & bmask;
      slot[j] = -1;
      s[j] = d[j] = 0;
    }
    bool f[kRows] = {};
    for (int r = 0; r < max_probe; ++r) {
      bool want[kRows];
      bool any = false;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        want[j] = live[j] && !f[j];
        any |= want[j];
      }
      if (!any) break;
      int4 a[kRows], b[kRows];  // the keys of lanes 0-3, 4-7
      int4 c[kRows], e[kRows];  // the pairs of lanes 0-1, 2-3
      unsigned row[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {  // every bucket load, then compares
        row[j] = (hb[j] + (unsigned)r) & bmask;
        if (want[j]) {
          const int4* p = reinterpret_cast<const int4*>(
              table + (size_t)row[j] * kLineInts);
          a[j] = __ldg(p);
          b[j] = __ldg(p + 1);
          c[j] = __ldg(p + 2);
          e[j] = __ldg(p + 3);
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (!want[j]) continue;
        const int k = key[j];
        int lane = -1;
        if (a[j].x == k) lane = 0;
        else if (a[j].y == k) lane = 1;
        else if (a[j].z == k) lane = 2;
        else if (a[j].w == k) lane = 3;
        else if (b[j].x == k) lane = 4;
        else if (b[j].y == k) lane = 5;
        else if (b[j].z == k) lane = 6;
        else if (b[j].w == k) lane = 7;
        if (lane < 0) continue;
        f[j] = true;
        if (lane < 4) {  // the pair came with the keys
          const int4 q = lane < 2 ? c[j] : e[j];
          s[j] = lane & 1 ? q.z : q.x;
          d[j] = lane & 1 ? q.w : q.y;
        } else {
          slot[j] = (int)row[j] * 4 + lane - 4;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {  // every pair load, then the stores
      if (slot[j] >= 0) {
        const int2 sd = __ldg(pairs + slot[j]);
        s[j] = sd.x;
        d[j] = sd.y;
      }
    }
    if (base + kRows <= C) {
      *reinterpret_cast<unsigned short*>(found + base) =
          (unsigned short)(f[0] | f[1] << 8);
      __stcs(reinterpret_cast<int2*>(start + base), make_int2(s[0], s[1]));
      __stcs(reinterpret_cast<int2*>(deg + base), make_int2(d[0], d[1]));
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (base + j < C) {
          found[base + j] = f[j];
          start[base + j] = s[j];
          deg[base + j] = d[j];
        }
      }
    }
  }
}

// blocks of probe_kernel that fit on device dev (the current one) at once
int resident_blocks(int dev) {
  static std::atomic<int> known[kMaxDevices];  // 0: not asked yet
  if (dev < kMaxDevices) {
    const int n = known[dev].load(std::memory_order_relaxed);
    if (n > 0) return n;
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_kernel,
                                                kThreads, 0);
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) known[dev].store(n, std::memory_order_relaxed);
  return n;
}

}  // namespace

// table (bline) and pairs (bhi) as above, nb buckets; start and deg must
// start on 8 B boundaries and found on a 2 B one; cur may sit anywhere 4 B
// aligned. dev is the device of every pointer and of the stream: it is made
// current for the launch (and the caller's current device restored), so the
// grid is sized for it and the launch runs there.
extern "C" int wk_probe(const int* table, const int* pairs, const int* cur,
                        const int* n_ptr, int C, int nb, int max_probe,
                        bool* found, int* start, int* deg, int dev,
                        cudaStream_t stream) {
  if (C <= 0) return (int)cudaGetLastError();
  int was = dev;
  cudaGetDevice(&was);
  if (was != dev) cudaSetDevice(dev);
  const long long groups = (C + kRows - 1) / kRows;
  const long long want = (groups + kThreads - 1) / kThreads;
  const long long fit = resident_blocks(dev);
  const unsigned blocks = (unsigned)(want < fit ? want : fit);
  // a group's keys are one 8 B load where cur allows it
  const bool vec_keys = reinterpret_cast<uintptr_t>(cur) % 8 == 0;
  probe_kernel<<<blocks, kThreads, 0, stream>>>(
      table, reinterpret_cast<const int2*>(pairs), cur, n_ptr, C,
      (unsigned)(nb - 1), max_probe, vec_keys,
      reinterpret_cast<unsigned char*>(found), start, deg);
  const int rc = (int)cudaGetLastError();
  if (was != dev) cudaSetDevice(was);
  return rc;
}

extern "C" const char* wk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
