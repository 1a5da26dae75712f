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
// cursor. A search of n sorted values converges after bit_length(n)
// iterations; iterations after the range is empty change nothing. So where
// depth_j >= bit_length(n) the answer is "cand[i] is in the run", and
// where it is not the search stops short exactly as the plain version's
// does: the result is the plain version's bit for bit, for any order of
// the candidates and anchors (each row's answer depends on its own inputs
// alone; the sharing below only saves loads).
//
// int32 throughout (ids and offsets range-checked by the wrapper's caller,
// to_device_i32), with the midpoint lo + (hi - lo) / 2: lo + hi overflows
// past 2^30 edges (the note at wukong_tpu/join/kernels.py pair_member).
//
// What bounds it on an H100: bytes. The function must read valid, cand and
// each adjacency's anchors once (1 + 4 + 4J B a row) and write the mask
// (1 B a row): 5 us for the 2 M candidates of LUBM-640 q1's WCOJ level 1.
// The earlier design (one thread a candidate, each search a chain of
// dependent loads from the top of its array) took 0.14 ms there. The top
// steps of the searches are shared by the lanes of a warp and hit the
// caches; their last steps read a sector a lane, and the card serves such
// scattered sectors at a fixed rate whatever the number of searches in
// flight (a splitter table of the glob in shared memory, tried first, kept
// them and saved nothing; PERF.md §6). So from kSmallC (2^21) candidates
// up, the tiled kernel reads one word a value where it can:
//   - dense indices. Word w of a sorted unique array's index covers 32 ids:
//     their bits, and the position of the first. A glob test is then one
//     8-byte read, a key's rank one read and a popcount. The glob's index
//     is built each call by two pre-passes (the words cleared, then a
//     thread a value: the lanes of a warp that share a word OR their bits
//     into one atomic) in scratch the wrapper gives (nglob + 64 words, when
//     the glob holds at most C values); a keys table's is built the same
//     way once, when the table is staged (wk_level_probe_build_index), and
//     passed with it. Each is built only where its span fits its words (4
//     nkeys + 64 for keys), so a sparse array keeps the search.
//   - lanes still true that carry the same anchor side by side (a run of
//     equal anchors among true lanes, as a WCOJ prefix row's or a template
//     source row's candidates arrive) let the first of them look the key up
//     and read its offsets once; the others take (start, end) by shuffle. A
//     run of at most kRun edges that depth_j iterations would search to the
//     end is compared value by value (its loads independent, the anchor's
//     lanes reading the same addresses) in place of depth_j dependent loads;
//     a longer run, or a depth too small for it, keeps the depth-limited
//     search from the shared (start, end).
//   - each lane carries kR = 2 candidates, their searches' reads
//     interleaved, and a warp takes kTile = 64 at a time: a tile of padding
//     (most of a template's capacity) is one load and one store a lane, its
//     valid bytes read a tile ahead.
// A smaller tensor (the cyclic worlds, WatDiv's probes: a few microseconds
// of card time under tens of the wrapper's) takes the earlier design, a
// thread a candidate and no prologue, so that every search is in flight at
// once; the tiled kernel's set-up cost more there than it saved.
// Up to kMaxAdj adjacency descriptors a launch, passed by value in the
// kernel's parameters; the wrapper chains launches past that over the mask.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr unsigned kFull = 0xffffffffu;

constexpr int kMaxAdj = 8;
constexpr int kSmallC = 1 << 21;  // below: a thread a candidate
constexpr int kSmallThreads = 256;
constexpr int kThreads = 512;  // the tiled kernel's block
constexpr int kR = 2;          // candidates a lane a turn
constexpr int kTile = 64;      // candidates a warp a tile
constexpr int kRun = 32;       // runs compared value by value
constexpr int kMaxDevices = 64;

}  // namespace

// one adjacency: a CSR (keys sorted unique, nkeys + 1 offsets, edges sorted
// within each key's run), the anchor of every candidate, and the keys'
// dense index (null: none) of nindex words
struct WkAdj {
  const int* keys;
  const int* offsets;
  const int* edges;
  const int* anchors;
  const uint2* index;
  int nkeys;
  int nedges;
  int depth;
  int nindex;
};

namespace {

struct AdjPack {
  WkAdj a[kMaxAdj];
  int n;
};

// the glob and the scratch for its dense index (null: none)
struct Glob {
  const int* glob;
  uint2* index;
  int nglob;
  int has;
  long long cap;
};

// a sorted unique int array's dense index: word w covers the values
// 32 (w0 + w) .. + 31, its x a bit a value, its y the position of its first
// value (so the rank of a value present is y + the bits below it). It is
// built, and read, only where it takes at most cap words: w0 and nw are
// the index's first word and word count (nw = 0: no index).
__device__ __forceinline__ void dense_span(const int* vals, int n,
                                           long long cap, const uint2* words,
                                           long long* w0, int* nw) {
  *w0 = 0;
  *nw = 0;
  if (words == nullptr || n <= 0) return;
  const long long first = __ldg(vals) >> 5;
  const long long span = (__ldg(vals + n - 1) >> 5) - first + 1;
  if (span <= cap) {
    *w0 = first;
    *nw = (int)span;
  }
}

__device__ __forceinline__ int top_step(int n) {
  return n > 0 ? 1 << (31 - __clz(n)) : 0;
}

// ---- the per-thread kernel (C < kSmallC) --------------------------------

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

// the edge anchor -> v, searched depth times over the anchor's run
__device__ __forceinline__ bool run_search(const WkAdj& adj, int lo, int hi,
                                           int v) {
  const int ne = adj.nedges;
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

__device__ __forceinline__ bool pair_member(const WkAdj& adj, int anchor,
                                            int v) {
  if (adj.nedges <= 0) return false;
  int lo = 0, hi = 0;
  if (adj.nkeys > 0) {
    const int k = lower_bound(adj.keys, adj.nkeys, anchor);
    if (k < adj.nkeys && __ldg(adj.keys + k) == anchor) {
      lo = __ldg(adj.offsets + k);
      hi = __ldg(adj.offsets + k + 1);
    }
  }
  return run_search(adj, lo, hi, v);
}

__global__ void __launch_bounds__(kSmallThreads)
    level_probe_small(const unsigned char* valid,
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

// ---- the tiled kernel (C >= kSmallC) ------------------------------------

// glob membership of each slot still true: one word of the dense index,
// or the count of glob values <= v (branchless halving steps, the slots'
// reads interleaved): v is in the glob iff the largest value <= v is v
__device__ __forceinline__ void glob_members(const Glob& g, long long w0,
                                             int nw, const int (&v)[kR],
                                             bool (&ok)[kR]) {
  if (nw > 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const long long w = (v[r] >> 5) - w0;
      ok[r] = ok[r] && w >= 0 && w < nw &&
              ((__ldg(&g.index[w]).x >> (v[r] & 31)) & 1u);
    }
    return;
  }
  int t[kR], last[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    t[r] = 0;
    last[r] = 0;
  }
  for (int step = top_step(g.nglob); step > 0; step >>= 1) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int at = t[r] + step;
      if (ok[r] && at <= g.nglob) {
        const int x = __ldg(g.glob + at - 1);
        if (x <= v[r]) {
          t[r] = at;
          last[r] = x;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) ok[r] = ok[r] && t[r] > 0 && last[r] == v[r];
}

// the edge anchor -> v, given the anchor's run [lo, hi) (empty: absent key)
__device__ __forceinline__ bool run_member(const WkAdj& adj, int lo, int hi,
                                           int v) {
  const int n = hi - lo;
  if (n <= 0) return false;
  if (n <= kRun && 32 - __clz(n) <= adj.depth) {
    // depth iterations converge: v is found iff it is in the sorted run
    bool hit = false;
#pragma unroll 4
    for (int t = lo; t < hi; ++t) hit |= __ldg(adj.edges + t) == v;
    return hit;
  }
  return run_search(adj, lo, hi, v);
}

// one adjacency over the slots still true: the lanes of a slot that carry
// one anchor side by side let the first of them look the key up (the
// leaders' lookups of all slots interleaved) and read the key's offsets,
// and take its run by shuffle
__device__ __forceinline__ void pair_members(const WkAdj& adj, long long w0,
                                             int nw,
                                             const long long (&i)[kR],
                                             const int (&v)[kR],
                                             bool (&ok)[kR], int lane) {
  int a[kR], leader[kR], kt[kR], klast[kR], lo[kR], hi[kR];
  bool lead[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    a[r] = ok[r] ? __ldg(adj.anchors + i[r]) : 0;
    kt[r] = 0;
    klast[r] = 0;
    const int before = __shfl_up_sync(kFull, a[r], 1);
    const bool ok_before = __shfl_up_sync(kFull, ok[r] ? 1 : 0, 1) != 0;
    lead[r] = ok[r] && (lane == 0 || !ok_before || before != a[r]);
    const unsigned starts = __ballot_sync(kFull, lead[r]);
    // the last run start at or below this lane (a true lane has one)
    leader[r] = 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
  }
  if (nw > 0) {  // the key's rank from one word of the dense index
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const long long w = (a[r] >> 5) - w0;
      if (lead[r] && w >= 0 && w < nw) {
        const uint2 p = __ldg(&adj.index[w]);
        const unsigned below = (1u << (a[r] & 31)) - 1u;
        if ((p.x >> (a[r] & 31)) & 1u) {
          kt[r] = (int)p.y + __popc(p.x & below) + 1;
          klast[r] = a[r];
        }
      }
    }
  } else {
    for (int step = top_step(adj.nkeys); step > 0; step >>= 1) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int at = kt[r] + step;
        if (lead[r] && at <= adj.nkeys) {
          const int x = __ldg(adj.keys + at - 1);
          if (x <= a[r]) {
            kt[r] = at;
            klast[r] = x;
          }
        }
      }
    }
  }
  int e0[kR];  // a run of one edge: the leader reads it for its lanes
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    lo[r] = 0;
    hi[r] = 0;
    e0[r] = 0;
    if (lead[r] && kt[r] > 0 && klast[r] == a[r]) {
      lo[r] = __ldg(adj.offsets + kt[r] - 1);
      hi[r] = __ldg(adj.offsets + kt[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (lead[r] && hi[r] - lo[r] == 1) e0[r] = __ldg(adj.edges + lo[r]);
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int src = leader[r] & 31;
    lo[r] = __shfl_sync(kFull, lo[r], src);
    hi[r] = __shfl_sync(kFull, hi[r], src);
    e0[r] = __shfl_sync(kFull, e0[r], src);
    if (ok[r]) {
      // one edge: one search step (depth >= 1) lands on it
      ok[r] = hi[r] - lo[r] == 1 ? v[r] == e0[r]
                                 : run_member(adj, lo[r], hi[r], v[r]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    level_probe_tiled(const unsigned char* valid,
                      const int* __restrict__ cand, int C, const Glob g,
                      const AdjPack pack, unsigned char* mask) {
  static_assert(kTile % (32 * kR) == 0 && kTile / 32 == 2,
                "a tile is whole turns, 2 valid bytes a lane");
  __shared__ long long s_w0[kMaxAdj + 1];
  __shared__ int s_nw[kMaxAdj + 1];
  if (threadIdx.x <= pack.n) {  // 0: the glob, 1 + j: adjacency j's keys
    const int x = threadIdx.x;
    if (x == 0) {
      dense_span(g.glob, g.has ? g.nglob : 0, g.cap, g.index, &s_w0[0],
                 &s_nw[0]);
    } else {
      const WkAdj& adj = pack.a[x - 1];
      dense_span(adj.keys, adj.nkeys, adj.nindex, adj.index, &s_w0[x],
                 &s_nw[x]);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // a warp takes kTile candidates at a time, 2 valid bytes a lane: a tile
  // of padding is one 2-byte load and one store a lane; any other goes in
  // turns of 32 kR
  const bool wide =
      ((reinterpret_cast<uintptr_t>(valid) | reinterpret_cast<uintptr_t>(mask))
       & 1) == 0;
  const long long stride = (long long)gridDim.x * (kThreads / 32) * kTile;
  // a tile's valid bytes are read a tile ahead, so a run of padding tiles
  // does not wait a load each
  auto live_of = [&](long long t) {
    if (!wide || t + kTile > C) return true;  // checked in its turns
    return *reinterpret_cast<const unsigned short*>(valid + t + 2 * lane) !=
           0;
  };
  long long tile =
      ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kTile;
  bool live_next = tile < C ? live_of(tile) : false;
  for (; tile < C; tile += stride) {
    const bool live = live_next;
    if (tile + stride < C) live_next = live_of(tile + stride);
    if (wide && tile + kTile <= C && !__any_sync(kFull, live)) {
      *reinterpret_cast<unsigned short*>(mask + tile + 2 * lane) = 0;
      continue;
    }
    for (int sub = 0; sub < kTile && tile + sub < C; sub += 32 * kR) {
      const long long base = tile + sub;
      long long i[kR];
      bool in[kR], ok[kR];
      int v[kR];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        i[r] = base + 32 * r + lane;
        in[r] = i[r] < C;
        ok[r] = in[r] && valid[i[r]] != 0;
        any |= ok[r];
      }
      if (__any_sync(kFull, any)) {  // a turn of padding writes zeros only
#pragma unroll
        for (int r = 0; r < kR; ++r) v[r] = ok[r] ? __ldg(cand + i[r]) : 0;
        if (g.has) {
          if (g.nglob > 0) {
            glob_members(g, s_w0[0], s_nw[0], v, ok);
          } else {
#pragma unroll
            for (int r = 0; r < kR; ++r) ok[r] = false;
          }
        }
        for (int j = 0; j < pack.n; ++j) {
          any = false;
#pragma unroll
          for (int r = 0; r < kR; ++r) any |= ok[r];
          if (!__any_sync(kFull, any)) break;
          const WkAdj& adj = pack.a[j];
          if (adj.nedges <= 0) {
#pragma unroll
            for (int r = 0; r < kR; ++r) ok[r] = false;
          } else {
            pair_members(adj, s_w0[j + 1], s_nw[j + 1], i, v, ok, lane);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (in[r]) mask[i[r]] = ok[r] ? 1 : 0;
      }
    }
  }
}

// ---- the dense index's build --------------------------------------------

struct Dense {
  const int* vals;
  uint2* words;
  int n;
  long long cap;
};

__global__ void dense_clear(const Dense d) {
  long long w0;
  int nw;
  dense_span(d.vals, d.n, d.cap, d.words, &w0, &nw);
  const int stride = gridDim.x * blockDim.x;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < nw; t += stride) {
    d.words[t] = make_uint2(0u, 0u);
  }
}

// the bits set, a thread a value: the lanes of a warp whose values share a
// word OR their bits into one atomic, and the first value of each word
// writes its position
__global__ void dense_fill(const Dense d) {
  long long w0;
  int nw;
  dense_span(d.vals, d.n, d.cap, d.words, &w0, &nw);
  if (nw == 0) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < d.n;
  const int x = in ? __ldg(d.vals + i) : 0;
  const long long w = in ? (x >> 5) - w0 : -1;
  const unsigned peers = __match_any_sync(kFull, w);
  const unsigned bits = __reduce_or_sync(peers, in ? 1u << (x & 31) : 0u);
  if (!in) return;
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicOr(&d.words[w].x, bits);
  if (i == 0 || (__ldg(d.vals + i - 1) >> 5) - w0 != w) {
    d.words[w].y = (unsigned)i;
  }
}

// the index of d built on the stream where its span fits its cap words
void build_dense(const Dense& d, cudaStream_t stream) {
  const int tb = 256;
  const long long cx = (d.cap + tb - 1) / tb;
  dense_clear<<<(unsigned)(cx < 1024 ? cx : 1024), tb, 0, stream>>>(d);
  dense_fill<<<(unsigned)((d.n + tb - 1) / tb), tb, 0, stream>>>(d);
}

// blocks of kernel k (0: the per-thread kernel, 1: the tiled one) that fit
// on device dev at once
template <typename K>
int resident_blocks(K kernel, int k, int threads, int dev) {
  static std::atomic<int> known[2][kMaxDevices];  // 0: not asked yet
  if (dev < kMaxDevices) {
    const int n = known[k][dev].load(std::memory_order_relaxed);
    if (n > 0) return n;
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int n = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) known[k][dev].store(n, std::memory_order_relaxed);
  return n;
}

}  // namespace

extern "C" int wk_level_probe_max_adj() { return kMaxAdj; }

// uint64 words of scratch for the glob's dense index that wk_level_probe
// takes for C candidates and a glob of nglob values: nglob + 64 where the
// tiled kernel runs (C >= 2^21) and the glob holds at most C values, else 0
extern "C" long long wk_level_probe_glob_words(int C, int nglob) {
  return C >= kSmallC && nglob > 0 && nglob <= C ? (long long)nglob + 64 : 0;
}

// uint64 words of the dense index of a sorted unique int32 array of n
// values from first to last (its span), or 0 where that is more than
// 4 n + 64 (a sparse array is searched instead)
extern "C" long long wk_level_probe_index_words(long long first,
                                                long long last, int n) {
  if (n <= 0) return 0;
  const long long span = (last >> 5) - (first >> 5) + 1;
  return span <= 4ll * n + 64 ? span : 0;
}

// build the dense index of the sorted unique int32 vals[0 .. n) on dev
// into words (nw = wk_level_probe_index_words of it), queued on stream
extern "C" int wk_level_probe_build_index(const int* vals, int n, void* words,
                                          long long nw, int dev,
                                          cudaStream_t stream) {
  if (n <= 0 || nw <= 0) return (int)cudaErrorInvalidValue;
  int was = dev;
  cudaGetDevice(&was);
  if (was != dev) cudaSetDevice(dev);
  build_dense(Dense{vals, static_cast<uint2*>(words), n, nw}, stream);
  const int rc = (int)cudaGetLastError();
  if (was != dev) cudaSetDevice(was);
  return rc;
}

// valid and mask are C bytes (bool), cand C int32; glob nglob int32 (read
// only when has_glob); gindex: gwords uint64 of scratch for the glob's
// dense index (wk_level_probe_glob_words; null when 0); adjs[0 .. J) host
// descriptors of device tables with J <= kMaxAdj, each anchors array C
// int32, each index a dense index of its keys (or null). mask may alias
// valid. dev is the device of every pointer and of the stream: it is made
// current for the launches (and the caller's current device restored).
extern "C" int wk_level_probe(const unsigned char* valid, const int* cand,
                              int C, const int* glob, int nglob, int has_glob,
                              void* gindex, long long gwords,
                              const WkAdj* adjs, int J, unsigned char* mask,
                              int dev, cudaStream_t stream) {
  if (C <= 0) return (int)cudaGetLastError();
  if (J < 0 || J > kMaxAdj || nglob < 0) return (int)cudaErrorInvalidValue;
  AdjPack pack;
  pack.n = J;
  for (int j = 0; j < J; ++j) pack.a[j] = adjs[j];
  int was = dev;
  cudaGetDevice(&was);
  if (was != dev) cudaSetDevice(dev);
  if (C < kSmallC) {
    const long long want = (C + kSmallThreads - 1) / kSmallThreads;
    const long long fit =
        resident_blocks(level_probe_small, 0, kSmallThreads, dev);
    level_probe_small<<<(unsigned)(want < fit ? want : fit), kSmallThreads,
                        0, stream>>>(valid, cand, C, glob, nglob, has_glob,
                                     pack, mask);
  } else {
    Glob g;
    g.glob = glob;
    g.nglob = has_glob ? nglob : 0;
    g.has = has_glob != 0;
    g.index = has_glob && gwords > 0 ? static_cast<uint2*>(gindex) : nullptr;
    g.cap = gwords;
    if (g.index != nullptr && g.nglob > 0) {
      build_dense(Dense{glob, g.index, g.nglob, g.cap}, stream);
    }
    const long long want = ((long long)C + (kThreads / 32) * kTile - 1) /
                           ((long long)(kThreads / 32) * kTile);
    const long long fit = resident_blocks(level_probe_tiled, 1, kThreads, dev);
    level_probe_tiled<<<(unsigned)(want < fit ? want : fit), kThreads, 0,
                        stream>>>(valid, cand, C, g, pack, mask);
  }
  const int rc = (int)cudaGetLastError();
  if (was != dev) cudaSetDevice(was);
  return rc;
}

extern "C" const char* wk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
