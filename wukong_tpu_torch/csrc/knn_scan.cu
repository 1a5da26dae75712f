// The k-NN scan: masked similarity scores of candidate rows against one
// anchor, and their top k, in one call.
//
// Replaces the XLA program wukong_tpu/vector/knn.py:_jit_scan (knn.py:118-130,
// masked scores then jax.lax.top_k) and the selection of topk_device
// (knn.py:133-162). Contract: the plain version knn_scan_plain in
// wukong_tpu_torch/vector/knn.py. For the m candidates (rows lo .. lo + m of
// the [n, d] float32 block, or the rows slots[0 .. m) of an int64 slot list)
// and the float32 anchor q[d]:
//
//   dot:    s = q.b
//   cosine: s = q.b / (max(|q|, 1e-12) * max(|b|, 1e-12))
//   l2:     s = -((q.q - 2 q.b) + b.b)
//   s = -inf where the row is dead (alive[row] == 0)
//
// then the kk = min(k, m) largest in the total order (score desc, candidate
// position asc) — lax.top_k's order, which keeps the lower index on a tie —
// written as out_scores[kk] (float32) and out_idx[kk] (int64 candidate
// positions), in that order. A score of -0.0 is written as +0.0 (they
// compare equal, so ties among zeros break by position). Inputs are NaN-free.
//
// Each candidate becomes one 64-bit key: the order-preserving bits of its
// float score above the inverted position, so the largest keys are the
// answer and keys are unique (the result does not depend on which block or
// warp saw a key first). Three paths:
//   k <= 32 (the main path: GraphRAG slices at k = 8, whole-block scans at
//     k = 10): one launch. A block scores a contiguous chunk of rows (a
//     group of L lanes a row, 16-byte loads when d % 4 == 0, a shuffle
//     reduction, kRowsPerIter rows in flight a group) and each warp keeps
//     its own top k in registers, one key a lane, sorted across the lanes:
//     a key above the warp's k-th best is inserted by a ballot (its rank)
//     and a shuffle up (no shared memory, no block barrier in the scan
//     loop). The block merges its 8 warps' lists (a bitonic merge of two
//     lane-sorted lists: a mirror compare and five compare-exchange
//     shuffles), writes its k keys to the scratch, and the last block to
//     finish (an atomic ticket after a __threadfence) offers every block's
//     keys to its 8 warps (kMergeLoads reads in flight a lane), merges them,
//     writes the answer and sets the ticket back to 0 for the next call on
//     the stream.
//   32 < k <= 256: one launch, the same ticket. A block keeps its top k in
//     shared memory: keys above its current k-th best go to a buffer, and
//     when it fills the top region and the filled part of the buffer are
//     sorted (a bitonic sort over the filled length rounded up to a power
//     of two, never the whole buffer). The last block merges every block's
//     k keys through the same buffer.
//   k > 256 (up to m, as lax.top_k allows any k up to the capacity): the keys
//     of all m candidates go to scratch, an 8-pass radix select (8 bits a
//     pass, MSB first, a device histogram and a one-thread digit pick) finds
//     the k-th largest key, the keys at or above it (exactly k) are
//     compacted, and a bitonic sort in device memory orders them.
//
// What bounds it on an H100: bytes. The function must read the m rows
// (m d 4 B), the mask and the slot list once; the operations (2 m d fp32
// flops, 4 m d for cosine and l2) are about 2 flops a byte, far below the
// card's 67 TFLOP/s fp32 over 3.35 TB/s (20 flops a byte). On a GraphRAG
// slice (m = 65,120, d = 64: 16.7 MB, 5 us of bytes) the earlier design
// lost its time around the scan: a bitonic sort of 2,048 shared keys a
// block (66 barriers) for at most 256 live ones, and a second one-block
// launch that sorted 2,048 keys twice while the card idled. So the grid is
// sized by bytes: a block takes at least kBlockBytes of rows (2 turns of
// its loop at d = 64, so its 16-byte loads pipeline), and never more blocks
// than fit on the card at once (the slice class runs in one wave, 509
// blocks; a whole-block scan strides as before, one wave of blocks each
// over a contiguous chunk). Timed on the slice and the whole block, larger
// and smaller blocks, and 8 rows in flight a group in place of 4, were
// slower. The radix path writes and reads the m keys (8 B a candidate)
// nine times more; at d = 64 that is about a quarter more traffic than the
// rows, paid only when k > 256.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef unsigned long long u64;  // the shuffle and __ldcg overloads' type

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpK = 32;             // the register path's largest k
constexpr int kMaxK = 256;             // the block paths' largest k
constexpr int kBuf = 2048;             // shared keys: top region + buffer
constexpr int kRowsPerIter = 4;        // rows a lane group has in flight
constexpr long long kBlockBytes = 32 << 10;  // a block's least rows
constexpr int kMergeLoads = 8;         // the last block's reads in flight
constexpr int kMidBlocks = 128;        // 32 < k: the last block merges
                                       // at most 128 k keys
constexpr int kMaxDevices = 64;
constexpr int kMaxDim = 4096;          // the anchor in 16 KB of shared memory
constexpr int kStateWords = 4;         // prefix, mask, remaining, count
constexpr int kHistWords = 128;        // 256 uint32 bins

enum { kDot = 0, kCosine = 1, kL2 = 2 };

struct Scan {
  const float* base;
  const unsigned char* alive;
  const long long* slots;  // null: rows lo .. lo + m
  long long lo;
  long long m;
  int d;
  int metric;
  int lanes;  // L, a power of two <= 32
};

// where a block path writes: every block's k keys, the ticket, the answer
struct Out {
  u64* cand;     // gridDim.x * k keys
  unsigned* ticket;   // 0 between calls
  float* out_s;
  long long* out_i;
};

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  const uint32_t u = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ u64 make_key(float s, long long i) {
  return ((u64)ordered_bits(s) << 32) |
         (u64)(0xFFFFFFFFu - (uint32_t)i);
}

__device__ __forceinline__ void decode(u64 key, float* s,
                                       long long* idx) {
  *s = from_ordered((uint32_t)(key >> 32));
  *idx = (long long)(0xFFFFFFFFu - (uint32_t)key);
}

// the anchor into shared memory and q.q (warp 0, in a fixed order, so
// every block computes the same value)
__device__ __forceinline__ void load_anchor(const float* __restrict__ anchor,
                                            int d, float* s_q, float* s_qq) {
  for (int c = threadIdx.x; c < d; c += blockDim.x) s_q[c] = __ldg(anchor + c);
  if (threadIdx.x < 32) {
    float qq = 0.f;
    for (int c = threadIdx.x; c < d; c += 32) {
      const float x = __ldg(anchor + c);
      qq = fmaf(x, x, qq);
    }
    for (int off = 16; off > 0; off >>= 1) {
      qq += __shfl_xor_sync(kFull, qq, off);
    }
    if (threadIdx.x == 0) *s_qq = qq;
  }
  __syncthreads();
}

// the key of candidate i, computed by the L lanes of its group (every lane
// of the warp calls this, valid or not, for the shuffles); every lane of
// the group gets it
__device__ __forceinline__ u64 candidate_key(const Scan& p,
                                                  const float* s_q, float qq,
                                                  long long i, bool valid,
                                                  int lane) {
  float qb = 0.f, bb = 0.f;
  long long row = 0;
  if (valid) {
    row = p.slots ? __ldg(p.slots + i) : p.lo + i;
    const float* b = p.base + row * (long long)p.d;
    if ((p.d & 3) == 0) {
      const float4* b4 = reinterpret_cast<const float4*>(b);
      const float4* q4 = reinterpret_cast<const float4*>(s_q);
      for (int c = lane; c < (p.d >> 2); c += p.lanes) {
        const float4 x = __ldg(b4 + c);
        const float4 y = q4[c];
        qb = fmaf(x.x, y.x, qb);
        qb = fmaf(x.y, y.y, qb);
        qb = fmaf(x.z, y.z, qb);
        qb = fmaf(x.w, y.w, qb);
        bb = fmaf(x.x, x.x, bb);
        bb = fmaf(x.y, x.y, bb);
        bb = fmaf(x.z, x.z, bb);
        bb = fmaf(x.w, x.w, bb);
      }
    } else {
      for (int c = lane; c < p.d; c += p.lanes) {
        const float x = __ldg(b + c);
        qb = fmaf(x, s_q[c], qb);
        bb = fmaf(x, x, bb);
      }
    }
  }
  for (int off = p.lanes >> 1; off > 0; off >>= 1) {
    qb += __shfl_xor_sync(kFull, qb, off);
    bb += __shfl_xor_sync(kFull, bb, off);
  }
  if (!valid) return 0;  // below every real key
  float s;
  if (p.metric == kDot) {
    s = qb;
  } else if (p.metric == kCosine) {
    s = qb / (fmaxf(sqrtf(qq), 1e-12f) * fmaxf(sqrtf(bb), 1e-12f));
  } else {
    s = -((qq - 2.0f * qb) + bb);
  }
  s = __ldg(p.alive + row) ? s + 0.0f : -INFINITY;
  return make_key(s, i);
}

// ---- the register path (k <= 32) -------------------------------------------

// a warp's top k: lane j holds its j-th largest key (0: none yet); thr is
// lane k - 1's. Every lane calls this; the keys of the lanes with ``mine``
// set are offered, largest rank first found by a ballot, one at a time.
__device__ __forceinline__ void warp_offer(u64 key, bool mine,
                                           u64& list, u64& thr,
                                           int k, int lane) {
  unsigned want = __ballot_sync(kFull, mine && key > thr);
  while (want) {
    const int src = __ffs(want) - 1;
    const u64 x = __shfl_sync(kFull, key, src);
    const int pos = __popc(__ballot_sync(kFull, list > x));
    const u64 up = __shfl_up_sync(kFull, list, 1);
    list = lane < pos ? list : (lane == pos ? x : up);
    thr = __shfl_sync(kFull, list, k - 1);
    want &= ~(1u << src);
    want &= __ballot_sync(kFull, mine && key > thr);
  }
}

// the 32 largest of two lane-sorted lists (lane 0 the largest): the
// larger of each key and its mirror in the other list form a bitonic
// sequence that holds them, sorted by five compare-exchange shuffles
__device__ __forceinline__ u64 warp_merge(u64 list, u64 other, int lane) {
  const u64 mirror = __shfl_sync(kFull, other, 31 - lane);
  u64 c = list > mirror ? list : mirror;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const u64 o = __shfl_xor_sync(kFull, c, s);
    const bool high = (lane & s) == 0;  // the lower lane keeps the larger
    c = high == (c > o) ? c : o;
  }
  return c;
}

// the block's warps' lists merged into warp 0's (every thread calls it)
__device__ __forceinline__ void block_merge_lists(u64* s_lists,
                                                  u64& list,
                                                  u64& thr, int k,
                                                  int warp, int lane) {
  s_lists[warp * 32 + lane] = list;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kWarps; ++w) {
      list = warp_merge(list, s_lists[w * 32 + lane], lane);
    }
    thr = __shfl_sync(kFull, list, k - 1);
  }
}

// true in the last block to finish (every thread calls it, after the
// block's keys are written): each writer's keys are visible on the card
// before the block takes its ticket, so the last block reads them all
__device__ __forceinline__ bool last_block(unsigned* ticket, int* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  return *s_last != 0;
}

__global__ void __launch_bounds__(kThreads)
    knn_warp_topk(const Scan p, const float* __restrict__ anchor, int k,
                  long long per_block, Out o) {
  extern __shared__ float4 s_q4[];
  float* s_q = reinterpret_cast<float*>(s_q4);
  __shared__ u64 s_lists[kWarps * 32];
  __shared__ float s_qq;
  __shared__ int s_last;
  load_anchor(anchor, p.d, s_q, &s_qq);
  const float qq = s_qq;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int groups = kThreads / p.lanes;
  const int group = threadIdx.x / p.lanes;
  const int glane = threadIdx.x % p.lanes;
  const bool owner = glane == 0;
  const long long start = (long long)blockIdx.x * per_block;
  const long long end = start + per_block < p.m ? start + per_block : p.m;
  const int step = groups * kRowsPerIter;
  u64 list = 0, thr = 0;
  for (long long b0 = start; b0 < end; b0 += step) {
    u64 keys[kRowsPerIter];
#pragma unroll
    for (int j = 0; j < kRowsPerIter; ++j) {
      const long long i = b0 + group + (long long)j * groups;
      keys[j] = candidate_key(p, s_q, qq, i, i < end, glane);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerIter; ++j) {
      warp_offer(keys[j], owner, list, thr, k, lane);
    }
  }
  block_merge_lists(s_lists, list, thr, k, warp, lane);
  if (gridDim.x > 1) {
    if (warp == 0 && lane < k) o.cand[(long long)blockIdx.x * k + lane] = list;
    if (!last_block(o.ticket, &s_last)) return;
    // the last block: every block's k keys, 8 warps each taking every
    // 8th run of 32, four loads in flight
    list = 0;
    thr = 0;
    const int n = gridDim.x * k;
    for (int b = warp * 32; b < n; b += kMergeLoads * kThreads) {
      u64 x[kMergeLoads];
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {
        const int i = b + u * kThreads + lane;
        x[u] = i < n ? __ldcg(o.cand + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < kMergeLoads; ++u) {
        warp_offer(x[u], true, list, thr, k, lane);
      }
    }
    __syncthreads();  // every warp has read s_lists' last use
    block_merge_lists(s_lists, list, thr, k, warp, lane);
    if (threadIdx.x == 0) *o.ticket = 0u;  // every block has taken its ticket
  }
  if (warp == 0 && lane < k) decode(list, o.out_s + lane, o.out_i + lane);
}

// ---- the shared-buffer path (32 < k <= 256) --------------------------------

// sort s_keys[0 .. n) descending, n a power of two (every thread calls it)
__device__ void bitonic_shared(u64* s_keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool desc = (i & size) == 0;
        const u64 a = s_keys[i], b = s_keys[j];
        if (desc ? (a < b) : (a > b)) {
          s_keys[i] = b;
          s_keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// fold the buffer s_keys[k .. k + cnt) into the top region: after it
// s_keys[0 .. k) are the k largest keys seen, descending, and *s_thr the
// k-th (0 while fewer). Sorts the filled length rounded up to a power of 2.
__device__ void merge_buffer(u64* s_keys, int* s_cnt, u64* s_thr,
                             int k) {
  const int n = k + *s_cnt;
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  __syncthreads();  // every thread has read the count
  for (int i = n + threadIdx.x; i < p2; i += blockDim.x) s_keys[i] = 0;
  __syncthreads();
  bitonic_shared(s_keys, p2);
  if (threadIdx.x == 0) {
    *s_cnt = 0;
    *s_thr = s_keys[k - 1];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    knn_buf_topk(const Scan p, const float* __restrict__ anchor, int k,
                 long long per_block, Out o) {
  extern __shared__ float4 s_q4[];
  float* s_q = reinterpret_cast<float*>(s_q4);
  __shared__ u64 s_keys[kBuf];
  __shared__ u64 s_thr;
  __shared__ int s_cnt;
  __shared__ float s_qq;
  __shared__ int s_last;
  const int cap = kBuf - k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) s_keys[i] = 0;
  if (threadIdx.x == 0) {
    s_cnt = 0;
    s_thr = 0;
  }
  load_anchor(anchor, p.d, s_q, &s_qq);
  const float qq = s_qq;
  const int groups = kThreads / p.lanes;
  const int group = threadIdx.x / p.lanes;
  const int lane = threadIdx.x % p.lanes;
  const long long start = (long long)blockIdx.x * per_block;
  const long long end = start + per_block < p.m ? start + per_block : p.m;
  const int step = groups * kRowsPerIter;
  for (long long b0 = start; b0 < end; b0 += step) {
    u64 keys[kRowsPerIter];
#pragma unroll
    for (int j = 0; j < kRowsPerIter; ++j) {
      const long long i = b0 + group + (long long)j * groups;
      keys[j] = candidate_key(p, s_q, qq, i, i < end, lane);
    }
    if (lane == 0) {
      const u64 thr = s_thr;
#pragma unroll
      for (int j = 0; j < kRowsPerIter; ++j) {
        if (keys[j] > thr) s_keys[k + atomicAdd(&s_cnt, 1)] = keys[j];
      }
    }
    __syncthreads();
    if (s_cnt > cap - step) merge_buffer(s_keys, &s_cnt, &s_thr, k);
  }
  __syncthreads();
  if (s_cnt > 0) merge_buffer(s_keys, &s_cnt, &s_thr, k);
  if (gridDim.x > 1) {
    for (int t = threadIdx.x; t < k; t += blockDim.x) {
      o.cand[(long long)blockIdx.x * k + t] = s_keys[t];
    }
    if (!last_block(o.ticket, &s_last)) return;
    // the last block: every other block's k keys through the buffer (its
    // own are in the top region already)
    const int n = gridDim.x * k;
    for (int b0 = 0; b0 < n; b0 += blockDim.x) {
      const int i = b0 + threadIdx.x;
      const u64 key = i < n ? __ldcg(o.cand + i) : 0;
      if (key > s_thr && i / k != (int)blockIdx.x) {
        s_keys[k + atomicAdd(&s_cnt, 1)] = key;
      }
      __syncthreads();
      if (s_cnt > cap - (int)blockDim.x) {
        merge_buffer(s_keys, &s_cnt, &s_thr, k);
      }
    }
    __syncthreads();
    if (s_cnt > 0) merge_buffer(s_keys, &s_cnt, &s_thr, k);
    if (threadIdx.x == 0) *o.ticket = 0u;
  }
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    decode(s_keys[t], o.out_s + t, o.out_i + t);
  }
}

// ---- the radix path (k > kMaxK) --------------------------------------------

__global__ void __launch_bounds__(kThreads)
    knn_keys(const Scan p, const float* __restrict__ anchor,
             u64* __restrict__ keys) {
  extern __shared__ float4 s_q4[];
  float* s_q = reinterpret_cast<float*>(s_q4);
  __shared__ float s_qq;
  load_anchor(anchor, p.d, s_q, &s_qq);
  const float qq = s_qq;
  const int groups = blockDim.x / p.lanes;
  const int group = threadIdx.x / p.lanes;
  const int lane = threadIdx.x % p.lanes;
  const long long step = (long long)gridDim.x * groups * kRowsPerIter;
  for (long long b0 = (long long)blockIdx.x * groups * kRowsPerIter;
       b0 < p.m; b0 += step) {
#pragma unroll
    for (int j = 0; j < kRowsPerIter; ++j) {
      const long long i = b0 + group + (long long)j * groups;
      const u64 key = candidate_key(p, s_q, qq, i, i < p.m, lane);
      if (lane == 0 && i < p.m) keys[i] = key;
    }
  }
}

// state: [0] prefix, [1] mask, [2] rank still to find, [3] compaction count
__global__ void knn_init_state(u64* state, unsigned* hist, int kk) {
  state[0] = 0;
  state[1] = 0;
  state[2] = (u64)kk;
  state[3] = 0;
  for (int b = 0; b < 256; ++b) hist[b] = 0;
}

__global__ void __launch_bounds__(kThreads)
    knn_hist(const u64* __restrict__ keys, long long m,
             const u64* state, int shift, unsigned* hist) {
  __shared__ unsigned h[256];
  for (int b = threadIdx.x; b < 256; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const u64 prefix = state[0], mask = state[1];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const u64 key = keys[i];
    if ((key & mask) == prefix) atomicAdd(&h[(key >> shift) & 255], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    if (h[b]) atomicAdd(hist + b, h[b]);
  }
}

// one thread: the digit that holds the rank still to find, from the top
__global__ void knn_select(u64* state, unsigned* hist, int shift) {
  const u64 want = state[2];
  u64 above = 0;
  for (int d = 255; d >= 0; --d) {
    const u64 c = hist[d];
    if (above + c >= want) {
      state[0] |= (u64)d << shift;
      state[1] |= (u64)0xFF << shift;
      state[2] = want - above;
      break;
    }
    above += c;
  }
  for (int b = 0; b < 256; ++b) hist[b] = 0;
}

__global__ void __launch_bounds__(kThreads)
    knn_compact(const u64* __restrict__ keys, long long m,
                u64* state, u64* __restrict__ buf) {
  const u64 kth = state[0];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const u64 key = keys[i];
    if (key >= kth) {
      const unsigned long long at =
          atomicAdd(state + 3, 1ull);
      buf[at] = key;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_fill_zero(u64* buf, long long from, long long to) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = from + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < to; i += stride) {
    buf[i] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_bitonic_step(u64* buf, long long half, long long size,
                     long long stride) {
  const long long gs = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < half; t += gs) {
    const long long i = 2 * t - (t & (stride - 1));
    const long long j = i + stride;
    const bool desc = (i & size) == 0;
    const u64 a = buf[i], b = buf[j];
    if (desc ? (a < b) : (a > b)) {
      buf[i] = b;
      buf[j] = a;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_decode(const u64* __restrict__ buf, int kk, float* out_s,
               long long* out_i) {
  const int stride = gridDim.x * blockDim.x;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < kk; t += stride) {
    decode(buf[t], out_s + t, out_i + t);
  }
}

int resident(int dev, const void* kernel, size_t smem) {
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// blocks of each block path that fit on device dev at once (asked once)
int fit_blocks(int dev, bool warp_path) {
  static std::atomic<int> known[2][kMaxDevices];  // 0: not asked yet
  const int w = warp_path ? 0 : 1;
  int fit = dev < kMaxDevices ? known[w][dev].load(std::memory_order_relaxed)
                              : 0;
  if (fit <= 0) {
    fit = warp_path ? resident(dev, (const void*)knn_warp_topk, kMaxDim * 4)
                    : resident(dev, (const void*)knn_buf_topk, kMaxDim * 4);
    if (dev < kMaxDevices) known[w][dev].store(fit, std::memory_order_relaxed);
  }
  return fit;
}

// blocks of the block path for m candidates of d floats: each takes at
// least kBlockBytes of rows, and never more than fit at once (32 < k:
// at most kMidBlocks, which bounds the last block's merge)
long long block_count(long long m, int d, int k, int dev) {
  const bool warp_path = k <= kWarpK;
  long long fit = fit_blocks(dev, warp_path);
  if (!warp_path && fit > kMidBlocks) fit = kMidBlocks;
  const long long row_bytes = 4ll * d;
  const long long want = (m * row_bytes + kBlockBytes - 1) / kBlockBytes;
  return want < fit ? (want > 0 ? want : 1) : fit;
}

long long pow2_at_least(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

int lanes_for(int d) {
  const int chunks = (d & 3) == 0 ? d >> 2 : d;
  int l = 1;
  while (l < chunks && l < 32) l <<= 1;
  return l;
}

}  // namespace

extern "C" int wk_knn_block_max_k() { return kMaxK; }

extern "C" int wk_knn_max_dim() { return kMaxDim; }

// uint64 words of the block paths' scratch on dev, for any call with
// k <= wk_knn_block_max_k(): a ticket word, then every block's keys. It
// must start zeroed; each call leaves its ticket at 0 again, so one scratch
// serves every call on a stream, one after another.
extern "C" long long wk_knn_block_scratch_words(int dev) {
  int was = dev;
  cudaGetDevice(&was);
  if (was != dev) cudaSetDevice(dev);
  const long long warp = (long long)fit_blocks(dev, true) * kWarpK;
  const long long fit_buf = fit_blocks(dev, false);
  const long long buf = (fit_buf < kMidBlocks ? fit_buf : kMidBlocks) * kMaxK;
  if (was != dev) cudaSetDevice(was);
  return 1 + (warp > buf ? warp : buf);
}

// uint64 words of the radix path's scratch for m candidates and k > 256:
// the m keys, the sort buffer (k rounded up to a power of two), the
// select's state and histogram
extern "C" long long wk_knn_radix_scratch_words(long long m, int k) {
  const long long kk = k < m ? k : m;
  return m + pow2_at_least(kk) + kStateWords + kHistWords;
}

// base [n, d] float32 and alive [n] bytes on dev; the m candidates are rows
// lo .. lo + m (slots null) or slots[0 .. m) (int64 rows); anchor [d]
// float32; metric 0 dot, 1 cosine, 2 l2; out_s [kk] float32 and out_i [kk]
// int64 with kk = min(k, m). scratch: for kk <= wk_knn_block_max_k() the
// block paths' (wk_knn_block_scratch_words, zeroed once, used by one
// stream); past it wk_knn_radix_scratch_words(m, k) words of any content.
// One launch for kk <= 256. dev is made current for the launches (and the
// caller's device restored).
extern "C" int wk_knn_scan(const float* base, int d,
                           const unsigned char* alive, long long lo,
                           long long m, const long long* slots,
                           const float* anchor, int metric, int k,
                           unsigned long long* scratch, float* out_s,
                           long long* out_i, int dev, cudaStream_t stream) {
  const long long kk = k < m ? k : m;
  if (kk <= 0) return (int)cudaGetLastError();
  if (d <= 0 || d > kMaxDim || m >= 0x7FFFFFFFll || metric < kDot ||
      metric > kL2) {
    return (int)cudaErrorInvalidValue;
  }
  int was = dev;
  cudaGetDevice(&was);
  if (was != dev) cudaSetDevice(dev);
  Scan p;
  p.base = base;
  p.alive = alive;
  p.slots = slots;
  p.lo = lo;
  p.m = m;
  p.d = d;
  p.metric = metric;
  p.lanes = lanes_for(d);
  const size_t smem = (size_t)(((d + 3) / 4) * 16);
  u64* s = scratch;
  if (kk <= kMaxK) {
    const long long blocks = block_count(m, d, (int)kk, dev);
    const long long per_block = (m + blocks - 1) / blocks;
    Out o;
    o.ticket = reinterpret_cast<unsigned*>(s);
    o.cand = s + 1;
    o.out_s = out_s;
    o.out_i = out_i;
    if (kk <= kWarpK) {
      knn_warp_topk<<<(unsigned)blocks, kThreads, smem, stream>>>(
          p, anchor, (int)kk, per_block, o);
    } else {
      knn_buf_topk<<<(unsigned)blocks, kThreads, smem, stream>>>(
          p, anchor, (int)kk, per_block, o);
    }
  } else {
    const long long kp = pow2_at_least(kk);
    u64* keys = s;
    u64* buf = s + m;
    u64* state = buf + kp;
    unsigned* hist = reinterpret_cast<unsigned*>(state + kStateWords);
    const int fit = resident(dev, (const void*)knn_hist, 0);
    const long long want = (m + kThreads - 1) / kThreads;
    const unsigned grid = (unsigned)(want < fit ? want : fit);
    const long long want_rows =
        (m + (long long)(kThreads / p.lanes) * kRowsPerIter - 1) /
        ((long long)(kThreads / p.lanes) * kRowsPerIter);
    const int fit_keys = resident(dev, (const void*)knn_keys, smem);
    knn_keys<<<(unsigned)(want_rows < fit_keys ? want_rows : fit_keys),
               kThreads, smem, stream>>>(p, anchor, keys);
    knn_init_state<<<1, 1, 0, stream>>>(state, hist, (int)kk);
    for (int pass = 0; pass < 8; ++pass) {
      const int shift = 56 - 8 * pass;
      knn_hist<<<grid, kThreads, 0, stream>>>(keys, m, state, shift, hist);
      knn_select<<<1, 1, 0, stream>>>(state, hist, shift);
    }
    knn_fill_zero<<<grid, kThreads, 0, stream>>>(buf, kk, kp);
    knn_compact<<<grid, kThreads, 0, stream>>>(keys, m, state, buf);
    const long long half = kp / 2;
    const long long want_half = (half + kThreads - 1) / kThreads;
    const unsigned sgrid = (unsigned)(want_half < fit ? want_half : fit);
    for (long long size = 2; size <= kp; size <<= 1) {
      for (long long stride = size >> 1; stride > 0; stride >>= 1) {
        knn_bitonic_step<<<sgrid, kThreads, 0, stream>>>(buf, half, size,
                                                         stride);
      }
    }
    const long long want_out = (kk + kThreads - 1) / kThreads;
    knn_decode<<<(unsigned)(want_out < fit ? want_out : fit), kThreads, 0,
                 stream>>>(buf, (int)kk, out_s, out_i);
  }
  const int rc = (int)cudaGetLastError();
  if (was != dev) cudaSetDevice(was);
  return rc;
}

extern "C" const char* wk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
