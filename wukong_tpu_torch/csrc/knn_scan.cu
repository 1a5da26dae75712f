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
// answer and keys are unique. Two paths:
//   k <= 256: one pass. A block scores a contiguous chunk of rows (a group of
//     L lanes a row, 16-byte loads when d % 4 == 0, a shuffle reduction) and
//     keeps its own top k in shared memory: keys above the block's current
//     k-th best go to a buffer, merged by a bitonic sort of 2,048 keys when it
//     fills. Each block writes its k best; one block merges them.
//   k > 256 (up to m, as lax.top_k allows any k up to the capacity): the keys
//     of all m candidates go to scratch, an 8-pass radix select (8 bits a
//     pass, MSB first, a device histogram and a one-thread digit pick) finds
//     the k-th largest key, the keys at or above it (exactly k) are
//     compacted, and a bitonic sort in device memory orders them.
//
// What bounds it on an H100: bytes. The function must read the m rows
// (m d 4 B), the mask and the slot list once; the operations (2 m d fp32
// flops, 4 m d for cosine and l2) are about 2 flops a byte, far below the
// card's 67 TFLOP/s fp32 over 3.35 TB/s (20 flops a byte). The design
// reads each row once with 16-byte loads, several rows in flight a lane
// group, and keeps every key of the k <= 256 path out of device memory
// (only k keys a block are written). The radix path writes and reads the
// m keys (8 B a candidate) nine times more; at d = 64 that is about a
// quarter more traffic than the rows, paid only when k > 256.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 256;            // the block path's largest k
constexpr int kBuf = 2048;            // shared keys: top region + buffer
constexpr int kCap = kBuf - kMaxK;    // buffer slots
constexpr int kRowsPerIter = 4;       // rows a lane group has in flight
constexpr int kMaxDevices = 64;
constexpr int kMaxDim = 4096;         // the anchor in 16 KB of shared memory
constexpr int kStateWords = 4;        // prefix, mask, remaining, count
constexpr int kHistWords = 128;       // 256 uint32 bins

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

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  const uint32_t u = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ uint64_t make_key(float s, long long i) {
  return ((uint64_t)ordered_bits(s) << 32) |
         (uint64_t)(0xFFFFFFFFu - (uint32_t)i);
}

// the anchor into shared memory and q.q (one thread, in index order, so
// every block computes the same value)
__device__ __forceinline__ void load_anchor(const float* __restrict__ anchor,
                                            int d, float* s_q, float* s_qq) {
  for (int c = threadIdx.x; c < d; c += blockDim.x) s_q[c] = anchor[c];
  __syncthreads();
  if (threadIdx.x == 0) {
    float qq = 0.f;
    for (int c = 0; c < d; ++c) qq = fmaf(s_q[c], s_q[c], qq);
    *s_qq = qq;
  }
  __syncthreads();
}

// the key of candidate i, computed by the L lanes of its group (every lane
// of the warp calls this, valid or not, for the shuffles)
__device__ __forceinline__ uint64_t candidate_key(const Scan& p,
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
    qb += __shfl_xor_sync(0xffffffffu, qb, off);
    bb += __shfl_xor_sync(0xffffffffu, bb, off);
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

// sort s_keys[0 .. kBuf) descending (every thread of the block calls it)
__device__ void bitonic_shared(uint64_t* s_keys) {
  for (int size = 2; size <= kBuf; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < kBuf / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool desc = (i & size) == 0;
        const uint64_t a = s_keys[i], b = s_keys[j];
        if (desc ? (a < b) : (a > b)) {
          s_keys[i] = b;
          s_keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// fold the buffer into the top region: after it s_keys[0 .. k) are the k
// largest keys seen, descending, and *s_thr the k-th (0 while fewer)
__device__ void merge_buffer(uint64_t* s_keys, int* s_cnt, uint64_t* s_thr,
                             int k) {
  const int n = kMaxK + *s_cnt;
  __syncthreads();  // every thread has read the count
  for (int i = n + threadIdx.x; i < kBuf; i += blockDim.x) s_keys[i] = 0;
  __syncthreads();
  bitonic_shared(s_keys);
  if (threadIdx.x == 0) {
    *s_cnt = 0;
    *s_thr = s_keys[k - 1];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    knn_block_topk(const Scan p, const float* __restrict__ anchor, int k,
                   long long per_block, uint64_t* __restrict__ cand) {
  extern __shared__ float4 s_q4[];
  float* s_q = reinterpret_cast<float*>(s_q4);
  __shared__ uint64_t s_keys[kBuf];
  __shared__ uint64_t s_thr;
  __shared__ int s_cnt;
  __shared__ float s_qq;
  for (int i = threadIdx.x; i < kMaxK; i += blockDim.x) s_keys[i] = 0;
  if (threadIdx.x == 0) {
    s_cnt = 0;
    s_thr = 0;
  }
  load_anchor(anchor, p.d, s_q, &s_qq);
  const float qq = s_qq;
  const int groups = blockDim.x / p.lanes;
  const int group = threadIdx.x / p.lanes;
  const int lane = threadIdx.x % p.lanes;
  const long long start = (long long)blockIdx.x * per_block;
  const long long end = start + per_block < p.m ? start + per_block : p.m;
  const int step = groups * kRowsPerIter;
  for (long long b0 = start; b0 < end; b0 += step) {
    uint64_t keys[kRowsPerIter];
#pragma unroll
    for (int j = 0; j < kRowsPerIter; ++j) {
      const long long i = b0 + group + (long long)j * groups;
      keys[j] = candidate_key(p, s_q, qq, i, i < end, lane);
    }
    if (lane == 0) {
      const uint64_t thr = s_thr;
#pragma unroll
      for (int j = 0; j < kRowsPerIter; ++j) {
        if (keys[j] > thr) s_keys[kMaxK + atomicAdd(&s_cnt, 1)] = keys[j];
      }
    }
    __syncthreads();
    if (s_cnt > kCap - step) merge_buffer(s_keys, &s_cnt, &s_thr, k);
  }
  __syncthreads();
  if (s_cnt > 0) merge_buffer(s_keys, &s_cnt, &s_thr, k);
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    cand[(long long)blockIdx.x * k + t] = s_keys[t];
  }
}

__device__ __forceinline__ void decode(uint64_t key, float* s,
                                       long long* idx) {
  *s = from_ordered((uint32_t)(key >> 32));
  *idx = (long long)(0xFFFFFFFFu - (uint32_t)key);
}

// one block: the k largest of ncand block candidates, decoded
__global__ void __launch_bounds__(kThreads)
    knn_merge(const uint64_t* __restrict__ cand, long long ncand, int k,
              int kk, float* out_s, long long* out_i) {
  __shared__ uint64_t s_keys[kBuf];
  __shared__ uint64_t s_thr;
  __shared__ int s_cnt;
  for (int i = threadIdx.x; i < kMaxK; i += blockDim.x) s_keys[i] = 0;
  if (threadIdx.x == 0) {
    s_cnt = 0;
    s_thr = 0;
  }
  __syncthreads();
  for (long long b0 = 0; b0 < ncand; b0 += blockDim.x) {
    const long long i = b0 + threadIdx.x;
    const uint64_t key = i < ncand ? cand[i] : 0;
    if (key > s_thr) s_keys[kMaxK + atomicAdd(&s_cnt, 1)] = key;
    __syncthreads();
    if (s_cnt > kCap - (int)blockDim.x) {
      merge_buffer(s_keys, &s_cnt, &s_thr, k);
    }
  }
  __syncthreads();
  if (s_cnt > 0) merge_buffer(s_keys, &s_cnt, &s_thr, k);
  for (int t = threadIdx.x; t < kk; t += blockDim.x) {
    decode(s_keys[t], out_s + t, out_i + t);
  }
}

// ---- the radix path (k > kMaxK) --------------------------------------------

__global__ void __launch_bounds__(kThreads)
    knn_keys(const Scan p, const float* __restrict__ anchor,
             uint64_t* __restrict__ keys) {
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
      const uint64_t key = candidate_key(p, s_q, qq, i, i < p.m, lane);
      if (lane == 0 && i < p.m) keys[i] = key;
    }
  }
}

// state: [0] prefix, [1] mask, [2] rank still to find, [3] compaction count
__global__ void knn_init_state(uint64_t* state, unsigned* hist, int kk) {
  state[0] = 0;
  state[1] = 0;
  state[2] = (uint64_t)kk;
  state[3] = 0;
  for (int b = 0; b < 256; ++b) hist[b] = 0;
}

__global__ void __launch_bounds__(kThreads)
    knn_hist(const uint64_t* __restrict__ keys, long long m,
             const uint64_t* state, int shift, unsigned* hist) {
  __shared__ unsigned h[256];
  for (int b = threadIdx.x; b < 256; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const uint64_t prefix = state[0], mask = state[1];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const uint64_t key = keys[i];
    if ((key & mask) == prefix) atomicAdd(&h[(key >> shift) & 255], 1u);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    if (h[b]) atomicAdd(hist + b, h[b]);
  }
}

// one thread: the digit that holds the rank still to find, from the top
__global__ void knn_select(uint64_t* state, unsigned* hist, int shift) {
  const uint64_t want = state[2];
  uint64_t above = 0;
  for (int d = 255; d >= 0; --d) {
    const uint64_t c = hist[d];
    if (above + c >= want) {
      state[0] |= (uint64_t)d << shift;
      state[1] |= (uint64_t)0xFF << shift;
      state[2] = want - above;
      break;
    }
    above += c;
  }
  for (int b = 0; b < 256; ++b) hist[b] = 0;
}

__global__ void __launch_bounds__(kThreads)
    knn_compact(const uint64_t* __restrict__ keys, long long m,
                uint64_t* state, uint64_t* __restrict__ buf) {
  const uint64_t kth = state[0];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const uint64_t key = keys[i];
    if (key >= kth) {
      const unsigned long long at =
          atomicAdd(reinterpret_cast<unsigned long long*>(state + 3), 1ull);
      buf[at] = key;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_fill_zero(uint64_t* buf, long long from, long long to) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = from + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < to; i += stride) {
    buf[i] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_bitonic_step(uint64_t* buf, long long half, long long size,
                     long long stride) {
  const long long gs = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < half; t += gs) {
    const long long i = 2 * t - (t & (stride - 1));
    const long long j = i + stride;
    const bool desc = (i & size) == 0;
    const uint64_t a = buf[i], b = buf[j];
    if (desc ? (a < b) : (a > b)) {
      buf[i] = b;
      buf[j] = a;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_decode(const uint64_t* __restrict__ buf, int kk, float* out_s,
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

// blocks of the block path for m candidates on device dev: as many as fit
// at once, each with at least 256 rows
long long block_count(long long m, int dev) {
  static std::atomic<int> known[kMaxDevices];  // 0: not asked yet
  int fit = dev < kMaxDevices ? known[dev].load(std::memory_order_relaxed)
                              : 0;
  if (fit <= 0) {
    fit = resident(dev, (const void*)knn_block_topk, kMaxDim * 4);
    if (dev < kMaxDevices) known[dev].store(fit, std::memory_order_relaxed);
  }
  const long long want = (m + 255) / 256;
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

// uint64 words of scratch one wk_knn_scan call of (m, k) needs on dev
extern "C" long long wk_knn_scratch_words(long long m, int k, int dev) {
  const long long kk = k < m ? k : m;
  if (kk <= 0) return 0;
  if (kk <= kMaxK) return block_count(m, dev) * kk;
  return m + pow2_at_least(kk) + kStateWords + kHistWords;
}

// base [n, d] float32 and alive [n] bytes on dev; the m candidates are rows
// lo .. lo + m (slots null) or slots[0 .. m) (int64 rows); anchor [d]
// float32; metric 0 dot, 1 cosine, 2 l2; scratch of wk_knn_scratch_words;
// out_s [kk] float32 and out_i [kk] int64 with kk = min(k, m). dev is made
// current for the launches (and the caller's device restored).
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
  uint64_t* s = reinterpret_cast<uint64_t*>(scratch);
  if (kk <= kMaxK) {
    const long long blocks = block_count(m, dev);
    const long long per_block = (m + blocks - 1) / blocks;
    knn_block_topk<<<(unsigned)blocks, kThreads, smem, stream>>>(
        p, anchor, (int)kk, per_block, s);
    knn_merge<<<1, kThreads, 0, stream>>>(s, blocks * kk, (int)kk, (int)kk,
                                          out_s, out_i);
  } else {
    const long long kp = pow2_at_least(kk);
    uint64_t* keys = s;
    uint64_t* buf = s + m;
    uint64_t* state = buf + kp;
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
