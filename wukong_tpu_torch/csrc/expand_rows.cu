// expand_rows: the row plan and the gathers of a known_to_unknown expansion
// step, from K1's (start, deg) of every table row to the output table.
//
// Replaces the XLA computation that follows the probe in
// wukong_tpu/engine/tpu_kernels.py:expand (a cumsum of the degrees, a
// scatter-max of each row's id at its output start, a running max over the
// output slots, two gathers and a select, which XLA fuses into a few
// kernels). Contract: the plain version expand_rows_plain in
// wukong_tpu_torch/engine/tpu_kernels.py. With incl the inclusive int64 sum
// of deg over the C table rows and total = incl[C-1]: output slot j < total
// belongs to the first row r with incl[r] > j (a row with deg > 0), and holds
// that row's W values, then edges[clamp(start[r] + j - excl[r], 0, E-1)]
// where excl[r] = incl[r] - deg[r]; every slot at or past total is 0 in all
// W+1 rows. counts[0] = min(total, INT32_MAX, cap_out) and counts[1] =
// min(total, INT32_MAX): the step's row count and its saturated total. Rows
// at or past the chain's count have deg 0 (K1 gives them none), so they own
// no slot.
//
// What bounds it on an H100: bytes on the tables a serving chain expands
// (thousands of rows): the function reads each row's deg once (4 B), the W
// values and the start of each row that owns a slot (4W + 4 B), the edge of
// each filled slot (4 B), and writes W+1 int32 rows over cap_out. The torch
// formulation of the same plan is about 30 launches, each a pass over C or
// cap_out; on a serving host every one of them is a call into PyTorch that
// drops and retakes the interpreter lock, which is what a light step's time
// is made of while client threads compete for that lock.
//
// The design:
// - At most kTile (4096) rows: one launch. Every block computes the
//   inclusive scan of all C degrees in shared memory (16 rows a thread, a
//   warp-shuffle scan across the block), then fills its slots: a thread a
//   slot (consecutive threads write consecutive slots of each row), the
//   owning row found by a binary search of the shared scan.
// - More rows: three launches. One block a tile of kTile rows writes the
//   tile's inclusive scan to a global scratch and the tile's total; one
//   block scans the tile totals (with a carry across chunks of 256); the fill
//   finds the slot's tile by a binary search of the tile scan, then the row
//   within the tile.
// - The fill grid is as many blocks as fit on the card at once, striding over
//   the slots; block 0 of the one-launch form (the tile-total scan in the
//   other) writes counts.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;
constexpr int kPer = kTile / kThreads;
constexpr long long kInt32Max = 2147483647LL;
constexpr int kMaxDevices = 64;

// Inclusive scan of one value a thread across the block: returns this
// thread's inclusive sum and sets *total to the block's. wt holds kWarps
// entries of shared scratch; the caller syncs before reusing it.
__device__ long long block_scan_one(long long v, long long* wt,
                                    long long* total) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wt[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kWarps ? wt[lane] : 0LL;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) wt[lane] = w;
  }
  __syncthreads();
  *total = wt[kWarps - 1];
  return x + (warp ? wt[warp - 1] : 0LL);
}

// sh[0 .. kTile) = inclusive sums of deg[lo .. lo + count), constant past
// count; returns the sum of the count degrees.
__device__ long long tile_scan_shared(const int* __restrict__ deg, int lo,
                                      int count, long long* sh,
                                      long long* wt) {
  const int base = threadIdx.x * kPer;
  long long local[kPer];
  long long run = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int r = base + k;
    run += r < count ? (long long)__ldg(deg + lo + r) : 0LL;
    local[k] = run;
  }
  long long total;
  const long long before = block_scan_one(run, wt, &total) - run;
#pragma unroll
  for (int k = 0; k < kPer; ++k) sh[base + k] = before + local[k];
  __syncthreads();
  return total;
}

__device__ void write_counts(long long total, int cap_out,
                             int* __restrict__ counts) {
  const long long sat = total < kInt32Max ? total : kInt32Max;
  counts[0] = (int)(sat < cap_out ? sat : cap_out);
  counts[1] = (int)sat;
}

// slot j of row r, whose output starts at excl
__device__ void emit(const int* __restrict__ table, long long ts0,
                     long long ts1, int W, int r,
                     const int* __restrict__ start,
                     const int* __restrict__ edges, long long E, long long j,
                     long long excl, long long cap_out,
                     int* __restrict__ out) {
  for (int w = 0; w < W; ++w)
    out[w * cap_out + j] = __ldg(table + w * ts0 + r * ts1);
  long long e = (long long)__ldg(start + r) + (j - excl);
  e = e > E - 1 ? E - 1 : e;
  e = e < 0 ? 0 : e;
  out[W * cap_out + j] = E > 0 ? __ldg(edges + e) : 0;
}

__device__ void zero(int W, long long j, long long cap_out,
                     int* __restrict__ out) {
  for (int w = 0; w <= W; ++w) out[w * cap_out + j] = 0;
}

__global__ void __launch_bounds__(kThreads)
    fill_small(const int* __restrict__ table, long long ts0, long long ts1,
               int W, int C, const int* __restrict__ start,
               const int* __restrict__ deg, const int* __restrict__ edges,
               long long E, int cap_out, int* __restrict__ out,
               int* __restrict__ counts) {
  __shared__ long long incl[kTile];
  __shared__ long long wt[kWarps];
  const long long total = tile_scan_shared(deg, 0, C, incl, wt);
  if (blockIdx.x == 0 && threadIdx.x == 0) write_counts(total, cap_out, counts);
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
       j < cap_out; j += (long long)gridDim.x * kThreads) {
    if (j < total) {
      int lo = 0, hi = C - 1;  // the first row with incl > j
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (incl[mid] > j) hi = mid;
        else lo = mid + 1;
      }
      emit(table, ts0, ts1, W, lo, start, edges, E, j,
           lo ? incl[lo - 1] : 0LL, cap_out, out);
    } else {
      zero(W, j, cap_out, out);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    tile_scan(const int* __restrict__ deg, int C, long long* __restrict__ incl,
              long long* __restrict__ tile_tot) {
  __shared__ long long sh[kTile];
  __shared__ long long wt[kWarps];
  const int lo = blockIdx.x * kTile;
  const int count = C - lo < kTile ? C - lo : kTile;
  const long long total = tile_scan_shared(deg, lo, count, sh, wt);
  for (int k = threadIdx.x; k < count; k += kThreads) incl[lo + k] = sh[k];
  if (threadIdx.x == 0) tile_tot[blockIdx.x] = total;
}

// one block: tile_incl = inclusive scan of the T tile totals; counts
__global__ void __launch_bounds__(kThreads)
    tile_offsets(const long long* __restrict__ tile_tot, int T,
                 long long* __restrict__ tile_incl, int cap_out,
                 int* __restrict__ counts) {
  __shared__ long long wt[kWarps];
  long long carry = 0;
  for (int c0 = 0; c0 < T; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    long long chunk;
    const long long x =
        block_scan_one(i < T ? tile_tot[i] : 0LL, wt, &chunk);
    if (i < T) tile_incl[i] = carry + x;
    carry += chunk;
    __syncthreads();  // wt is rewritten by the next chunk's scan
  }
  if (threadIdx.x == 0) write_counts(carry, cap_out, counts);
}

__global__ void __launch_bounds__(kThreads)
    fill_large(const int* __restrict__ table, long long ts0, long long ts1,
               int W, int C, const int* __restrict__ start,
               const long long* __restrict__ incl,
               const long long* __restrict__ tile_incl, int T,
               const int* __restrict__ edges, long long E, int cap_out,
               int* __restrict__ out) {
  const long long total = tile_incl[T - 1];
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
       j < cap_out; j += (long long)gridDim.x * kThreads) {
    if (j < total) {
      int lo = 0, hi = T - 1;  // the first tile whose running total > j
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (tile_incl[mid] > j) hi = mid;
        else lo = mid + 1;
      }
      const int first = lo * kTile;
      const long long off = lo ? tile_incl[lo - 1] : 0LL;
      const long long jj = j - off;
      int a = first, b = (C - first < kTile ? C : first + kTile) - 1;
      while (a < b) {  // the first row of the tile with incl > jj
        const int mid = (a + b) >> 1;
        if (incl[mid] > jj) b = mid;
        else a = mid + 1;
      }
      emit(table, ts0, ts1, W, a, start, edges, E, j,
           off + (a > first ? incl[a - 1] : 0LL), cap_out, out);
    } else {
      zero(W, j, cap_out, out);
    }
  }
}

// fill blocks that fit on device dev (the current one) at once
int resident_blocks(int dev) {
  static std::atomic<int> known[kMaxDevices];  // 0: not asked yet
  if (dev < kMaxDevices) {
    const int n = known[dev].load(std::memory_order_relaxed);
    if (n > 0) return n;
  }
  int sms = 0, a = 0, b = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, fill_small, kThreads, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, fill_large, kThreads, 0);
  const int per_sm = a < b ? a : b;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) known[dev].store(n, std::memory_order_relaxed);
  return n;
}

}  // namespace

// Rows a table may have for the one-launch form (more take three launches).
extern "C" int wk_expand_rows_tile() { return kTile; }

// Scratch (int64 words) the three-launch form needs for C rows: each row's
// scan within its tile, then each tile's total and running total.
extern "C" long long wk_expand_rows_scratch_words(int C) {
  if (C <= kTile) return 0;
  const long long T = (C + kTile - 1) / kTile;
  return C + 2 * T;
}

// table: int32 [W, C] with element strides (ts0, ts1); start, deg: int32
// [C] (K1's outputs); edges: int32 [E]; out: int32 [W + 1, cap_out],
// contiguous; counts: int32 [2]; scratch: wk_expand_rows_scratch_words(C)
// int64 words (none for C <= the tile). dev is the device of every pointer
// and of the stream: it is made current for the launches (and the caller's
// current device restored).
extern "C" int wk_expand_rows(const int* table, long long ts0, long long ts1,
                              int W, int C, const int* start, const int* deg,
                              const int* edges, long long E, int cap_out,
                              int* out, int* counts, long long* scratch,
                              int dev, cudaStream_t stream) {
  if (C <= 0 || cap_out <= 0 || W < 0) return (int)cudaErrorInvalidValue;
  int was = dev;
  cudaGetDevice(&was);
  if (was != dev) cudaSetDevice(dev);
  const long long want = ((long long)cap_out + kThreads - 1) / kThreads;
  const long long fit = resident_blocks(dev);
  const unsigned blocks = (unsigned)(want < fit ? want : fit);
  if (C <= kTile) {
    fill_small<<<blocks, kThreads, 0, stream>>>(table, ts0, ts1, W, C, start,
                                                deg, edges, E, cap_out, out,
                                                counts);
  } else {
    const int T = (C + kTile - 1) / kTile;
    long long* incl = scratch;
    long long* tile_tot = scratch + C;
    long long* tile_incl = tile_tot + T;
    tile_scan<<<T, kThreads, 0, stream>>>(deg, C, incl, tile_tot);
    tile_offsets<<<1, kThreads, 0, stream>>>(tile_tot, T, tile_incl, cap_out,
                                             counts);
    fill_large<<<blocks, kThreads, 0, stream>>>(table, ts0, ts1, W, C, start,
                                                incl, tile_incl, T, edges, E,
                                                cap_out, out);
  }
  const int rc = (int)cudaGetLastError();
  if (was != dev) cudaSetDevice(was);
  return rc;
}

extern "C" const char* wk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
