// K2 / K3: streaming emit of a dense known_to_unknown expansion.
//
// K2 replaces wukong_tpu/engine/tpu_stream.py:_stream_emit (Pallas kernel
// _emit_kernel); K3 replaces wukong_tpu/engine/tpu_stream.py:_stream_emit_m
// (Pallas kernel _emit_kernel_m, the duplicate-anchor "m-hot" arm). Contract:
// the plain versions stream_emit_plain / stream_emit_m_plain in
// wukong_tpu_torch/engine/tpu_stream.py.
//
// Both stream a segment's edge array with two delta channels of equal length:
//   csel(e) = sum_{j<=e} dsel[j]   (K2: "inside a matched run" when > 0;
//                                   K3: multiplicity m(e) = max(csel, 0))
//   cpar(e) = sum_{j<=e} dpar[j]   (K2: parent id of the run; K3: the run's
//                                   first-occurrence row position dupstart)
// K2 writes every selected edge e, in edge order, at output row
// rank(e) = #{selected j < e}: val = edges[e], par = cpar(e).
// K3 writes m(e) consecutive rows starting at sum_{j<e} m(j): val = edges[e],
// row = cpar(e) + copy. Rows at or past cap_out are not written (the output
// is pre-zeroed by the caller) but count towards *total.
//
// The TPU kernel ran its grid in order and carried the prefix sums from tile
// to tile in SMEM. Hopper blocks run in no order, so the carries become
// passes over tiles of kTile edges:
//   1. tile_sums:    per-tile sums of dsel and dpar;
//   2. scan:         exclusive scan of those sums (one block per channel);
//   3. tile_counts:  per-tile selected count (K2) or multiplicity sum (K3),
//                    from a block scan of dsel seeded with the tile's carry;
//   4. scan:         exclusive scan of the counts -> output offsets, total;
//   5. emit:         block scans seeded with the carries and offsets; each
//                    selected edge writes its row(s).
// All sums are 64-bit integers: exact (the TPU's fp32 16-bit-halves matmul
// prefix sums were a Mosaic workaround and are not carried over).
//
// What bounds it on an H100: bytes. The function must read edges, dsel and
// dpar once (12 B per edge) and write 8 B per emitted row. These passes read
// dsel three times and dpar twice (24 B per edge): simple first, about 2x
// the bytes bound on the read side.

#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // edges per block
// the scan block's long long BlockScan takes ~90 registers a thread: 1024
// threads would ask for more than an SM's 65,536 and be refused at launch
constexpr int kScanThreads = 512;

using BlockScan = cub::BlockScan<long long, kThreads>;
using BlockReduce = cub::BlockReduce<long long, kThreads>;

__device__ __forceinline__ long long load(const int* a, long long i,
                                          long long n) {
  return i < n ? (long long)a[i] : 0LL;
}

// pass 1: per-tile sums of both delta channels
__global__ void __launch_bounds__(kThreads)
    tile_sums(const int* __restrict__ dsel,
              const int* __restrict__ dpar, long long E,
              long long* __restrict__ tsel,
              long long* __restrict__ tpar) {
  __shared__ typename BlockReduce::TempStorage tmp;
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x * kItems;
  long long s = 0, p = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    s += load(dsel, base + k, E);
    p += load(dpar, base + k, E);
  }
  s = BlockReduce(tmp).Sum(s);
  __syncthreads();
  p = BlockReduce(tmp).Sum(p);
  if (threadIdx.x == 0) {
    tsel[blockIdx.x] = s;
    tpar[blockIdx.x] = p;
  }
}

struct ScanJob {
  const long long* in;
  long long* out;    // exclusive prefix, length n
  long long* total;  // sum of all n values (may be null)
};

// passes 2 and 4: one block per job scans n values in chunks, carrying the
// running sum from chunk to chunk
__global__ void __launch_bounds__(kScanThreads)
    scan_exclusive(ScanJob job0, ScanJob job1, long long n) {
  using Scan = cub::BlockScan<long long, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const ScanJob job = blockIdx.x == 0 ? job0 : job1;
  long long carry = 0;
  for (long long base = 0; base < n; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const long long x = i < n ? job.in[i] : 0;
    long long ex, agg;
    Scan(tmp).ExclusiveSum(x, ex, agg);
    if (i < n) job.out[i] = carry + ex;
    carry += agg;
    __syncthreads();
  }
  if (threadIdx.x == 0 && job.total != nullptr) *job.total = carry;
}

template <bool kMhot>
__device__ __forceinline__ long long rows_of(long long csel) {
  if (kMhot) return csel > 0 ? csel : 0;
  return csel > 0 ? 1 : 0;
}

// pass 3: rows each tile emits, given its dsel carry
template <bool kMhot>
__global__ void __launch_bounds__(kThreads)
    tile_counts(const int* __restrict__ dsel, long long E,
                const long long* __restrict__ csel_in,
                long long* __restrict__ tcnt) {
  __shared__ typename BlockScan::TempStorage scan_tmp;
  __shared__ typename BlockReduce::TempStorage red_tmp;
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x * kItems;
  long long raw[kItems], d[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) raw[k] = load(dsel, base + k, E);
  BlockScan(scan_tmp).InclusiveSum(raw, d);
  const long long carry = csel_in[blockIdx.x];
  long long c = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (base + k < E) c += rows_of<kMhot>(carry + d[k]);
  c = BlockReduce(red_tmp).Sum(c);
  if (threadIdx.x == 0) tcnt[blockIdx.x] = c;
}

// pass 5: write the selected rows
template <bool kMhot>
__global__ void __launch_bounds__(kThreads)
    emit(const int* __restrict__ edges,
         const int* __restrict__ dsel,
         const int* __restrict__ dpar, long long E,
         long long cap_out, const long long* __restrict__ csel_in,
         const long long* __restrict__ cpar_in,
         const long long* __restrict__ off,
         int* __restrict__ val, int* __restrict__ par) {
  __shared__ typename BlockScan::TempStorage tmp;
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x * kItems;
  long long ds[kItems], dp[kItems], cs[kItems], cp[kItems], m[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    ds[k] = load(dsel, base + k, E);
    dp[k] = load(dpar, base + k, E);
  }
  BlockScan(tmp).InclusiveSum(ds, cs);
  __syncthreads();
  BlockScan(tmp).InclusiveSum(dp, cp);
  __syncthreads();
  const long long sel_carry = csel_in[blockIdx.x];
  const long long par_carry = cpar_in[blockIdx.x];
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    m[k] = base + k < E ? rows_of<kMhot>(sel_carry + cs[k]) : 0;
  long long pos[kItems];
  BlockScan(tmp).ExclusiveSum(m, pos);
  const long long o = off[blockIdx.x];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (m[k] == 0) continue;
    const int e = edges[base + k];
    const long long p0 = o + pos[k];
    const long long parent = par_carry + cp[k];
    for (long long c = 0; c < m[k] && p0 + c < cap_out; ++c) {
      val[p0 + c] = e;
      par[p0 + c] = (int)(parent + c);  // K2: m == 1, copy index 0
    }
  }
}

template <bool kMhot>
int launch(const int* edges, const int* dsel, const int* dpar, long long E,
           long long cap_out, int* val, int* par, long long* total,
           long long* scratch, cudaStream_t stream) {
  const long long G = (E + kTile - 1) / kTile;
  if (G == 0) {
    cudaMemsetAsync(total, 0, sizeof(long long), stream);
    return (int)cudaGetLastError();
  }
  long long* tsel = scratch;
  long long* tpar = scratch + G;
  long long* csel_in = scratch + 2 * G;
  long long* cpar_in = scratch + 3 * G;
  long long* tcnt = scratch + 4 * G;
  long long* off = scratch + 5 * G;
  tile_sums<<<(unsigned)G, kThreads, 0, stream>>>(dsel, dpar, E, tsel, tpar);
  scan_exclusive<<<2, kScanThreads, 0, stream>>>(
      ScanJob{tsel, csel_in, nullptr}, ScanJob{tpar, cpar_in, nullptr}, G);
  tile_counts<kMhot><<<(unsigned)G, kThreads, 0, stream>>>(dsel, E, csel_in,
                                                           tcnt);
  scan_exclusive<<<1, kScanThreads, 0, stream>>>(
      ScanJob{tcnt, off, total}, ScanJob{tcnt, off, total}, G);
  emit<kMhot><<<(unsigned)G, kThreads, 0, stream>>>(
      edges, dsel, dpar, E, cap_out, csel_in, cpar_in, off, val, par);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: 6 * ceil(E / wk_stream_tile()) int64 values
extern "C" int wk_stream_tile() { return kTile; }

extern "C" int wk_stream_emit(const int* edges, const int* dsel,
                              const int* dpar, long long E, long long cap_out,
                              int* val, int* par, long long* total,
                              long long* scratch, cudaStream_t stream) {
  return launch<false>(edges, dsel, dpar, E, cap_out, val, par, total, scratch,
                       stream);
}

extern "C" int wk_stream_emit_m(const int* edges, const int* dsel,
                                const int* drow, long long E,
                                long long cap_out, int* val, int* row,
                                long long* total, long long* scratch,
                                cudaStream_t stream) {
  return launch<true>(edges, dsel, drow, E, cap_out, val, row, total, scratch,
                      stream);
}

extern "C" const char* wk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
