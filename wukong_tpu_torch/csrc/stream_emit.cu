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
// row = cpar(e) + copy. Rows at or past cap_out are not written but count
// towards *total; rows [min(total, cap_out), cap_out) are zero.
//
// What bounds it on an H100: bytes. The function must read dsel and dpar
// once (8 B an edge), edges[e] only where e emits a row below cap_out (4 B),
// and write val and par once over cap_out (8 B a row). Its arithmetic is a
// few integer operations an edge.
//
// The design: one pass over the deltas, Merrill & Garland's single-pass scan
// with decoupled look-back, in persistent blocks, then one fill launch.
// - A tile is kTile = 4,096 edges: 256 threads, thread t owning edges
//   16t .. 16t + 15. A block takes tile indices from a global atomic
//   counter in the order it asks for them, so no tile waits on a tile that
//   no running block holds. The grid is as many blocks as fit at once (3 an
//   SM: 64 KB of shared memory and 80 registers a thread each).
// - Each delta channel is read once, by 16 B cp.async copies into shared
//   memory, neighbouring threads on neighbouring addresses. A block holds two
//   tiles' deltas. The copies of the tile after next start at the end of an
//   iteration, and the next iteration waits for them first thing (to publish
//   that tile's aggregates early), so the block itself does not hide their
//   latency: only the SM's other blocks run while they land.
// - Cross-tile carries are the triple (dsel sum, dpar sum, rows). A tile's
//   row count depends on its incoming dsel carry, so a tile publishes (1) its
//   dsel/dpar aggregates as soon as its deltas have landed, (2) its
//   inclusive dsel/dpar prefixes and its row count once its carries are
//   known, (3) its inclusive row prefix once its row offset is known. Every
//   published word carries its own status bits (see TileState), so a reader
//   needs no fence between a flag and a value: it polls the word itself.
// - Look-back: the whole block, 512 predecessors a round (two a thread, one
//   16 B or 8 B load each), sums aggregates back to the nearest predecessor
//   that holds an inclusive prefix. Two tiles a block are in flight, so that
//   predecessor is often hundreds of tiles back.
// - Iteration n of a block: publish the aggregates of its next tile (its
//   deltas have landed), look back for tile n's row offset, stage tile n's
//   rows in place of its deltas and start gathering their edges with 4 B
//   cp.async, run phase A of the next tile (scan, delta look-back, row
//   count) while the gather lands, write tile n's rows, and start the copies
//   of the tile after next into the stage that tile n held. The next tile's
//   aggregates go out before tile n's row look-back, which keeps them off
//   the chain of row offsets that the other blocks wait on.
// - The stage holds kTile rows (each row's edge, then the gathered edge
//   value, and its par). Row r sits in slot swz(r), so that the lanes of a
//   warp, each writing its own run of rows, hit distinct banks. A K3 tile
//   with more rows below cap_out than that writes them a stage at a time
//   after phase A of the next tile.
// - dsel and row sums are 64-bit and exact; cpar is only ever used mod 2^32
//   (par and row are int32), so the dpar channel is summed in 32-bit
//   wrapping arithmetic, which gives the same bits.
// - The zero tail [min(total, cap_out), cap_out) is written by a second,
//   grid-wide launch (zero_tail) that reads total from device memory, 16 B
//   a thread. Each output byte is written once. One cudaMemsetAsync zeroes
//   the tile states and the counter before the emit.
//
// What holds it back is latency, not bytes or instructions: a block's
// iteration is a chain of barriers, of the two look-backs waiting on L2
// round trips and on other tiles, and of the wait for the delta copies
// above. A third stage, or publishing the next tile's aggregates later in
// the iteration, would take that wait off the chain.
//
// Resources (nvcc -Xptxas -v, sm_90a): emit<false> and emit<true> 80
// registers a thread under the launch bound of 3 blocks an SM (emit<true>
// spills about 100 B a thread, emit<false> 16 B), 65,536 B of dynamic and
// 336 B of static shared memory a block; zero_tail 24 registers.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                    // int32 values in 16 B
constexpr int kChunks = 4;                 // 16 B chunks a thread and channel
constexpr int kItems = kVec * kChunks;     // 16 edges a thread
constexpr int kTile = kThreads * kItems;   // 4,096 edges a tile
constexpr int kTileVecs = kTile / kVec;    // 16 B chunks a channel
constexpr int kStages = 2;                 // tiles in shared memory
constexpr int kSmemBytes = 2 * kStages * kTile * 4;
constexpr int kLook = 2;                   // predecessors a thread reads
constexpr int kBlocksPerSm = 3;            // 3 x 64 KB of shared memory
constexpr int kFillThreads = 256;
constexpr int kFillBlocks = 2048;
constexpr unsigned kFull = 0xffffffffu;

// What a tile publishes, zeroed before each launch. Every 64-bit word
// carries a status in its low two bits: 0 nothing yet, 1 the tile's own
// sum (its aggregate), 2 the sum over it and all tiles before it (its
// inclusive prefix). `delta` is two words written by one 16 B store:
// (dsel sum << 2) | status and (dpar sum mod 2^32 << 32) | status; a reader
// that finds two different statuses (a 16 B access the memory system split)
// reads again. `rows` is (row count << 2) | status. The aggregate is written
// first, then overwritten by the inclusive prefix. Sums are exact while
// |sum| < 2^61.
struct TileState {
  ulonglong2 delta;
  unsigned long long rows, pad;
};

struct Carry {
  long long sel;  // dsel sum, or rows for the row look-back
  unsigned par;   // dpar sum mod 2^32
};

struct Scratch {  // a block's shared scalars
  long long wsel[kWarps], wrows[kWarps], lsel[kWarps];
  unsigned wpar[kWarps], lpar[kWarps];
  int lstop[kWarps * kLook];
  int next;
};

constexpr unsigned long long kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ ulonglong2 get(const ulonglong2* w) {
  ulonglong2 v;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(v.x), "=l"(v.y) : "l"(w) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long get(
    const unsigned long long* w) {
  unsigned long long v;
  asm volatile("ld.volatile.global.u64 %0, [%1];" : "=l"(v) : "l"(w) : "memory");
  return v;
}

__device__ __forceinline__ void put_delta(TileState* t, long long sel,
                                          unsigned par,
                                          unsigned long long status) {
  const unsigned long long a = ((unsigned long long)sel << 2) | status;
  const unsigned long long b = ((unsigned long long)par << 32) | status;
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};"
               :: "l"(&t->delta), "l"(a), "l"(b) : "memory");
}

__device__ __forceinline__ void put_rows(TileState* t, long long rows,
                                         unsigned long long status) {
  const unsigned long long a = ((unsigned long long)rows << 2) | status;
  asm volatile("st.volatile.global.u64 [%0], %1;"
               :: "l"(&t->rows), "l"(a) : "memory");
}

// 16 B from global to shared memory; bytes past src_bytes are zero-filled
__device__ __forceinline__ void copy16(int4* dst, const int* src,
                                       int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// 4 B from global to shared memory
__device__ __forceinline__ void copy4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// start the copies of both channels of `tile`; thread t copies the 16 B
// chunks t, t + kThreads, ... so neighbouring threads copy neighbouring bytes
__device__ __forceinline__ void prefetch(const int* dsel, const int* dpar,
                                         long long E, int tile, int4* s_ds,
                                         int4* s_dp) {
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int v = threadIdx.x + k * kThreads;
    const long long i = (long long)tile * kTile + (long long)v * kVec;
    const long long left = E - i;
    const int bytes = left >= kVec ? 16 : left > 0 ? (int)left * 4 : 0;
    const long long src = bytes ? i : 0;
    copy16(s_ds + v, dsel + src, bytes);
    copy16(s_dp + v, dpar + src, bytes);
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// Exclusive prefix of x over the warp's lanes; *total is the warp's sum.
template <typename T>
__device__ __forceinline__ T warp_exclusive(T x, T* total) {
  const int lane = threadIdx.x & 31;
  T incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  *total = __shfl_sync(kFull, incl, 31);
  return incl - x;
}

// The whole block: the sums over all tiles before `tile` of the delta
// channels (kRows false) or of the rows (kRows true). Each round reads
// kThreads * kLook predecessors at once, thread t tiles cur - 1 - t and
// cur - 1 - t - kThreads, every word it needs in one go: aggregates back to
// the nearest predecessor that has published its inclusive prefix.
template <bool kRows>
__device__ Carry look_back(int tile, const TileState* st, Scratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kSpan = kThreads * kLook;
  Carry sum{0, 0};
  for (int cur = tile;; cur -= kSpan) {
    bool incl[kLook];
    Carry v[kLook];
    for (bool ready = false; !ready;) {
      ulonglong2 w[kLook];
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        const int j = cur - 1 - (int)threadIdx.x - q * kThreads;
        w[q] = make_ulonglong2(kInclusive, kInclusive);  // before tile 0: 0
        if (j >= 0) {
          if (kRows) {
            w[q].x = w[q].y = get(&st[j].rows);
          } else {
            w[q] = get(&st[j].delta);
          }
        }
      }
      ready = true;
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        const unsigned long long status = w[q].x & 3;
        incl[q] = status == kInclusive;
        v[q] = Carry{(long long)w[q].x >> 2, (unsigned)(w[q].y >> 32)};
        if (status == 0 || status != (w[q].y & 3)) ready = false;
      }
      if (!ready) __nanosleep(64);
    }
#pragma unroll
    for (int q = 0; q < kLook; ++q) {
      const unsigned ball = __ballot_sync(kFull, incl[q]);
      if (lane == 0) {
        s.lstop[q * kWarps + warp] =
            ball ? q * kThreads + warp * 32 + __ffs(ball) - 1 : kSpan;
      }
    }
    __syncthreads();
    int stop = kSpan;  // the nearest predecessor that holds a prefix
#pragma unroll
    for (int w = 0; w < kLook * kWarps; ++w) stop = min(stop, s.lstop[w]);
    Carry t{0, 0};
#pragma unroll
    for (int q = 0; q < kLook; ++q) {
      if (q * kThreads + (int)threadIdx.x <= stop) {
        t.sel += v[q].sel;
        t.par += v[q].par;
      }
    }
    t.sel = warp_sum(t.sel);
    if (!kRows) t.par = warp_sum(t.par);
    if (lane == 0) {
      s.lsel[warp] = t.sel;
      s.lpar[warp] = t.par;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sum.sel += s.lsel[w];
      sum.par += s.lpar[w];
    }
    __syncthreads();  // s.lstop / s.lsel are free again
    if (stop < kSpan) return sum;
  }
}

template <bool kMhot>
__device__ __forceinline__ long long rows_of(long long csel) {
  if (kMhot) return csel > 0 ? csel : 0;
  return csel > 0 ? 1 : 0;
}

__device__ __forceinline__ void unpack(int4 x, int (&out)[kVec]) {
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

// The whole block: sum `tile`'s channels (its deltas in cds, cdp) and
// publish the sums as its aggregates.
__device__ void publish_aggregates(int tile, const int4* cds, const int4* cdp,
                                   TileState* st, Scratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long sel = 0;
  unsigned p = 0;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int4 a = cds[threadIdx.x + k * kThreads];
    const int4 b = cdp[threadIdx.x + k * kThreads];
    sel += (long long)a.x + a.y + a.z + a.w;
    p += (unsigned)b.x + (unsigned)b.y + (unsigned)b.z + (unsigned)b.w;
  }
  sel = warp_sum(sel);
  p = warp_sum(p);
  if (lane == 0) {
    s.lsel[warp] = sel;
    s.lpar[warp] = p;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sel = 0;
    p = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sel += s.lsel[w];
      p += s.lpar[w];
    }
    put_delta(&st[tile], sel, p, kAggregate);
  }
}

// What phase A leaves for phase B of the same tile, per thread.
struct TileA {
  long long sel0;   // csel before this thread's first edge
  long long pos0;   // tile row of this thread's first emitted row
  long long rows;   // rows of this thread's edges
  long long total;  // rows of the tile
  unsigned par0;    // cpar before this thread's first edge
};

// Phase A of a tile, its deltas in shared memory (cds, cdp): scan both
// channels, publish the aggregates (unless published early), look back for
// the delta carries, count the rows, publish the prefixes and the row count.
template <bool kMhot>
__device__ __forceinline__ TileA phase_a(long long E, int tile,
                                         const int4* cds, const int4* cdp,
                                         bool publish_agg,
                                         TileState* __restrict__ st,
                                         Scratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile_base = (long long)tile * kTile;
  // this thread's edges are e0 .. e0 + 15 of the tile; `live` of them exist
  const int e0 = threadIdx.x * kItems;
  const int live = (int)max(0LL, min((long long)kItems, E - tile_base - e0));
  const int4* my_ds = cds + threadIdx.x * kChunks;
  const int4* my_dp = cdp + threadIdx.x * kChunks;

  // ---- sums of both channels within the tile
  long long tsel = 0;
  unsigned tpar = 0;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int4 a = my_ds[k], b = my_dp[k];
    tsel += (long long)a.x + a.y + a.z + a.w;
    tpar += (unsigned)b.x + (unsigned)b.y + (unsigned)b.z + (unsigned)b.w;
  }
  long long wsel;
  unsigned wpar;
  const long long xsel = warp_exclusive(tsel, &wsel);
  const unsigned xpar = warp_exclusive(tpar, &wpar);
  if (lane == 0) {
    s.wsel[warp] = wsel;
    s.wpar[warp] = wpar;
  }
  __syncthreads();
  long long sel_before = 0, sel_agg = 0;
  unsigned par_before = 0, par_agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      sel_before += s.wsel[w];
      par_before += s.wpar[w];
    }
    sel_agg += s.wsel[w];
    par_agg += s.wpar[w];
  }

  // ---- delta carries: publish the aggregates (unless published early),
  // look back
  if (publish_agg && threadIdx.x == 0) {
    put_delta(&st[tile], sel_agg, par_agg, kAggregate);
  }
  const Carry carry = look_back<false>(tile, st, s);
  TileA a;
  a.sel0 = carry.sel + sel_before + xsel;
  a.par0 = carry.par + par_before + xpar;

  // ---- rows of this tile, given its dsel carry
  a.rows = 0;
  long long c = a.sel0;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    int d[kVec];
    unpack(my_ds[k], d);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      c += d[j];
      if (k * kVec + j < live) a.rows += rows_of<kMhot>(c);
    }
  }
  long long wrows;
  const long long xrows = warp_exclusive(a.rows, &wrows);
  if (lane == 0) s.wrows[warp] = wrows;
  __syncthreads();
  long long rows_before = 0;
  a.total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) rows_before += s.wrows[w];
    a.total += s.wrows[w];
  }
  a.pos0 = rows_before + xrows;
  if (threadIdx.x == 0) {
    put_delta(&st[tile], carry.sel + sel_agg, carry.par + par_agg, kInclusive);
    put_rows(&st[tile], a.total, kAggregate);
  }
  return a;
}

// This thread's 16 deltas of each channel, from shared memory.
__device__ __forceinline__ void load_items(const int4* cds, const int4* cdp,
                                           int (&d)[kItems], int (&q)[kItems]) {
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int4 x = cds[threadIdx.x * kChunks + k];
    const int4 y = cdp[threadIdx.x * kChunks + k];
    d[k * kVec] = x.x, d[k * kVec + 1] = x.y, d[k * kVec + 2] = x.z;
    d[k * kVec + 3] = x.w;
    q[k * kVec] = y.x, q[k * kVec + 1] = y.y, q[k * kVec + 2] = y.z;
    q[k * kVec + 3] = y.w;
  }
}

// Where staged row r lives: its bank bits XOR its 32-row group, so that
// the lanes of a warp, each writing its own run of rows, hit distinct banks,
// while 32 consecutive rows (the gather, the write) still cover all 32.
__device__ __forceinline__ int swz(int r) { return r ^ ((r >> 5) & 31); }

// Stage this thread's rows that fall in the tile's rows [w0, w1): row r
// goes to s_edge[swz(r - w0)] (its edge's index in the tile) and
// s_par[swz(r - w0)].
template <bool kMhot>
__device__ __forceinline__ void stage_rows(long long E, int tile,
                                           const int (&d)[kItems],
                                           const int (&q)[kItems],
                                           const TileA& a, long long w0,
                                           long long w1, int* s_edge,
                                           int* s_par) {
  if (a.pos0 >= w1 || a.pos0 + a.rows <= w0) return;  // no rows of mine
  const int e0 = threadIdx.x * kItems;
  const int live =
      (int)max(0LL, min((long long)kItems, E - (long long)tile * kTile - e0));
  long long c = a.sel0, pos = a.pos0;
  unsigned p = a.par0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    c += d[i];
    p += (unsigned)q[i];
    const long long m = i < live ? rows_of<kMhot>(c) : 0;
    if (!kMhot) {  // one row or none
      if (m != 0 && pos >= w0 && pos < w1) {
        s_edge[swz((int)(pos - w0))] = e0 + i;
        s_par[swz((int)(pos - w0))] = (int)p;
      }
    } else {
      const int lo = (int)(max(pos, w0) - w0), hi = (int)(min(pos + m, w1) - w0);
      const unsigned p0 = p + (unsigned)(w0 - pos);  // par of row w0
      for (int r = lo; r < hi; ++r) {
        s_edge[swz(r)] = e0 + i;
        s_par[swz(r)] = (int)(p0 + (unsigned)r);
      }
    }
    pos += m;
  }
}

// Write the staged rows [0, n) out at row `at`; s_edge holds their edges.
__device__ __forceinline__ void write_rows(const int* s_edge, const int* s_par,
                                           int n, long long at,
                                           int* __restrict__ val,
                                           int* __restrict__ par) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    __stcs(val + at + i, s_edge[swz(i)]);
    __stcs(par + at + i, s_par[swz(i)]);
  }
}

struct TileB {
  long long off;  // the tile's first output row
  long long lim;  // its rows below cap_out
};

// Phase B1 of a tile: publish the aggregates of the block's next tile
// (next, its deltas in nds, ndp); look back for the tile's row offset and
// publish its inclusive row prefix.
template <bool kMhot>
__device__ __forceinline__ TileB phase_b1(long long cap_out, int G, int tile,
                                          const TileA& a, int next,
                                          const int4* nds, const int4* ndp,
                                          long long* __restrict__ total,
                                          TileState* __restrict__ st,
                                          Scratch& s) {
  if (next < G) {
    copy_wait<0>();
    __syncthreads();
    publish_aggregates(next, nds, ndp, st, s);
  }
  TileB b;
  b.off = look_back<true>(tile, st, s).sel;
  if (threadIdx.x == 0) {
    put_rows(&st[tile], b.off + a.total, kInclusive);
    if (tile == G - 1) *total = b.off + a.total;
  }
  b.lim = min(a.total, cap_out - b.off);
  return b;
}

// The emit writes the tile's rows [0, lim) through its own stage: once every
// thread holds its deltas in registers, the stage holds kTile rows, each
// row's edge (its index in the tile, then the edge itself, gathered by 4 B
// cp.async) and par; then consecutive threads write consecutive rows.

// Stage rows [w0, w1) in place of the deltas (the whole block; w1 - w0 <=
// kTile) and start gathering their edges.
template <bool kMhot>
__device__ __forceinline__ void stage_and_gather(
    const int* __restrict__ edges, long long E, int tile, int4* cds,
    int4* cdp, const int (&d)[kItems], const int (&q)[kItems],
    const TileA& a, long long w0, long long w1) {
  int* r_edge = reinterpret_cast<int*>(cds);
  int* r_par = reinterpret_cast<int*>(cdp);
  __syncthreads();  // every thread holds its deltas; the stage is free
  stage_rows<kMhot>(E, tile, d, q, a, w0, w1, r_edge, r_par);
  __syncthreads();
  const int* tile_edges = edges + (long long)tile * kTile;
  for (int i = threadIdx.x; i < w1 - w0; i += kThreads) {
    copy4(r_edge + swz(i), tile_edges + r_edge[swz(i)]);
  }
}

// Once the gather has landed (no newer copies pending), write the staged
// rows out at output row `at`.
__device__ __forceinline__ void write_staged(const int4* cds, const int4* cdp,
                                             int n, long long at,
                                             int* __restrict__ val,
                                             int* __restrict__ par) {
  copy_wait<0>();
  __syncthreads();
  write_rows(reinterpret_cast<const int*>(cds),
             reinterpret_cast<const int*>(cdp), n, at, val, par);
}

// A dense tile (more than kTile rows below cap_out, K3 only): all its rows,
// kTile at a time, each window gathered and written before the next.
template <bool kMhot>
__device__ __forceinline__ void emit_dense(
    const int* __restrict__ edges, long long E, int tile, int4* cds,
    int4* cdp, const TileA& a, const TileB& b, int* __restrict__ val,
    int* __restrict__ par) {
  int d[kItems], q[kItems];
  load_items(cds, cdp, d, q);
  for (long long w0 = 0; w0 < b.lim; w0 += kTile) {
    const long long w1 = min(w0 + (long long)kTile, b.lim);
    stage_and_gather<kMhot>(edges, E, tile, cds, cdp, d, q, a, w0, w1);
    copy_commit();
    write_staged(cds, cdp, (int)(w1 - w0), b.off + w0, val, par);
  }
}

// thread 0 takes the next tile index; the whole block reads it
__device__ __forceinline__ int claim(unsigned* counter, Scratch& s) {
  __syncthreads();  // the last index was read
  if (threadIdx.x == 0) s.next = (int)atomicAdd(counter, 1u);
  __syncthreads();
  return s.next;
}

// Persistent blocks, two tiles each in flight. Iteration n: B1 of tile n,
// staging tile n's rows, A of tile n + 1 while tile n's edges are gathered,
// writing tile n's rows; then the deltas of tile n + 2 start to land in the
// stage tile n held.
template <bool kMhot>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    emit(const int* __restrict__ edges, const int* __restrict__ dsel,
         const int* __restrict__ dpar, long long E, long long cap_out, int G,
         int* __restrict__ val, int* __restrict__ par,
         long long* __restrict__ total, unsigned* __restrict__ counter,
         TileState* __restrict__ st) {
  extern __shared__ int4 smem[];
  int4* s_ds = smem;                        // [kStages][kTileVecs]
  int4* s_dp = smem + kStages * kTileVecs;  // [kStages][kTileVecs]
  __shared__ Scratch s;

  int tile = claim(counter, s);
  if (tile >= G) return;
  prefetch(dsel, dpar, E, tile, s_ds, s_dp);
  copy_commit();
  int next = claim(counter, s);
  if (next < G) {
    prefetch(dsel, dpar, E, next, s_ds + kTileVecs, s_dp + kTileVecs);
  }
  copy_commit();
  copy_wait<1>();
  __syncthreads();
  TileA a = phase_a<kMhot>(E, tile, s_ds, s_dp, true, st, s);
  for (int stage = 0;; stage ^= 1) {
    int4* cds = s_ds + stage * kTileVecs;
    int4* cdp = s_dp + stage * kTileVecs;
    const int other = (stage ^ 1) * kTileVecs;
    const TileB b = phase_b1<kMhot>(cap_out, G, tile, a, next, s_ds + other,
                                    s_dp + other, total, st, s);
    // up to kTile rows: staged and gathered now, written after phase A of
    // the next tile; a dense tile after it, so that it holds no one up
    const bool dense = b.lim > kTile;
    if (b.lim > 0 && !dense) {
      int d[kItems], q[kItems];
      load_items(cds, cdp, d, q);
      stage_and_gather<kMhot>(edges, E, tile, cds, cdp, d, q, a, 0, b.lim);
    }
    copy_commit();
    TileA a_next;
    if (next < G) {
      a_next = phase_a<kMhot>(E, next, s_ds + other, s_dp + other, false, st,
                              s);
    }
    if (dense) {
      emit_dense<kMhot>(edges, E, tile, cds, cdp, a, b, val, par);
    } else if (b.lim > 0) {
      write_staged(cds, cdp, (int)b.lim, b.off, val, par);
    }
    if (next >= G) break;
    const int after = claim(counter, s);
    if (after < G) prefetch(dsel, dpar, E, after, cds, cdp);
    copy_commit();
    a = a_next;
    tile = next;
    next = after;
  }
  copy_wait<0>();
}

// rows [min(*total, cap_out), cap_out) of val and par := 0; both 16 B aligned
__global__ void __launch_bounds__(kFillThreads)
    zero_tail(int* __restrict__ val, int* __restrict__ par,
              const long long* __restrict__ total, long long cap_out) {
  const long long start = min(*total, cap_out);
  const long long a = min((start + kVec - 1) / kVec * kVec, cap_out);
  const long long b = max(cap_out / kVec * kVec, a);
  const long long tid = (long long)blockIdx.x * kFillThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kFillThreads;
  if (tid < a - start) {
    val[start + tid] = 0;
    par[start + tid] = 0;
  }
  if (tid < cap_out - b) {
    val[b + tid] = 0;
    par[b + tid] = 0;
  }
  const int4 z = make_int4(0, 0, 0, 0);
  for (long long i = a / kVec + tid; i < b / kVec; i += stride) {
    __stcs(reinterpret_cast<int4*>(val) + i, z);
    __stcs(reinterpret_cast<int4*>(par) + i, z);
  }
}

long long tiles(long long E) { return (E + kTile - 1) / kTile; }

// scratch layout: the tile counter, padding to 16 B, G TileStates; all of
// it is zeroed before each launch
constexpr long long kStateOffset = 16;

constexpr int kMaxDevices = 64;

// blocks of emit<kMhot> that fit on the current device at once; the first
// call on a device also opts emit<kMhot> in to kSmemBytes of dynamic shared
// memory there (an attribute each device holds on its own)
template <bool kMhot>
int resident_blocks() {
  static std::atomic<int> known[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kMaxDevices) {
    const int n = known[dev].load(std::memory_order_relaxed);
    if (n > 0) return n;
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(emit<kMhot>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, emit<kMhot>, kThreads,
                                                kSmemBytes);
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) known[dev].store(n, std::memory_order_relaxed);
  return n;
}

template <bool kMhot>
int launch(const int* edges, const int* dsel, const int* dpar, long long E,
           long long cap_out, int* val, int* par, long long* total,
           void* scratch, cudaStream_t stream) {
  const long long G = tiles(E);
  if (G == 0) {
    cudaMemsetAsync(total, 0, sizeof(long long), stream);
  } else {
    unsigned* counter = static_cast<unsigned*>(scratch);
    TileState* st = reinterpret_cast<TileState*>(
        static_cast<char*>(scratch) + kStateOffset);
    cudaMemsetAsync(scratch, 0, kStateOffset + G * sizeof(TileState), stream);
    const long long fit = resident_blocks<kMhot>();
    const unsigned blocks = (unsigned)(G < fit ? G : fit);
    emit<kMhot><<<blocks, kThreads, kSmemBytes, stream>>>(
        edges, dsel, dpar, E, cap_out, (int)G, val, par, total, counter, st);
  }
  if (cap_out > 0) {
    const long long want = (cap_out / kVec + kFillThreads - 1) / kFillThreads;
    const unsigned blocks =
        want < 1 ? 1u : want > kFillBlocks ? kFillBlocks : (unsigned)want;
    zero_tail<<<blocks, kFillThreads, 0, stream>>>(val, par, total, cap_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wk_stream_tile() { return kTile; }

extern "C" long long wk_stream_scratch_bytes(long long E) {
  const long long G = tiles(E);
  return G == 0 ? 0 : kStateOffset + G * (long long)sizeof(TileState);
}

extern "C" int wk_stream_emit(const int* edges, const int* dsel,
                              const int* dpar, long long E, long long cap_out,
                              int* val, int* par, long long* total,
                              void* scratch, cudaStream_t stream) {
  return launch<false>(edges, dsel, dpar, E, cap_out, val, par, total, scratch,
                       stream);
}

extern "C" int wk_stream_emit_m(const int* edges, const int* dsel,
                                const int* drow, long long E,
                                long long cap_out, int* val, int* row,
                                long long* total, void* scratch,
                                cudaStream_t stream) {
  return launch<true>(edges, dsel, drow, E, cap_out, val, row, total, scratch,
                      stream);
}

extern "C" const char* wk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
