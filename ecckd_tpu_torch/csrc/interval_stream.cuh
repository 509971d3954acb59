// Streaming interval-sum core of kernels K3 (interval_sum.cu) and E2
// (fused_sums_lw.cu), and the per-strip sums of the sweeps K1 (sweep_lw.cu),
// K2 (sweep_sw.cu) and E1 (sweep_lw_scan.cu), at the end of this file.
//
// Serves the ports of the Pallas TPU kernels ecckd_tpu/ops/segments.py
// (_interval_sum_fused_pallas) and scripts/exp_kernels.py
// (fused_sums_pallas).  Each forms, per wavenumber w, a set of rows v[r](w)
// from a few operand rows and needs S[r][j] = sum of v[r](w) over the
// inclusive interval [i1[j], i2[j]].
//
// What bounds it on an H100: device memory.  Each operand byte is needed
// once (1.27 GB for the 152 LW rows at 2^20 wavenumbers in f64, 0.38 ms at
// 3.35 TB/s) against one multiply and one add per row and wavenumber.  A
// 0/1 membership matmul would do 2 * rows * n * nseg operations instead.
// What the design does about it:
//  * Fixed grid, independent of the intervals: strips of kStrip
//    wavenumbers, one per warp; chunks of kStripWarps strips, one per
//    block and group of rows.  The group index runs fastest, so the blocks
//    that read one chunk of an operand shared by two rows run together and
//    the second read comes from L2.
//  * Each lane loads its kPer values of each row of an item (two or three
//    rows) in 16-byte vectors before it sums any, with no block barrier in
//    the streaming loop.  A row whose base is not 16-byte aligned is read
//    as scalars into the same lanes and slots, so its sums are the same
//    bits.
//  * The host resolves the intervals once per launch
//    (ops/kernels/interval_stream.py): identical clamped intervals are
//    reduced once, each chunk gets the list of the (few) intervals that
//    meet it, each (interval, chunk) pair one slot of a compact partial
//    buffer.  A warp keeps a bit mask of the entries that meet its strip;
//    for each it takes a masked lane sum in a fixed order and a fixed
//    shuffle tree, so its work per strip does not grow with the intervals
//    of the chunk.  The block adds its warps' strip sums in warp order
//    (one barrier after the streaming loop) and writes one value per
//    (row, slot).  sum_slots adds the slots of each interval, one warp per
//    (row, column): lane l adds slots l, l + 32, ... in order, then the
//    shuffle tree.  The sweeps K1, K2 and E1 use the same table, partials
//    and sum_slots at strip granularity (the last section).
// So the sum of interval j depends only on the data, on the clamped
// (i1[j], i2[j]) and on the fixed grid, never on the other intervals of
// the launch, and there are no floating-point atomics: repeats are
// bit-identical.  Products use __dmul_rn / __fmul_rn, which the compiler
// never contracts into an add, so a row's value does not depend on how
// the kernel that forms it is written.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "checked.cuh"

// 0 in the ablation's copy: the masked sums and shuffle trees are skipped
// and the loaded values only kept alive (scripts/ablate_kernels.py).
#define ECCKD_STREAM_REDUCE 1

namespace ecckd {
namespace stream {

constexpr int kStrip = 256;                     // wavenumbers per warp
constexpr int kStripWarps = 8;                  // warps per block
constexpr int kThreads = 32 * kStripWarps;
constexpr int kChunk = kStrip * kStripWarps;    // wavenumbers per block
constexpr int kMaxEntries = 32;                 // entries per pass (ballot)

template <typename T> struct Vec;
template <> struct Vec<double> { using type = double2; };
template <> struct Vec<float> { using type = float4; };

template <typename T>
constexpr int kVec = 16 / sizeof(T);            // values per 16-byte load
template <typename T>
constexpr int kPer = kStrip / 32;               // values per lane and row

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Offset of value slot k of this lane from the strip's first wavenumber:
// load it = k / kVec, element e = k % kVec.
template <typename T>
__device__ __forceinline__ int slot_offset(int k, int lane) {
  return (k / kVec<T>) * 32 * kVec<T> + lane * kVec<T> + (k % kVec<T>);
}

// This lane's P values of ``row`` in the strip of 32 * P wavenumbers
// starting at ``s0`` (zero past ``n``).
template <typename T, int P = kPer<T>>
__device__ __forceinline__ void load_strip(const T* __restrict__ row, int s0,
                                           int n, T (&v)[P]) {
  const int lane = threadIdx.x & 31;
  constexpr int V = kVec<T>;
  static_assert(P % V == 0, "a lane's values fill whole 16-byte loads");
  if (s0 + 32 * P <= n) {
    const T* p = row + s0 + lane * V;
    if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
      using VT = typename Vec<T>::type;
#pragma unroll
      for (int it = 0; it < P / V; ++it) {
        const VT x = __ldg(reinterpret_cast<const VT*>(p + it * 32 * V));
        const T* xs = reinterpret_cast<const T*>(&x);
#pragma unroll
        for (int e = 0; e < V; ++e) v[it * V + e] = xs[e];
      }
    } else {
#pragma unroll
      for (int it = 0; it < P / V; ++it)
#pragma unroll
        for (int e = 0; e < V; ++e) v[it * V + e] = __ldg(p + it * 32 * V + e);
    }
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int w = s0 + slot_offset<T>(k, lane);
      v[k] = w < n ? __ldg(row + w) : T(0);
    }
  }
}

// Sum over the interval [lo, hi] (absolute, clamped) of this warp's strip
// values ``v``, in lane 0: masked lane sums in slot order, then the tree.
template <typename T, int P = kPer<T>>
__device__ __forceinline__ T strip_sum(const T (&v)[P], int s0, int lo,
                                       int hi) {
  const int lane = threadIdx.x & 31;
  const int a = lo - s0, b = hi - s0;
  T s = T(0);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int o = slot_offset<T>(k, lane);
    s += (o >= a && o <= b) ? v[k] : T(0);
  }
  return warp_sum(s);
}

// Int32 table of a launch (built by ops/kernels/interval_stream.py):
//   chunk_ptr[nchunks + 1]      entries of chunk c: chunk_ptr[c] .. [c+1]
//   entry[3 * nentries]         (lo, hi, slot) per entry, by chunk
//   col[2 * nseg]               (first slot, slot count) per output column
// Each entry has a slot of its own, so the partials are [nrows][nentries].
struct Table {
  const int* chunk_ptr;
  const int* entry;
  const int* col;
};

// The checked build's checks of a chunk's (or strip's) entry range
// [e0, e1) and of entry e's (lo, hi, slot).
__device__ __forceinline__ void check_entries(const char* kernel, int e0,
                                              int e1, int nentries) {
  ECCKD_CHECK_RANGE(kernel, "first entry of the chunk", e0, 0, nentries);
  ECCKD_CHECK_RANGE(kernel, "end of the chunk's entries", e1, e0, nentries);
}

__device__ __forceinline__ void check_entry(const char* kernel, int lo, int hi,
                                            int slot, int n, int nentries) {
  ECCKD_CHECK_RANGE(kernel, "entry lo", lo, 0, n - 1);
  ECCKD_CHECK_RANGE(kernel, "entry hi", hi, lo, n - 1);
  ECCKD_CHECK_INDEX(kernel, "entry slot", slot, nentries);
}

__host__ __device__ inline Table table_of(const int* t, int n, int nentries) {
  const int nchunks = (n + kChunk - 1) / kChunk;
  return Table{t, t + nchunks + 1, t + nchunks + 1 + 3 * nentries};
}

// Dynamic shared memory of a block: entries, warp masks, warp sums, and
// ``extra`` bytes of the row source (16-byte aligned at the end).
template <typename T>
inline size_t smem_bytes(int rows_per_block, int cmax, size_t extra) {
  size_t b = sizeof(int) * (3 * (size_t)cmax + kStripWarps);
  b = (b + 15) / 16 * 16;
  b += sizeof(T) * (size_t)kStripWarps * rows_per_block * cmax;
  b = (b + 15) / 16 * 16;
  return b + extra;
}

// The streaming kernel.  ``Src`` gives kRows rows per item and
// kItems items per block:
//   __device__ void stage(int item0, unsigned char* smem)  (block, once)
//   __device__ int row(int item, int q) const   output row, or -1
//   __device__ void load(int item, int s0, int n, T (&v)[kRows][kPer<T>])
// Block (g, c) takes items g*kItems .. and chunk c.
template <typename T, typename Src>
__global__ void __launch_bounds__(kThreads)
stream_kernel(Src src, const int* __restrict__ table, int nentries,
              T* __restrict__ partial, int nrows, int n, int cmax) {
  constexpr int R = Src::kRows;
  constexpr int RPB = Src::kRows * Src::kItems;
  extern __shared__ __align__(16) unsigned char smem[];
  const Table tab = table_of(table, n, nentries);
  const int g = blockIdx.x, c = blockIdx.y;
  const int e0 = tab.chunk_ptr[c], e1 = tab.chunk_ptr[c + 1];
  check_entries("stream_kernel", e0, e1, nentries);
  if (e0 == e1) return;  // the same in every thread of the block
  int* s_ent = reinterpret_cast<int*>(smem);          // [cmax][3]
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_ent + 3 * cmax);
  size_t off = sizeof(int) * (3 * (size_t)cmax + kStripWarps);
  off = (off + 15) / 16 * 16;
  T* s_sum = reinterpret_cast<T*>(smem + off);        // [warp][RPB][cmax]
  off += sizeof(T) * (size_t)kStripWarps * RPB * cmax;
  off = (off + 15) / 16 * 16;
  const int item0 = g * Src::kItems;
  src.stage(item0, smem + off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = c * kChunk + warp * kStrip;

  for (int p0 = e0; p0 < e1; p0 += cmax) {
    const int np = min(cmax, e1 - p0);
    for (int k = threadIdx.x; k < 3 * np; k += kThreads)
      s_ent[k] = tab.entry[3 * p0 + k];
    __syncthreads();
#if defined(ECCKD_CHECKED) && ECCKD_CHECKED
    for (int e = threadIdx.x; e < np; e += kThreads)
      check_entry("stream_kernel", s_ent[3 * e], s_ent[3 * e + 1],
                  s_ent[3 * e + 2], n, nentries);
#endif
    // The entries that meet this warp's strip
    const bool meets = lane < np && s_ent[3 * lane] <= s0 + kStrip - 1
                       && s_ent[3 * lane + 1] >= s0;
    const unsigned mask = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) s_mask[warp] = mask;
    if (mask) {
      for (int i = 0; i < Src::kItems; ++i) {
        const int item = item0 + i;
        if (src.row(item, 0) < 0) break;
        T v[R][kPer<T>];
        src.load(item, s0, n, v);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          T* out = s_sum + ((size_t)warp * RPB + i * R + q) * cmax;
#if ECCKD_STREAM_REDUCE
          for (unsigned m = mask; m; m &= m - 1) {
            const int e = __ffs(m) - 1;
            ECCKD_CHECK_INDEX("stream_kernel", "s_ent entry", e, cmax);
            const T s = strip_sum<T>(v[q], s0, s_ent[3 * e],
                                     s_ent[3 * e + 1]);
            if (lane == 0) out[e] = s;
          }
#else
          T s = T(0);
#pragma unroll
          for (int k = 0; k < kPer<T>; ++k) s += v[q][k];
          if (s == T(1.2345e-30)) out[0] = s;
#endif
        }
      }
    }
    __syncthreads();
    // Warp sums in warp order, one value per (row, slot)
    for (int k = threadIdx.x; k < RPB * np; k += kThreads) {
      const int rr = k / np, e = k - rr * np;
      const int r = src.row(item0 + rr / R, rr % R);
      if (r < 0) continue;
      ECCKD_CHECK_INDEX("stream_kernel", "partial row", r, nrows);
      T s = T(0);
      for (int w = 0; w < kStripWarps; ++w)
        if ((s_mask[w] >> e) & 1u) s += s_sum[((size_t)w * RPB + rr) * cmax + e];
      partial[(size_t)r * nentries + s_ent[3 * e + 2]] = s;
    }
    __syncthreads();
  }
}

// out[r][j] = the slots of column j added (0 if none), one warp per (r, j):
// lane l adds slots l, l + 32, ... in order, then the shuffle tree.
template <typename T>
__global__ void __launch_bounds__(256)
sum_slots(const T* __restrict__ partial, T* __restrict__ out,
          const int* __restrict__ col, int nrows, int nslots, int nseg) {
  const long long pair = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (pair >= (long long)nrows * nseg) return;
  const int lane = threadIdx.x & 31;
  const int r = (int)(pair / nseg), j = (int)(pair - (long long)r * nseg);
  const int first = col[2 * j], count = col[2 * j + 1];
  ECCKD_CHECK_RANGE("sum_slots", "first slot of a column", first, 0, nslots);
  ECCKD_CHECK_RANGE("sum_slots", "last slot of a column", first + count,
                    first, nslots);
  ECCKD_CHECK_INDEX("sum_slots", "output row", r, nrows);
  const T* p = partial + (size_t)r * nslots + first;
  T s = T(0);
  for (int k = lane; k < count; k += 32) s += p[k];
  s = warp_sum(s);
  if (lane == 0) out[pair] = s;
}

// sum_slots of the (nrows, nseg) output of a launch with ``nentries``
// entries, after the kernel that wrote its partials.
template <typename T>
inline int launch_sum_slots(const T* partial, T* out, const int* table,
                            int nentries, int nrows, int n, int nseg,
                            int chunk, cudaStream_t stream) {
  const long long pairs = (long long)nrows * nseg;
  if (pairs > 0) {
    const int nchunks = (n + chunk - 1) / chunk;
    sum_slots<T><<<(unsigned)((pairs + 7) / 8), 256, 0, stream>>>(
        partial, out, table + nchunks + 1 + 3 * nentries, nrows, nentries,
        nseg);
  }
  return (int)cudaGetLastError();
}

// Launch the streaming kernel over (row groups, chunks), then sum_slots.
template <typename T, typename Src>
inline int launch(const Src& src, int ngroups, const int* table, int nentries,
                  int cmax, size_t extra_smem, T* partial, T* out, int nrows,
                  int n, int nseg, cudaStream_t stream) {
  const int nchunks = (n + kChunk - 1) / kChunk;
  const size_t smem = smem_bytes<T>(Src::kRows * Src::kItems, cmax,
                                    extra_smem);
  if (cmax < 1 || cmax > kMaxEntries) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stream_kernel<T, Src>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (nentries > 0 && ngroups > 0) {
    stream_kernel<T, Src><<<dim3(ngroups, nchunks), kThreads, smem, stream>>>(
        src, table, nentries, partial, nrows, n, cmax);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_sum_slots<T>(partial, out, table, nentries, nrows, n, nseg,
                             kChunk, stream);
}

// ---------------------------------------------------------------- sweeps
//
// K1, K2 and E1 run a recurrence across the layers of each wavenumber and
// need every level of it summed over the intervals.  One warp takes a
// strip of wavenumbers: for K1 and K2 kSweepStrip<T>, each lane
// kSweepPer<T> slots of it in the layout of slot_offset (two 16-byte loads
// a row: 4 doubles, 8 floats), so a lane runs kSweepPer<T> independent
// recurrences in registers: instruction-level parallelism where one chain
// would wait.  The interval table is built at strip granularity
// (interval_stream.py with chunk = the strip): per strip the entries (lo,
// hi, slot) that meet it, any number of them, and one partial slot per
// (interval, strip).  At each level the warp takes the masked strip sum of
// every entry of its strip and lane 0 writes it to the entry's slot
// (StripSums::put); E1 sums the levels of its strip from shared memory
// instead (StripSums::put_rows).  No warp waits for another and there is
// no block barrier at all; a strip that no interval meets is not swept.
// sum_slots then adds the slots of each interval in strip order, as for
// K3.  An interval's sums depend only on the data, on its clamped bounds
// and on the fixed strips, never on the other intervals of the launch, and
// there are no floating-point atomics.

// Wavenumbers per lane, and blocks of kSweepThreads an SM must hold (so
// at most 65536 / (kSweepThreads * blocks) registers a thread: 128 for
// f64, 170 for f32), both fixed by measurement on the H100 (PERF.md).
template <typename T> constexpr int kSweepPer = 8;
template <> constexpr int kSweepPer<double> = 4;
template <typename T> constexpr int kSweepMinBlocks = 3;
template <> constexpr int kSweepMinBlocks<double> = 4;
template <typename T>
constexpr int kSweepStrip = 32 * kSweepPer<T>;   // wavenumbers per warp
constexpr int kSweepWarps = 4;                   // warps per block
constexpr int kSweepThreads = 32 * kSweepWarps;

// The fitted-od columns of this lane's slots in the strip at ``s0``: per
// slot (-1 where seg is outside [0, nseg) or the slot is past ``n``), and
// the one column of all of them where they agree (else -2), as they do
// away from the intervals' ends.
template <typename T>
struct FitColumns {
  int col[kSweepPer<T>];
  int common;
};

template <typename T>
__device__ __forceinline__ FitColumns<T> fit_columns(
    const int* __restrict__ seg, int s0, int n, int nseg) {
  const int lane = threadIdx.x & 31;
  FitColumns<T> f;
#pragma unroll
  for (int k = 0; k < kSweepPer<T>; ++k) {
    const int w = s0 + slot_offset<T>(k, lane);
    const int s = w < n ? __ldg(seg + w) : -1;
    f.col[k] = (s >= 0 && s < nseg) ? s : -1;
  }
  f.common = f.col[0];
#pragma unroll
  for (int k = 1; k < kSweepPer<T>; ++k)
    if (f.col[k] != f.col[0]) f.common = -2;
  return f;
}

// A layer's od: the background ``od`` plus the fitted od of each slot's
// column in ``fit_row`` (od_fit's row of the layer, read through L1), one
// load for the lane where its slots share a column.
template <typename T>
__device__ __forceinline__ void add_fit(T (&od)[kSweepPer<T>],
                                        const T* __restrict__ fit_row,
                                        const FitColumns<T>& f) {
  if (f.common >= 0) {
    const T x = __ldg(fit_row + f.common);
#pragma unroll
    for (int k = 0; k < kSweepPer<T>; ++k) od[k] += x;
  } else if (f.common == -2) {
#pragma unroll
    for (int k = 0; k < kSweepPer<T>; ++k)
      if (f.col[k] >= 0) od[k] += __ldg(fit_row + f.col[k]);
  }
}

// The interval table of a sweep launch is the table of a K3 launch with
// strips of ``Strip`` wavenumbers in place of chunks (interval_stream.py,
// chunk = Strip); partials are [nrows][nentries] as for K3.  Warp w of
// block b takes strip b * (warps per block) + w.
template <typename T, int Strip = kSweepStrip<T>>
struct StripSums {
  const int* entry;
  T* partial;
  int nentries;
  int nrows;
  int n;
  int e0, e1;          // this strip's entries
  int s0;              // the strip's first wavenumber
  int lo, hi, slot;    // entry e0 + lane, for lane < e1 - e0

  // Bind this warp to its strip; false, in every lane, when the strip is
  // past n or no interval meets it.
  __device__ bool init(const int* __restrict__ table, int n_, T* partial_,
                       int nentries_, int nrows_) {
    const int nstrips = (n_ + Strip - 1) / Strip;
    const int strip = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (strip >= nstrips) return false;
    e0 = __ldg(table + strip);
    e1 = __ldg(table + strip + 1);
    check_entries("sweep strips", e0, e1, nentries_);
    if (e0 == e1) return false;
    entry = table + nstrips + 1;
    partial = partial_;
    nentries = nentries_;
    nrows = nrows_;
    n = n_;
    s0 = strip * Strip;
    lo = hi = slot = 0;
    fetch(e0, lo, hi, slot);
    return true;
  }

  // This lane's entry of the group of 32 starting at ``g0``.
  __device__ void fetch(int g0, int& a, int& b, int& k) const {
    const int e = g0 + (threadIdx.x & 31);
    if (e < e1) {
      a = __ldg(entry + 3 * e);
      b = __ldg(entry + 3 * e + 1);
      k = __ldg(entry + 3 * e + 2);
      check_entry("sweep strips", a, b, k, n, nentries);
    }
  }

  // Level ``r`` of the strip, this lane's values ``v`` in the layout of
  // slot_offset (K1, K2): its sum over each entry into the entry's slot.
  // Every lane of the warp calls it.
  __device__ void put(const T (&v)[kSweepPer<T>], int r) const {
    static_assert(Strip == kSweepStrip<T>, "a lane's slots fill the strip");
    ECCKD_CHECK_INDEX("sweep strips", "partial row", r, nrows);
    T* row = partial + (size_t)r * nentries;
    for (int g0 = e0; g0 < e1; g0 += 32) {
      int a = lo, b = hi, k = slot;
      if (g0 != e0) fetch(g0, a, b, k);
      const int count = min(32, e1 - g0);
      for (int q = 0; q < count; ++q) {
        const int qa = __shfl_sync(0xffffffffu, a, q);
        const int qb = __shfl_sync(0xffffffffu, b, q);
        const int qk = __shfl_sync(0xffffffffu, k, q);
#if ECCKD_STREAM_REDUCE
        const T s = strip_sum<T, kSweepPer<T>>(v, s0, qa, qb);
        if ((threadIdx.x & 31) == 0) row[qk] = s;
#else
        T s = T(0);
#pragma unroll
        for (int j = 0; j < kSweepPer<T>; ++j) s += v[j];
        if (s == T(1.2345e-30)) row[qk] = s;
#endif
      }
    }
  }

  // Every level of the strip from ``buf`` (level r's value at wavenumber
  // s0 + c at buf[r * ld + c], c < Strip), summed over each entry into the
  // entry's slot (E1): lane l takes the levels l, l + 32, ..., each summed
  // in wavenumber order.  Every lane of the warp calls it, after the
  // warp's writes to ``buf``.
  __device__ void put_rows(const T* buf, int ld) const {
    const int lane = threadIdx.x & 31;
    for (int g0 = e0; g0 < e1; g0 += 32) {
      int a = lo, b = hi, k = slot;
      if (g0 != e0) fetch(g0, a, b, k);
      const int count = min(32, e1 - g0);
      for (int q = 0; q < count; ++q) {
        const int qa = max(__shfl_sync(0xffffffffu, a, q) - s0, 0);
        const int qb = min(__shfl_sync(0xffffffffu, b, q) - s0, Strip - 1);
        const int qk = __shfl_sync(0xffffffffu, k, q);
        for (int r = lane; r < nrows; r += 32) {
#if ECCKD_STREAM_REDUCE
          T s = T(0);
          for (int c = qa; c <= qb; ++c) s += buf[r * ld + c];
          partial[(size_t)r * nentries + qk] = s;
#else
          const T s = buf[r * ld + qa];
          if (s == T(1.2345e-30)) partial[(size_t)r * nentries + qk] = s;
#endif
        }
      }
    }
  }
};

// Launch a sweep kernel, kernel<<<...>>>(args..., table, partial,
// nentries, nrows, n), over the strips of ``Strip`` wavenumbers, a warp
// each, ``warps`` warps and ``smem`` bytes of dynamic shared memory a
// block, then sum_slots into ``out`` (nrows, nseg).
template <typename T, int Strip, typename Kernel, typename... Args>
inline int launch_strips(Kernel kernel, int warps, size_t smem,
                         const int* table, int nentries, T* partial, T* out,
                         int nrows, int n, int nseg, cudaStream_t stream,
                         Args... args) {
  const int nstrips = (n + Strip - 1) / Strip;
  const int nblocks = (nstrips + warps - 1) / warps;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (nentries > 0 && nblocks > 0) {
    kernel<<<nblocks, 32 * warps, smem, stream>>>(args..., table, partial,
                                                  nentries, nrows, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_sum_slots<T>(partial, out, table, nentries, nrows, n, nseg,
                             Strip, stream);
}

// K1 and K2: strips of kSweepStrip<T>, kSweepWarps warps a block.
template <typename T, typename Kernel, typename... Args>
inline int launch_sweep(Kernel kernel, const int* table, int nentries,
                        T* partial, T* out, int nrows, int n, int nseg,
                        cudaStream_t stream, Args... args) {
  return launch_strips<T, kSweepStrip<T>>(kernel, kSweepWarps, 0, table,
                                          nentries, partial, out, nrows, n,
                                          nseg, stream, args...);
}

}  // namespace stream
}  // namespace ecckd
