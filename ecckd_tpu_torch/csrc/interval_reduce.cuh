// Deterministic per-interval reduction of kernel E1 (sweep_lw_scan.cu), the
// round-5 experiment's LW sweep.  The other kernels sum on the streaming
// core of interval_stream.cuh.
//
// A kernel here produces, per wavenumber w, a set of rows v[r](w) and
// needs S[r][j] = sum of v[r](w) over w in the inclusive interval
// [i1[j], i2[j]].  Intervals may overlap (a shared boundary index belongs to
// both), repeat (the front-padded [0, 0] bucket columns) and differ in length
// by orders of magnitude (one equipartition interval can hold half a band).
//
// Design:
//  * The wavenumber axis is cut into fixed chunks of kChunk = kThreads *
//    kTilesPerBlock wavenumbers, one block per chunk, independent of the
//    interval layout, so a long interval spreads over many blocks.
//  * The kernel lays a tile's rows out in shared memory (rows over a tile
//    of wavenumbers) and hands them to reduce(): each warp takes (row,
//    interval) pairs and sums the interval's part of the tile with a fixed
//    lane-strided loop and a fixed shuffle tree.
//  * Tile sums go into the block's own slice of a partial buffer
//    (read-modify-write by one lane, ordered by the tile loop), and a second
//    kernel adds the slices of the blocks an interval meets in block order.
// No floating-point atomics anywhere: the result depends only on the
// inputs, never on scheduling, so repeated runs are bit-identical.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace ecckd {

constexpr int kThreads = 256;
constexpr int kTilesPerBlock = 16;
constexpr int kChunk = kThreads * kTilesPerBlock;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
struct Reducer {
  int* list;       // intervals that meet this block's chunk
  int count;       // entries of list
  const int* i1;
  const int* i2;
  T* partial;      // this block's [nrows][nseg] slice
  int n;
  int nseg;
  int w0;          // first wavenumber of the current tile

  // Every thread of the block calls this first.  ``s_count`` is a
  // __shared__ int of the caller; ``list_`` is shared memory for ``nseg_``
  // ints.
  __device__ void init_list(int* list_, int* s_count, const int* i1_,
                            const int* i2_, T* partial_all, int nrows,
                            int n_, int nseg_) {
    list = list_;
    i1 = i1_;
    i2 = i2_;
    n = n_;
    nseg = nseg_;
    partial = partial_all + (size_t)blockIdx.x * nrows * nseg;
    const int c0 = blockIdx.x * kChunk;
    const int c1 = min(c0 + kChunk, n) - 1;
    if (threadIdx.x == 0) *s_count = 0;
    __syncthreads();
    // The order of the list is arbitrary, but no value depends on it:
    // each (row, interval) pair has its own accumulator.
    for (int j = threadIdx.x; j < nseg; j += kThreads) {
      const int lo = max(i1[j], 0), hi = min(i2[j], n - 1);
      if (lo <= hi && lo <= c1 && hi >= c0) list[atomicAdd(s_count, 1)] = j;
    }
    __syncthreads();
    count = *s_count;
    for (int p = threadIdx.x; p < nrows * count; p += kThreads) {
      const int r = p / count;
      partial[(size_t)r * nseg + list[p - r * count]] = T(0);
    }
    __syncthreads();
  }

  // Add rows g < nrows_buf of ``buf`` (row g at buf + g * ld, wavenumbers
  // w0 .. w0 + width - 1) into the partial slice at output rows row_of(g).
  // Every thread of the block calls it, between barriers.
  template <typename RowOf>
  __device__ void reduce(const T* buf, int nrows_buf, int ld, int width,
                         RowOf row_of) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int p = warp; p < nrows_buf * count; p += kWarps) {
      const int g = p / count;
      const int j = list[p - g * count];
      const int lo = max(max(i1[j], 0), w0) - w0;
      const int hi = min(min(i2[j], n - 1), w0 + width - 1) - w0;
      if (lo > hi) continue;  // the same in every lane of the warp
      T s = T(0);
      for (int k = lo + lane; k <= hi; k += 32) s += buf[g * ld + k];
      s = warp_sum(s);
      if (lane == 0) partial[(size_t)row_of(g) * nseg + j] += s;
    }
  }
};

// out[r][j] = sum over the blocks that interval j meets, in block order.
template <typename T>
__global__ void sum_partials(const T* __restrict__ partial, T* __restrict__ out,
                             const int* __restrict__ i1,
                             const int* __restrict__ i2, int nrows, int nseg,
                             int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nrows * nseg) return;
  const int r = idx / nseg, j = idx - r * nseg;
  const int lo = max(i1[j], 0), hi = min(i2[j], n - 1);
  T s = T(0);
  if (lo <= hi)
    for (int b = lo / kChunk; b <= hi / kChunk; ++b)
      s += partial[((size_t)b * nrows + r) * nseg + j];
  out[idx] = s;
}

// Launch ``kernel`` over the chunks with ``smem`` bytes of dynamic shared
// memory, then the block-order sum into ``out``.
template <typename T, typename Kernel, typename... Args>
inline int launch_reduced_smem(Kernel kernel, size_t smem, T* partial, T* out,
                               const int* i1, const int* i2, int nrows, int n,
                               int nseg, cudaStream_t stream, Args... args) {
  const int nblocks = (n + kChunk - 1) / kChunk;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (nblocks > 0 && nseg > 0) {
    kernel<<<nblocks, kThreads, smem, stream>>>(args..., i1, i2, partial,
                                                nrows, n, nseg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int total = nrows * nseg;
  if (total > 0) {
    sum_partials<T><<<(total + 255) / 256, 256, 0, stream>>>(
        partial, out, i1, i2, nrows, nseg, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace ecckd
