// Kernel K4: create_lut's per-(layer, g-point) least and largest od of a
// wavenumber block.
//
// Replaces no Pallas kernel: the JAX package takes these extremes with
// jax.ops.segment_min / segment_max (ecckd_tpu/ops/average.py:460,
// gpoint_block_partials), which XLA lowers itself.  The port's plain
// version, ops/average.py:_segment_min_max, is two flattened
// scatter_reduce calls (amin, amax); on the card each of their 52M
// elements a CKDMIP block goes through a global atomic into one of only
// nz * ng targets, after a 50 x 1M int64 index built for them.
//
// What bounds it on an H100: device memory.  A (nz, nb) block is read once,
// and its g-point map once: 419 MB and 8 MB at 50 x 2^20 in float64,
// 0.13 ms at 3.35 TB/s.
// What the design does about it:
//  * a block of 256 threads takes a strip of wavenumbers and a group of
//    layers, and keeps the group's (layer, g) table of least and largest
//    od in shared memory; the number of layers a group holds follows from
//    (nz, ng), so the table fits whatever the g-point count;
//  * a thread takes 64 bytes of one layer's row at a time (four 16-byte
//    loads) with the g-points of those wavenumbers, which the threads of
//    the other layers read from L1.  Consecutive threads take consecutive
//    layers, so where a group holds 32 layers or more the lanes of a warp
//    update 32 different rows of the table, no two on one address,
//    wherever the g-points fall; the row stride is odd, so their 8-byte
//    entries lie in different banks;
//  * the table holds an order-preserving integer key of each value, so a
//    shared-memory integer atomicMin / atomicMax is the update; it is
//    issued only when the value beats the entry as last read, which after
//    the first few values of a (layer, g) is rare;
//  * at the end each block merges its table into the output with one
//    global atomic an entry it touched; a last small kernel turns the keys
//    back into values in place.
//
// The result does not depend on the order of the updates, so it is the
// same at every launch.  It equals scatter_reduce's bit for bit, with two
// exceptions where scatter_reduce's own result depends on the order of
// its atomics: -0.0 and +0.0 in one segment give -0.0 as the least and
// +0.0 as the largest; a NaN in a segment makes both its extremes the
// canonical quiet NaN (scatter_reduce keeps the NaN it met, which is the
// canonical one where the NaN came from arithmetic or float('nan')).
// A g-point below 0 or at least ng is skipped (the checked build traps on
// one at least ng); a segment with no member keeps +inf / -inf.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "checked.cuh"

namespace ecckd {
namespace minmax {

constexpr int kThreads = 256;
// Bytes of one layer's row a thread reads at a time.
constexpr int kRunBytes = 64;
// Shared memory a block's table may take: two blocks of the largest table
// fit an SM, with room left for L1.
constexpr int kTableBytes = 96 * 1024;

// Order-preserving integer key of a float: for keys a, b of values x, y,
// a < b exactly where x < y, with -0.0 below +0.0.  Its own inverse.  The
// NaN sentinels lie beyond every value's key, so a NaN is the least of a
// segment for the minimum and the largest for the maximum, and stays; no
// value has them as keys (both are NaN bit patterns).
template <typename T>
struct Key;

template <>
struct Key<double> {
  using I = long long;
  static constexpr I kMask = LLONG_MAX;
  static constexpr I kPosInf = 0x7FF0000000000000LL;
  // key of -inf: its bits 0xFFF0... with the 63 low bits flipped
  static constexpr I kNegInf = LLONG_MIN + 0x000FFFFFFFFFFFFFLL;
  static constexpr I kNan = 0x7FF8000000000000LL;
  static constexpr I kNanMin = LLONG_MIN;
  static constexpr I kNanMax = LLONG_MAX;
  __device__ static I bits(double x) { return __double_as_longlong(x); }
  __device__ static I flip(I b) { return b ^ ((b >> 63) & kMask); }
};

template <>
struct Key<float> {
  using I = int;
  static constexpr I kMask = INT_MAX;
  static constexpr I kPosInf = 0x7F800000;
  static constexpr I kNegInf = INT_MIN + 0x007FFFFF;
  static constexpr I kNan = 0x7FC00000;
  static constexpr I kNanMin = INT_MIN;
  static constexpr I kNanMax = INT_MAX;
  __device__ static I bits(float x) { return __float_as_int(x); }
  __device__ static I flip(I b) { return b ^ ((b >> 31) & kMask); }
};

template <typename T, int N>
__device__ __forceinline__ void load16(const T* p, T (&v)[N]) {
  constexpr int P = 16 / sizeof(T);
  static_assert(N % P == 0, "a run is whole 16-byte vectors");
#pragma unroll
  for (int i = 0; i < N / P; ++i) {
    union {
      uint4 u;
      T t[P];
    } w;
    w.u = __ldg(reinterpret_cast<const uint4*>(p) + i);
#pragma unroll
    for (int j = 0; j < P; ++j) v[i * P + j] = w.t[j];
  }
}

// Fill the (2, n) key output: the least's identity, then the largest's.
template <typename T>
__global__ void gpoint_scatter_minmax_init(typename Key<T>::I* keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    keys[i] = Key<T>::kPosInf;
    keys[n + i] = Key<T>::kNegInf;
  }
}

// Keys back to values, in place: the sentinels to the canonical NaN.
template <typename T>
__global__ void gpoint_scatter_minmax_finish(typename Key<T>::I* keys,
                                             int n) {
  using I = typename Key<T>::I;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 2 * n) {
    const I k = keys[i];
    const I nan_key = i < n ? I(Key<T>::kNanMin) : I(Key<T>::kNanMax);
    keys[i] = k == nan_key ? I(Key<T>::kNan) : Key<T>::flip(k);
  }
}

// One block: wavenumbers [blockIdx.x * strip, + strip) of layers
// [blockIdx.y * zpb, + zpb); its table rows are ``ldt`` keys apart.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    gpoint_scatter_minmax_kernel(const T* __restrict__ od,
                                 const long long* __restrict__ gp,
                                 typename Key<T>::I* __restrict__ keys, int nz,
                                 long long nb, int ng, int ldt, int zpb,
                                 long long strip) {
  using K = Key<T>;
  using I = typename K::I;
  constexpr int V = kRunBytes / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int z0 = blockIdx.y * zpb;
  const int nzb = min(zpb, nz - z0);
  I* tmin = reinterpret_cast<I*>(smem);
  I* tmax = tmin + zpb * ldt;
  for (int k = threadIdx.x; k < nzb * ldt; k += kThreads) {
    tmin[k] = K::kPosInf;
    tmax[k] = K::kNegInf;
  }
  __syncthreads();

  const long long c0 = blockIdx.x * strip;
  const long long c1 = min(nb, c0 + strip);
  const long long runs = (c1 - c0 + V - 1) / V;
  // Item p is run p / nzb of layer p % nzb; a step of kThreads items moves
  // (dv, dz)
  const long long items = runs * nzb;
  const int dz = kThreads % nzb;
  const int dv = kThreads / nzb;
  int z = threadIdx.x % nzb;
  long long v = threadIdx.x / nzb;
  for (long long p = threadIdx.x; p < items; p += kThreads) {
    const long long col = c0 + v * V;
    const T* row = od + (long long)(z0 + z) * nb;
    T x[V];
    long long g[V];
    if (kAligned && col + V <= c1) {
      load16(row + col, x);
      load16(gp + col, g);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const bool in = col + k < c1;
        x[k] = in ? row[col + k] : T(0);
        g[k] = in ? gp[col + k] : -1LL;
      }
    }
    I* rmin = tmin + z * ldt;
    I* rmax = tmax + z * ldt;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      ECCKD_CHECK_RANGE("segment_minmax", "g-point", g[k], LLONG_MIN,
                        ng - 1);
      if (g[k] < 0 || g[k] >= ng) continue;
      const int j = (int)g[k];
      const I key = K::flip(K::bits(x[k]));
      const bool nan = isnan(x[k]);
      const I kmin = nan ? I(K::kNanMin) : key;
      const I kmax = nan ? I(K::kNanMax) : key;
      // Entries only fall (rise), so a stale read only lets through an
      // atomic that finds nothing to do
      if (kmin < *(volatile I*)(rmin + j)) atomicMin(rmin + j, kmin);
      if (kmax > *(volatile I*)(rmax + j)) atomicMax(rmax + j, kmax);
    }
    z += dz;
    v += dv;
    if (z >= nzb) {
      z -= nzb;
      ++v;
    }
  }
  __syncthreads();

  const int n = nz * ng;
  for (int k = threadIdx.x; k < nzb * ng; k += kThreads) {
    const int zz = k / ng;
    const int j = k - zz * ng;
    const int at = (z0 + zz) * ng + j;
    ECCKD_CHECK_INDEX("segment_minmax", "output entry", at, n);
    const I lo = tmin[zz * ldt + j];
    const I hi = tmax[zz * ldt + j];
    if (lo != K::kPosInf) atomicMin(keys + at, lo);
    if (hi != K::kNegInf) atomicMax(keys + n + at, hi);
  }
}

// Layers a block holds and the stride of its table rows, for (nz, ng) and
// key type I; 0 layers where one row pair exceeds the table's room.
template <typename I>
void table_shape(int nz, int ng, int* zpb, int* ldt) {
  *ldt = ng | 1;
  const long long per_layer = 2LL * (*ldt) * sizeof(I);
  const long long fit = kTableBytes / per_layer;
  if (fit < 1) {
    *zpb = 0;
    return;
  }
  const int groups = (int)((nz + fit - 1) / fit);
  *zpb = (nz + groups - 1) / groups;
}

template <typename T, bool kAligned>
int launch_main(const T* od, const long long* gp, typename Key<T>::I* keys,
                int nz, long long nb, int ng, int zpb, int ldt,
                cudaStream_t stream) {
  using I = typename Key<T>::I;
  constexpr int V = kRunBytes / sizeof(T);
  const int smem = 2 * zpb * ldt * (int)sizeof(I);
  auto kernel = gpoint_scatter_minmax_kernel<T, kAligned>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device, sms, per_sm;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // One wave of equal strips over every resident block
  const int groups = (nz + zpb - 1) / zpb;
  const long long runs = (nb + V - 1) / V;
  long long strips = (long long)sms * (per_sm > 0 ? per_sm : 1) / groups;
  strips = strips < 1 ? 1 : (strips > runs ? runs : strips);
  const long long strip = (runs + strips - 1) / strips * V;
  const dim3 grid((unsigned)((nb + strip - 1) / strip), (unsigned)groups);
  kernel<<<grid, kThreads, smem, stream>>>(od, gp, keys, nz, nb, ng, ldt, zpb,
                                           strip);
  return (int)cudaGetLastError();
}

template <typename T>
int segment_minmax(const void* od, const void* gp_, void* out, int nz,
                   long long nb, int ng, int aligned, void* stream_) {
  using I = typename Key<T>::I;
  auto stream = static_cast<cudaStream_t>(stream_);
  auto keys = static_cast<I*>(out);
  auto gp = static_cast<const long long*>(gp_);
  const int n = nz * ng;
  if (n == 0) return 0;
  int zpb, ldt;
  table_shape<I>(nz, ng, &zpb, &ldt);
  if (zpb == 0) return (int)cudaErrorInvalidValue;
  const int blocks = (2 * n + kThreads - 1) / kThreads;
  gpoint_scatter_minmax_init<T><<<blocks, kThreads, 0, stream>>>(keys, n);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (nb > 0) {
    auto x = static_cast<const T*>(od);
    err = aligned ? launch_main<T, true>(x, gp, keys, nz, nb, ng, zpb, ldt,
                                         stream)
                  : launch_main<T, false>(x, gp, keys, nz, nb, ng, zpb, ldt,
                                          stream);
    if (err != 0) return err;
  }
  gpoint_scatter_minmax_finish<T><<<blocks, kThreads, 0, stream>>>(keys, n);
  return (int)cudaGetLastError();
}

}  // namespace minmax
}  // namespace ecckd

extern "C" {

// ``od`` is a C-contiguous (nz, nb) device array, ``gp`` its (nb,) int64
// g-points, ``out`` (2, nz, ng) of od's type: the least od of each (layer,
// g-point), then the largest.  ``aligned`` says that od and gp start on
// 16 bytes and that a row of od is a whole number of 16-byte vectors.
// Returns the CUDA error code of the launches (0 on success);
// cudaErrorInvalidValue, before any launch, where ng is too large for one
// layer's table.
int ecckd_segment_minmax_f64(const void* od, const void* gp, void* out,
                             int nz, long long nb, int ng, int aligned,
                             void* stream) {
  return ecckd::minmax::segment_minmax<double>(od, gp, out, nz, nb, ng,
                                               aligned, stream);
}

int ecckd_segment_minmax_f32(const void* od, const void* gp, void* out,
                             int nz, long long nb, int ng, int aligned,
                             void* stream) {
  return ecckd::minmax::segment_minmax<float>(od, gp, out, nz, nb, ng,
                                              aligned, stream);
}

}  // extern "C"
