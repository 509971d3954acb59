// Kernel E2: the interval sums of the LW candidate cost in one pass.
//
// Replaces the Pallas TPU kernel scripts/exp_kernels.py (fused_sums_pallas,
// body _isum_kernel), the round-5 experiment that specialises K3
// (interval_sum.cu) to the rows the LW transmission fit and the truth
// fluxes need.  Per wavenumber w it forms the 3*nlay + 2 rows
//   metric[k][w] * planck[k+1][w]   (fit numerator,   k < nlay)
//   planck[k+1][w]                  (fit denominator, k < nlay)
//   hr[k][w]                        (truth heating rate, k < nlay)
//   fd_surf[w], fu_toa[w]           (truth boundary fluxes)
// and sums each over every inclusive interval [i1[j], i2[j]] that holds w.
//
// What bounds it on an H100: device memory.  It reads metric, planck[1:]
// and hr (nlay rows each) and two more rows once: ~1.27 GB at 2^20 x 50 in
// f64, 0.38 ms at 3.35 TB/s, against one multiply and 3*nlay + 2 adds a
// wavenumber.
// What the design does about it:
//  * one thread per wavenumber reads each operand value once (coalesced
//    across the threads of a warp) and forms the product in registers; the
//    denominator row reuses the planck value it already holds;
//  * against K3 it needs no deduplicated operand-pointer table and no
//    per-row lookups of parts and operands: the row layout is fixed at
//    compile time;
//  * the rows go through K1-K3's deterministic reducer
//    (interval_reduce.cuh): fixed-size wavenumber chunks, no
//    floating-point atomics, bit-identical repeats.  Each row is summed in
//    the same order as K3 sums it.
// The TPU kernel's bf16 split of the membership matmul is not carried over.
#include "interval_reduce.cuh"

namespace ecckd {

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_sums_lw_kernel(const T* __restrict__ metric,
                     const T* __restrict__ planck, const T* __restrict__ hr,
                     const T* __restrict__ fd_surf,
                     const T* __restrict__ fu_toa, int nlay,
                     const int* __restrict__ i1, const int* __restrict__ i2,
                     T* __restrict__ partial, int nrows, int n, int nseg) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count;
  Reducer<T> red;
  red.init(smem, &s_count, i1, i2, partial, nrows, n, nseg);
  const int c0 = blockIdx.x * kChunk;
  for (int t = 0; t < kTilesPerBlock; ++t) {
    const int w0 = c0 + t * kThreads;
    if (w0 >= n) break;  // the same in every thread of the block
    red.w0 = w0;
    const int w = w0 + threadIdx.x;
    const bool valid = w < n;
    for (int k = 0; k < nlay; ++k) {
      const size_t at = (size_t)k * n + w;
      const T p = valid ? planck[at + n] : T(0);   // planck row k + 1
      const T m = valid ? metric[at] : T(0);
      const T h = valid ? hr[at] : T(0);
      red.put(m * p, k);
      red.put(p, nlay + k);
      red.put(h, 2 * nlay + k);
    }
    red.put(valid ? fd_surf[w] : T(0), 3 * nlay);
    red.put(valid ? fu_toa[w] : T(0), 3 * nlay + 1);
    red.flush();
  }
}

template <typename T>
int fused_sums_lw(const void* metric, const void* planck, const void* hr,
                  const void* fd_surf, const void* fu_toa, const void* i1,
                  const void* i2, void* partial, void* out, int nlay, int n,
                  int nseg, void* stream) {
  return launch_reduced<T>(
      fused_sums_lw_kernel<T>, static_cast<T*>(partial), static_cast<T*>(out),
      static_cast<const int*>(i1), static_cast<const int*>(i2),
      3 * nlay + 2, n, nseg, static_cast<cudaStream_t>(stream),
      static_cast<const T*>(metric), static_cast<const T*>(planck),
      static_cast<const T*>(hr), static_cast<const T*>(fd_surf),
      static_cast<const T*>(fu_toa), nlay);
}

}  // namespace ecckd

extern "C" {

// ``metric`` and ``hr`` are (nlay, n), ``planck`` (nlay+1, n), ``fd_surf``
// and ``fu_toa`` (n,); ``out`` is (3*nlay+2, nseg); ``partial`` is scratch
// of ceil(n / ecckd_chunk_size()) * (3*nlay+2) * nseg values.  Returns the
// CUDA error code of the launches (0 on success).
int ecckd_fused_sums_lw_f64(const void* metric, const void* planck,
                            const void* hr, const void* fd_surf,
                            const void* fu_toa, const void* i1,
                            const void* i2, void* partial, void* out,
                            int nlay, int n, int nseg, void* stream) {
  return ecckd::fused_sums_lw<double>(metric, planck, hr, fd_surf, fu_toa, i1,
                                      i2, partial, out, nlay, n, nseg,
                                      stream);
}

int ecckd_fused_sums_lw_f32(const void* metric, const void* planck,
                            const void* hr, const void* fd_surf,
                            const void* fu_toa, const void* i1,
                            const void* i2, void* partial, void* out,
                            int nlay, int n, int nseg, void* stream) {
  return ecckd::fused_sums_lw<float>(metric, planck, hr, fd_surf, fu_toa, i1,
                                     i2, partial, out, nlay, n, nseg, stream);
}

}  // extern "C"
