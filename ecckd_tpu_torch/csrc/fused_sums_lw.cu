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
//  * the row layout is fixed at compile time: an item is a layer k, whose
//    three rows come from one 16-byte load stream each of metric, planck
//    and hr; the denominator row is the planck value already loaded;
//  * the streaming and the reduction are those of K3
//    (interval_stream.cuh), so each row is summed in the same order as K3
//    sums it: E2's sums equal K3's bit for bit on the same parts.
// The TPU kernel's bf16 split of the membership matmul is not carried over.
#include "interval_stream.cuh"

namespace ecckd {

template <typename T>
struct LwRows {
  static constexpr int kRows = 3;
  static constexpr int kItems = 3;
  const T* metric;
  const T* planck;
  const T* hr;
  const T* fd_surf;
  const T* fu_toa;
  int nlay;

  __device__ void stage(int, unsigned char*) {}

  // Item k < nlay: rows k (metric * planck), nlay + k (planck) and
  // 2*nlay + k (hr); item nlay: rows 3*nlay (fd_surf) and 3*nlay + 1.
  __device__ int row(int item, int q) const {
    if (item < nlay) return q * nlay + item;
    return item == nlay && q < 2 ? 3 * nlay + q : -1;
  }

  __device__ void load(int item, int s0, int n,
                       T (&v)[kRows][stream::kPer<T>]) const {
    constexpr int P = stream::kPer<T>;
    if (item < nlay) {
      const size_t at = (size_t)item * n;
      stream::load_strip<T>(metric + at, s0, n, v[0]);
      stream::load_strip<T>(planck + at + n, s0, n, v[1]);  // row item + 1
      stream::load_strip<T>(hr + at, s0, n, v[2]);
#pragma unroll
      for (int k = 0; k < P; ++k) v[0][k] = stream::mul(v[0][k], v[1][k]);
    } else {
      stream::load_strip<T>(fd_surf, s0, n, v[0]);
      stream::load_strip<T>(fu_toa, s0, n, v[1]);
#pragma unroll
      for (int k = 0; k < P; ++k) v[2][k] = T(0);
    }
  }
};

template <typename T>
int fused_sums_lw(const void* metric, const void* planck, const void* hr,
                  const void* fd_surf, const void* fu_toa, const void* table,
                  void* partial, void* out, int nlay, int n, int nseg,
                  int nentries, int cmax, void* stream) {
  using Src = LwRows<T>;
  Src src{static_cast<const T*>(metric), static_cast<const T*>(planck),
          static_cast<const T*>(hr), static_cast<const T*>(fd_surf),
          static_cast<const T*>(fu_toa), nlay};
  const int ngroups = (nlay + 1 + Src::kItems - 1) / Src::kItems;
  return stream::launch<T>(src, ngroups, static_cast<const int*>(table),
                           nentries, cmax, 0, static_cast<T*>(partial),
                           static_cast<T*>(out), 3 * nlay + 2, n, nseg,
                           static_cast<cudaStream_t>(stream));
}

}  // namespace ecckd

extern "C" {

// ``metric`` and ``hr`` are (nlay, n), ``planck`` (nlay+1, n), ``fd_surf``
// and ``fu_toa`` (n,); ``table`` the int32 interval table of
// interval_stream.cuh (as for ecckd_interval_sum_*); ``out`` is
// (3*nlay+2, nseg); ``partial`` scratch of (slots in the table) *
// (3*nlay+2) values.  Returns the CUDA error code of the launches (0 on
// success).
int ecckd_fused_sums_lw_f64(const void* metric, const void* planck,
                            const void* hr, const void* fd_surf,
                            const void* fu_toa, const void* table,
                            void* partial, void* out, int nlay, int n,
                            int nseg, int nentries, int cmax, void* stream) {
  return ecckd::fused_sums_lw<double>(metric, planck, hr, fd_surf, fu_toa,
                                      table, partial, out, nlay, n, nseg,
                                      nentries, cmax, stream);
}

int ecckd_fused_sums_lw_f32(const void* metric, const void* planck,
                            const void* hr, const void* fd_surf,
                            const void* fu_toa, const void* table,
                            void* partial, void* out, int nlay, int n,
                            int nseg, int nentries, int cmax, void* stream) {
  return ecckd::fused_sums_lw<float>(metric, planck, hr, fd_surf, fu_toa,
                                     table, partial, out, nlay, n, nseg,
                                     nentries, cmax, stream);
}

}  // extern "C"
