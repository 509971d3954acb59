// Kernel K1: longwave broadband two-stream sweep with per-interval flux sums.
//
// Replaces the Pallas TPU kernel ecckd_tpu/ops/pallas/sweep_lw.py
// (_rt_lw_bb_intervals_pallas, bodies _sweep_kernel_scan/_sweep_kernel).
// For every wavenumber w it adds the fitted grey od of interval seg[w]
// (none when seg[w] is outside [0, nseg)) to the background od, runs the
// downward recurrence from 0 at the top of the atmosphere and the upward one
// from surf_planck*emis + (1-emis)*flux_dn_surf, and sums each of the
// 2*(nlay+1) flux levels over every interval [i1[j], i2[j]] that holds w.
//
// What bounds it on an H100: device memory.  Per wavenumber and layer the
// sweep reads planck and bg_od twice (down and up pass), about 4 values, and
// does ~30 flops; at 2^20 x 50 in f64 that is ~1.7 GB of reads against
// ~1.6 GFLOP, well under the card's flop/byte balance.  The recurrences are
// a serial chain of nlay steps per wavenumber.
// What the design does about it:
//  * one thread per wavenumber keeps the recurrence in registers, so the
//    only device-memory traffic is the input reads (coalesced: neighbouring
//    threads read neighbouring wavenumbers of one row) and the small
//    per-block partials; no (nlay, nwav) temporary is ever written;
//  * the up pass recomputes the layer coefficients instead of keeping 50
//    layers of them per thread, trading a second read of the inputs for
//    registers and occupancy;
//  * the flux rows are reduced to intervals in shared memory by the
//    deterministic reducer of interval_reduce.cuh (fixed-size wavenumber
//    chunks, no atomics), since interval lengths are very unequal.
// The TPU workarounds of the Pallas kernel are not carried over: this uses
// expm1 (not 1 - exp), a plain gather of od_fit (not a one-hot matmul), and
// no bf16 split products.
#include "interval_reduce.cuh"
#include "lw_coeffs.cuh"

namespace ecckd {

template <typename T>
__global__ void __launch_bounds__(kThreads)
sweep_lw_kernel(const T* __restrict__ planck, const T* __restrict__ bg_od,
                const T* __restrict__ od_fit, const int* __restrict__ seg,
                const T* __restrict__ emis, const T* __restrict__ surf_planck,
                int nlay, const int* __restrict__ i1,
                const int* __restrict__ i2, T* __restrict__ partial,
                int nrows, int n, int nseg) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count;
  Reducer<T> red;
  red.init(smem, &s_count, i1, i2, partial, nrows, n, nseg);
  const int nlev = nlay + 1;
  const int c0 = blockIdx.x * kChunk;
  for (int t = 0; t < kTilesPerBlock; ++t) {
    const int w0 = c0 + t * kThreads;
    if (w0 >= n) break;  // the same in every thread of the block
    red.w0 = w0;
    const int w = w0 + threadIdx.x;
    const bool valid = w < n;
    const int s = valid ? seg[w] : -1;
    const bool has_fit = s >= 0 && s < nseg;
    auto layer_od = [&](int k) -> T {
      if (!valid) return T(0);
      const T bg = bg_od[(size_t)k * n + w];
      return has_fit ? bg + od_fit[(size_t)k * nseg + s] : bg;
    };
    auto planck_at = [&](int lev) -> T {
      return valid ? planck[(size_t)lev * n + w] : T(0);
    };

    // Downward sweep; level 0 (top of atmosphere) carries no flux.
    T flux = T(0);
    red.put(flux, 0);
    T p_top = planck_at(0);
    for (int k = 0; k < nlay; ++k) {
      const T p_base = planck_at(k + 1);
      T trans, coeff_top, factor;
      lw_coeffs(layer_od(k), trans, coeff_top, factor);
      flux = flux * trans + (p_top * coeff_top + p_base * factor);
      red.put(flux, k + 1);
      p_top = p_base;
    }

    // Upward sweep from the surface boundary.
    const T e = valid ? emis[w] : T(0);
    const T sp = valid ? surf_planck[w] : T(0);
    flux = sp * e + (T(1) - e) * flux;
    red.put(flux, nlev + nlay);
    T p_base = p_top;
    for (int k = nlay - 1; k >= 0; --k) {
      const T p_lay_top = planck_at(k);
      T trans, coeff_top, factor;
      lw_coeffs(layer_od(k), trans, coeff_top, factor);
      flux = flux * trans + (p_base * coeff_top + p_lay_top * factor);
      red.put(flux, nlev + k);
      p_base = p_lay_top;
    }
    red.flush();
  }
}

template <typename T>
int sweep_lw(const void* planck, const void* bg_od, const void* od_fit,
             const void* seg, const void* emis, const void* surf_planck,
             const void* i1, const void* i2, void* partial, void* out,
             int nlay, int n, int nseg, void* stream) {
  return launch_reduced<T>(
      sweep_lw_kernel<T>, static_cast<T*>(partial), static_cast<T*>(out),
      static_cast<const int*>(i1), static_cast<const int*>(i2),
      2 * (nlay + 1), n, nseg, static_cast<cudaStream_t>(stream),
      static_cast<const T*>(planck), static_cast<const T*>(bg_od),
      static_cast<const T*>(od_fit), static_cast<const int*>(seg),
      static_cast<const T*>(emis), static_cast<const T*>(surf_planck), nlay);
}

}  // namespace ecckd

extern "C" {

int ecckd_chunk_size() { return ecckd::kChunk; }

// Outputs: ``out`` is (2*(nlay+1), nseg), flux_dn rows then flux_up rows;
// ``partial`` is scratch of ceil(n / ecckd_chunk_size()) * 2*(nlay+1) * nseg
// values.  Returns the CUDA error code of the launches (0 on success).
int ecckd_sweep_lw_f64(const void* planck, const void* bg_od,
                       const void* od_fit, const void* seg, const void* emis,
                       const void* surf_planck, const void* i1,
                       const void* i2, void* partial, void* out, int nlay,
                       int n, int nseg, void* stream) {
  return ecckd::sweep_lw<double>(planck, bg_od, od_fit, seg, emis,
                                 surf_planck, i1, i2, partial, out, nlay, n,
                                 nseg, stream);
}

int ecckd_sweep_lw_f32(const void* planck, const void* bg_od,
                       const void* od_fit, const void* seg, const void* emis,
                       const void* surf_planck, const void* i1,
                       const void* i2, void* partial, void* out, int nlay,
                       int n, int nseg, void* stream) {
  return ecckd::sweep_lw<float>(planck, bg_od, od_fit, seg, emis,
                                surf_planck, i1, i2, partial, out, nlay, n,
                                nseg, stream);
}

}  // extern "C"
