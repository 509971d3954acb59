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
// What bounds it on an H100: device memory, with the f64 operations close
// behind.  Per wavenumber and layer the sweep reads planck and bg_od in
// both passes and does an expm1, a division and ~20 more flops per pass;
// at 2^20 x 50 in f64 that is ~1.7 GB of reads (0.51 ms at 3.35 TB/s)
// against ~2 GFLOP (~0.2 ms at 34 TFLOP/s).  The recurrences are a serial
// chain of nlay steps per wavenumber.
// What the design does about it (the sweep layout of interval_stream.cuh):
//  * one warp per strip of kSweepStrip<T> wavenumbers, each lane
//    kSweepPer<T> of them (4 doubles, 8 floats), so a lane runs kSweepPer
//    independent recurrences in registers: their expm1s and divisions
//    overlap where one chain would wait;
//  * planck and bg_od come in 16-byte loads issued a layer ahead of their
//    use; no (nlay, nwav) temporary is ever written;
//  * the up pass recomputes the layer coefficients instead of keeping 50
//    layers of them per wavenumber, trading a second read of the inputs
//    (all but the lowest layer, still in registers) for registers;
//  * each level goes straight to the masked strip sums of the intervals
//    that meet the strip, one partial slot per (interval, strip): no shared
//    memory, no block barrier, no atomics, so repeats are bit-identical;
//    strips that no interval meets are not swept;
//  * od_fit (nlay x nseg, a few KB) is read through L1, one load a
//    layer for a lane whose slots share an interval.
// The layer coefficients are lw_coeffs.cuh's, as in E1.  The TPU
// workarounds of the Pallas kernel are not carried over: this uses expm1
// (not 1 - exp), a plain gather of od_fit (not a one-hot matmul), and no
// bf16 split products.  The wrapper takes nlay >= 1.
#include "interval_stream.cuh"
#include "lw_coeffs.cuh"

namespace ecckd {

template <typename T>
__global__ void __launch_bounds__(stream::kSweepThreads,
                                  stream::kSweepMinBlocks<T>)
sweep_lw_kernel(const T* __restrict__ planck, const T* __restrict__ bg_od,
                const T* __restrict__ od_fit, const int* __restrict__ seg,
                const T* __restrict__ emis, const T* __restrict__ surf_planck,
                int nlay, int nseg, const int* __restrict__ table,
                T* __restrict__ partial, int nentries, int nrows, int n) {
  using namespace stream;
  constexpr int P = kSweepPer<T>;
  StripSums<T> sums;
  if (!sums.init(table, n, partial, nentries, nrows)) return;
  const int s0 = sums.s0;
  const int nlev = nlay + 1;
  const FitColumns<T> fit = fit_columns<T>(seg, s0, n, nseg);

  // Downward sweep; level 0 (top of atmosphere) carries no flux.  Layer k
  // lies between levels k (p_top) and k + 1 (p_base); the next layer's
  // planck and bg_od rows are loaded a layer ahead.
  T flux[P], p_top[P], p_base[P], od[P], p_next[P], od_next[P];
#pragma unroll
  for (int j = 0; j < P; ++j) flux[j] = T(0);
  sums.put(flux, 0);
  load_strip<T, P>(planck, s0, n, p_top);
  load_strip<T, P>(planck + n, s0, n, p_base);
  load_strip<T, P>(bg_od, s0, n, od);
  add_fit<T>(od, od_fit, fit);
  for (int k = 0; k < nlay; ++k) {
    const bool more = k + 1 < nlay;
    if (more) {
      load_strip<T, P>(planck + (size_t)(k + 2) * n, s0, n, p_next);
      load_strip<T, P>(bg_od + (size_t)(k + 1) * n, s0, n, od_next);
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      T trans, coeff_top, factor;
      lw_coeffs(od[j], trans, coeff_top, factor);
      flux[j] = flux[j] * trans + (p_top[j] * coeff_top + p_base[j] * factor);
    }
    sums.put(flux, k + 1);
    if (more) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        p_top[j] = p_base[j];
        p_base[j] = p_next[j];
        od[j] = od_next[j];
      }
      add_fit<T>(od, od_fit + (size_t)(k + 1) * nseg, fit);
    }
  }

  // Upward sweep from the surface boundary.  The lowest layer's od and
  // its two levels are still in registers.
  {
    T e[P], sp[P];
    load_strip<T, P>(emis, s0, n, e);
    load_strip<T, P>(surf_planck, s0, n, sp);
#pragma unroll
    for (int j = 0; j < P; ++j)
      flux[j] = sp[j] * e[j] + (T(1) - e[j]) * flux[j];
  }
  sums.put(flux, nlev + nlay);
  for (int k = nlay - 1; k >= 0; --k) {
    const bool more = k > 0;
    if (more) {
      load_strip<T, P>(planck + (size_t)(k - 1) * n, s0, n, p_next);
      load_strip<T, P>(bg_od + (size_t)(k - 1) * n, s0, n, od_next);
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      T trans, coeff_top, factor;
      lw_coeffs(od[j], trans, coeff_top, factor);
      flux[j] = flux[j] * trans + (p_base[j] * coeff_top + p_top[j] * factor);
    }
    sums.put(flux, nlev + k);
    if (more) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        p_base[j] = p_top[j];
        p_top[j] = p_next[j];
        od[j] = od_next[j];
      }
      add_fit<T>(od, od_fit + (size_t)(k - 1) * nseg, fit);
    }
  }
}

template <typename T>
int sweep_lw(const void* planck, const void* bg_od, const void* od_fit,
             const void* seg, const void* emis, const void* surf_planck,
             const void* table, void* partial, void* out, int nlay, int n,
             int nseg, int nentries, void* stream) {
  return stream::launch_sweep<T>(
      sweep_lw_kernel<T>, static_cast<const int*>(table), nentries,
      static_cast<T*>(partial), static_cast<T*>(out), 2 * (nlay + 1), n,
      nseg, static_cast<cudaStream_t>(stream), static_cast<const T*>(planck),
      static_cast<const T*>(bg_od), static_cast<const T*>(od_fit),
      static_cast<const int*>(seg), static_cast<const T*>(emis),
      static_cast<const T*>(surf_planck), nlay, nseg);
}

}  // namespace ecckd

extern "C" {

// Wavenumbers per strip of the sweeps K1 and K2 (the chunk of their
// interval tables) for values of ``bytes`` bytes (8 or 4).
int ecckd_sweep_strip_size(int bytes) {
  return bytes == 8 ? ecckd::stream::kSweepStrip<double>
                    : ecckd::stream::kSweepStrip<float>;
}

// ``table`` is the int32 interval table of the launch at strip granularity
// (interval_stream.cuh, sweeps) with ``nentries`` entries.  Outputs:
// ``out`` is (2*(nlay+1), nseg), flux_dn rows then flux_up rows; ``partial``
// is scratch of 2*(nlay+1) * nentries values.  Returns the CUDA error code
// of the launches (0 on success).
int ecckd_sweep_lw_f64(const void* planck, const void* bg_od,
                       const void* od_fit, const void* seg, const void* emis,
                       const void* surf_planck, const void* table,
                       void* partial, void* out, int nlay, int n, int nseg,
                       int nentries, void* stream) {
  return ecckd::sweep_lw<double>(planck, bg_od, od_fit, seg, emis,
                                 surf_planck, table, partial, out, nlay, n,
                                 nseg, nentries, stream);
}

int ecckd_sweep_lw_f32(const void* planck, const void* bg_od,
                       const void* od_fit, const void* seg, const void* emis,
                       const void* surf_planck, const void* table,
                       void* partial, void* out, int nlay, int n, int nseg,
                       int nentries, void* stream) {
  return ecckd::sweep_lw<float>(planck, bg_od, od_fit, seg, emis,
                                surf_planck, table, partial, out, nlay, n,
                                nseg, nentries, stream);
}

}  // extern "C"
