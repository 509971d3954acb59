// Kernel K2: shortwave broadband sweep with per-interval flux sums.
//
// Replaces the Pallas TPU kernel ecckd_tpu/ops/pallas/sweep_sw.py
// (_rt_sw_bb_intervals_pallas) and computes what the XLA form
// ecckd_tpu/ops/rt_sw.py:rt_sw_bb_intervals computes.  For every wavenumber
// w it adds the fitted grey od of interval seg[w] (none when seg[w] is
// outside [0, nseg)) to the background od, attenuates the direct beam
// cos_sza*ssi[w] by exp(-cum/cos_sza) with cum the od summed from the top,
// and, with upwelling, reflects albedo[w]*flux_dn_surf and attenuates it by
// exp(-2*suffix) with suffix the od summed from the surface.  Each of the
// nlay+1 (or 2*(nlay+1)) flux levels is summed over every interval
// [i1[j], i2[j]] that holds w.
//
// What bounds it on an H100: device memory.  Per wavenumber and layer it
// reads bg_od once per pass (two with upwelling) and does a handful of
// flops and one exp; at 2^20 x 50 in f64 that is ~0.42 GB without
// upwelling and ~0.84 GB with it, 0.13 / 0.25 ms at the card's 3.35 TB/s.
// What the design does about it (the sweep layout of interval_stream.cuh):
//  * one warp per strip of kSweepStrip<T> wavenumbers, each lane
//    kSweepPer<T> of them (4 doubles, 8 floats): the lane keeps kSweepPer
//    running sums in registers, independent chains that hide the exp's
//    latency, and reads bg_od in 16-byte loads
//    issued a layer ahead of their use; no (nlay, nwav) temporary is
//    written;
//  * each level goes straight to the masked strip sums of the intervals
//    that meet the strip, one partial slot per (interval, strip): no shared
//    memory, no block barrier, no atomics, so repeats are bit-identical and
//    the g-point search is reproducible; strips that no interval meets are
//    not swept;
//  * od_fit (nlay x nseg, a few KB) is read through L1, one load a
//    layer for a lane whose slots share an interval;
//  * the up pass re-reads the layer od from the bottom (all but the lowest
//    layer, still in registers) and accumulates the suffix sum itself.
//    Forming it as total - prefix would cancel: in f32 a column od of ~1e3
//    leaves ~1e-4 relative error in the transmittance of the lowest layers.
// The wrapper takes nlay >= 1.
// Not carried over from the TPU kernel: the bf16 split products, the
// doubling product scan and the one-hot matmul that gathered od_fit.
#include "interval_stream.cuh"

namespace ecckd {

template <typename T>
__global__ void __launch_bounds__(stream::kSweepThreads,
                                  stream::kSweepMinBlocks<T>)
sweep_sw_kernel(const T* __restrict__ ssi, const T* __restrict__ bg_od,
                const T* __restrict__ od_fit, const int* __restrict__ seg,
                const T* __restrict__ albedo, int nlay, int nseg, T cos_sza,
                T minus_sec, int with_up, const int* __restrict__ table,
                T* __restrict__ partial, int nentries, int nrows, int n) {
  using namespace stream;
  constexpr int P = kSweepPer<T>;
  StripSums<T> sums;
  if (!sums.init(table, n, partial, nentries, nrows)) return;
  const int s0 = sums.s0;
  const int nlev = nlay + 1;
  const FitColumns<T> fit = fit_columns<T>(seg, s0, n, nseg);

  // Direct beam down from the top of the atmosphere.
  T top[P], cum[P], flux[P], od[P], next[P];
  load_strip<T, P>(ssi, s0, n, top);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    top[j] = cos_sza * top[j];
    cum[j] = T(0);
    flux[j] = top[j];
  }
  sums.put(top, 0);
  // od holds layer k's od; the next layer's bg_od is loaded a layer ahead.
  load_strip<T, P>(bg_od, s0, n, od);
  add_fit<T>(od, od_fit, fit);
  for (int k = 0; k < nlay; ++k) {
    const bool more = k + 1 < nlay;
    if (more) load_strip<T, P>(bg_od + (size_t)(k + 1) * n, s0, n, next);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      cum[j] += od[j];
      flux[j] = top[j] * exp(minus_sec * cum[j]);
    }
    sums.put(flux, k + 1);
    if (more) {
#pragma unroll
      for (int j = 0; j < P; ++j) od[j] = next[j];
      add_fit<T>(od, od_fit + (size_t)(k + 1) * nseg, fit);
    }
  }
  if (!with_up) return;

  // Reflected beam up from the surface at the two-stream secant 2.
  T boundary[P], suffix[P];
  load_strip<T, P>(albedo, s0, n, boundary);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    boundary[j] = boundary[j] * flux[j];
    suffix[j] = T(0);
  }
  sums.put(boundary, nlev + nlay);
  // od still holds the lowest layer's od from the down pass.
  for (int k = nlay - 1; k >= 0; --k) {
    if (k > 0) load_strip<T, P>(bg_od + (size_t)(k - 1) * n, s0, n, next);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      suffix[j] += od[j];
      flux[j] = boundary[j] * exp(T(-2) * suffix[j]);
    }
    sums.put(flux, nlev + k);
    if (k > 0) {
#pragma unroll
      for (int j = 0; j < P; ++j) od[j] = next[j];
      add_fit<T>(od, od_fit + (size_t)(k - 1) * nseg, fit);
    }
  }
}

template <typename T>
int sweep_sw(const void* ssi, const void* bg_od, const void* od_fit,
             const void* seg, const void* albedo, const void* table,
             void* partial, void* out, int nlay, int n, int nseg,
             int nentries, double cos_sza, int with_up, void* stream) {
  return stream::launch_sweep<T>(
      sweep_sw_kernel<T>, static_cast<const int*>(table), nentries,
      static_cast<T*>(partial), static_cast<T*>(out),
      (with_up ? 2 : 1) * (nlay + 1), n, nseg,
      static_cast<cudaStream_t>(stream), static_cast<const T*>(ssi),
      static_cast<const T*>(bg_od), static_cast<const T*>(od_fit),
      static_cast<const int*>(seg), static_cast<const T*>(albedo), nlay, nseg,
      T(cos_sza), T(-1.0 / cos_sza), with_up);
}

}  // namespace ecckd

extern "C" {

// ``table`` is the int32 interval table of the launch at strip granularity
// (interval_stream.cuh, sweeps) with ``nentries`` entries.  Outputs:
// ``out`` is (nrows, nseg) with nrows = (with_up ? 2 : 1) * (nlay+1),
// flux_dn rows then flux_up rows; ``partial`` is scratch of nrows *
// nentries values.  Returns the CUDA error code of the launches (0 on
// success).
int ecckd_sweep_sw_f64(const void* ssi, const void* bg_od, const void* od_fit,
                       const void* seg, const void* albedo, const void* table,
                       void* partial, void* out, int nlay, int n, int nseg,
                       int nentries, double cos_sza, int with_up,
                       void* stream) {
  return ecckd::sweep_sw<double>(ssi, bg_od, od_fit, seg, albedo, table,
                                 partial, out, nlay, n, nseg, nentries,
                                 cos_sza, with_up, stream);
}

int ecckd_sweep_sw_f32(const void* ssi, const void* bg_od, const void* od_fit,
                       const void* seg, const void* albedo, const void* table,
                       void* partial, void* out, int nlay, int n, int nseg,
                       int nentries, double cos_sza, int with_up,
                       void* stream) {
  return ecckd::sweep_sw<float>(ssi, bg_od, od_fit, seg, albedo, table,
                                partial, out, nlay, n, nseg, nentries,
                                cos_sza, with_up, stream);
}

}  // extern "C"
