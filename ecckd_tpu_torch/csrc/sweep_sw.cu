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
// flops and one exp; at 2^20 x 50 in f64 that is ~0.84 GB with upwelling,
// ~0.25 ms at the card's 3.35 TB/s.  od_fit is a few KB and stays cached.
// What the design does about it:
//  * one thread per wavenumber keeps the running sum in registers, reads
//    bg_od coalesced, and writes no (nlay, nwav) temporary;
//  * the up pass re-reads the layer od from the bottom and accumulates the
//    suffix sum itself.  Forming it as total - prefix would cancel: in f32
//    a column od of ~1e3 leaves ~1e-4 relative error in the transmittance
//    of the lowest layers;
//  * the flux rows go to the deterministic reducer of interval_reduce.cuh
//    (fixed 4096-wavenumber chunks, no atomics), so repeated runs are
//    bit-identical and the g-point search is reproducible.
// Not carried over from the TPU kernel: the bf16 split products, the
// doubling product scan and the one-hot matmul that gathered od_fit.
#include "interval_reduce.cuh"

namespace ecckd {

template <typename T>
__global__ void __launch_bounds__(kThreads)
sweep_sw_kernel(const T* __restrict__ ssi, const T* __restrict__ bg_od,
                const T* __restrict__ od_fit, const int* __restrict__ seg,
                const T* __restrict__ albedo, int nlay, T cos_sza,
                T minus_sec, int with_up, const int* __restrict__ i1,
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

    // Direct beam down from the top of the atmosphere.
    const T top = valid ? cos_sza * ssi[w] : T(0);
    red.put(top, 0);
    T cum = T(0);
    T flux = top;
    for (int k = 0; k < nlay; ++k) {
      cum += layer_od(k);
      flux = top * exp(minus_sec * cum);
      red.put(flux, k + 1);
    }

    // Reflected beam up from the surface at the two-stream secant 2.
    if (with_up) {
      const T boundary = (valid ? albedo[w] : T(0)) * flux;
      red.put(boundary, nlev + nlay);
      T suffix = T(0);
      for (int k = nlay - 1; k >= 0; --k) {
        suffix += layer_od(k);
        red.put(boundary * exp(T(-2) * suffix), nlev + k);
      }
    }
    red.flush();
  }
}

template <typename T>
int sweep_sw(const void* ssi, const void* bg_od, const void* od_fit,
             const void* seg, const void* albedo, const void* i1,
             const void* i2, void* partial, void* out, int nlay, int n,
             int nseg, double cos_sza, int with_up, void* stream) {
  return launch_reduced<T>(
      sweep_sw_kernel<T>, static_cast<T*>(partial), static_cast<T*>(out),
      static_cast<const int*>(i1), static_cast<const int*>(i2),
      (with_up ? 2 : 1) * (nlay + 1), n, nseg,
      static_cast<cudaStream_t>(stream), static_cast<const T*>(ssi),
      static_cast<const T*>(bg_od), static_cast<const T*>(od_fit),
      static_cast<const int*>(seg), static_cast<const T*>(albedo), nlay,
      T(cos_sza), T(-1.0 / cos_sza), with_up);
}

}  // namespace ecckd

extern "C" {

// Outputs: ``out`` is (nrows, nseg) with nrows = (with_up ? 2 : 1) *
// (nlay+1), flux_dn rows then flux_up rows; ``partial`` is scratch of
// ceil(n / ecckd_chunk_size()) * nrows * nseg values.  Returns the CUDA
// error code of the launches (0 on success).
int ecckd_sweep_sw_f64(const void* ssi, const void* bg_od, const void* od_fit,
                       const void* seg, const void* albedo, const void* i1,
                       const void* i2, void* partial, void* out, int nlay,
                       int n, int nseg, double cos_sza, int with_up,
                       void* stream) {
  return ecckd::sweep_sw<double>(ssi, bg_od, od_fit, seg, albedo, i1, i2,
                                 partial, out, nlay, n, nseg, cos_sza,
                                 with_up, stream);
}

int ecckd_sweep_sw_f32(const void* ssi, const void* bg_od, const void* od_fit,
                       const void* seg, const void* albedo, const void* i1,
                       const void* i2, void* partial, void* out, int nlay,
                       int n, int nseg, double cos_sza, int with_up,
                       void* stream) {
  return ecckd::sweep_sw<float>(ssi, bg_od, od_fit, seg, albedo, i1, i2,
                                partial, out, nlay, n, nseg, cos_sza,
                                with_up, stream);
}

}  // extern "C"
