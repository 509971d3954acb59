// Kernel E1: the longwave broadband sweep as affine scans across layers.
//
// Replaces the Pallas TPU kernel scripts/exp_kernels.py
// (rt_lw_bb_intervals_scan, body _sweep_scan_kernel), the round-5
// experiment that runs K1's function (sweep_lw.cu) with the layer
// recurrences written as doubling scans of affine maps.  Layer k maps the
// flux entering it to the flux leaving it, x -> trans_k * x + src_k, so the
// downward fluxes are the inclusive prefix compositions of the maps applied
// to 0 at the top of the atmosphere, and the upward fluxes the suffix
// compositions applied to the surface boundary
// surf_planck*emis + (1-emis)*flux_dn_surf.  Every level of both is summed
// over every interval [i1[j], i2[j]] that holds the wavenumber, as in K1.
//
// What bounds it on an H100: device memory, as K1.  The function reads
// planck (nlay+1 rows) and bg_od (nlay rows) once, ~0.87 GB at 2^20 x 50 in
// f64 (0.26 ms at 3.35 TB/s), against ~25 flops a layer and wavenumber.
// What the design does about it, and what makes it differ from K1:
//  * the recurrence is a scan across the layer axis, not a serial loop per
//    wavenumber: one warp takes one wavenumber, each lane LPL consecutive
//    layers (LPL = 2 at 50 layers, padded to 64), and the affine pairs are
//    composed with __shfl_up_sync for the downward pass and
//    __shfl_down_sync for the upward pass (5 steps each);
//  * rows are stored wavenumber-fastest, so a lane-per-layer layout would
//    load with a stride of nwav: the block first stages a tile of kTile
//    wavenumbers of planck and bg_od in shared memory with coalesced loads
//    (row stride kLd = kTile + 1 against bank conflicts), ~26 KB at 50
//    layers in f64;
//  * the flux levels of the tile go to shared memory as (level, wavenumber)
//    rows, the layout the deterministic reducer of interval_reduce.cuh sums
//    from: fixed-size wavenumber chunks, no floating-point atomics, so
//    repeats are bit-identical.
// Simple first: no TMA, no overlap of the staging with the scans.  The TPU
// workarounds of the Pallas kernel are not carried over: expm1 (not
// 1 - exp), a plain gather of od_fit (not a one-hot matmul), no bf16 split
// products.
#include "interval_reduce.cuh"
#include "lw_coeffs.cuh"

namespace ecckd {

constexpr int kTile = 32;         // wavenumbers staged per tile
constexpr int kLd = kTile + 1;    // row stride of the shared tiles
constexpr int kMaxLayers = 128;   // 32 lanes x 4 layers

// Dynamic shared memory of a block: the planck and bg_od tiles, the flux
// levels of the tile and the reducer's interval list.
template <typename T>
inline size_t scan_smem_bytes(int nlay, int nseg) {
  const int nlev = nlay + 1;
  return sizeof(T) * (size_t)kLd * (nlev + nlay + 2 * nlev)
         + sizeof(int) * (size_t)nseg;
}

// x -> a x + b composed after (a2, b2): (a, b) <- (a a2, a b2 + b).
template <typename T>
__device__ __forceinline__ void compose_after(T& a, T& b, T a2, T b2) {
  b = a * b2 + b;
  a = a * a2;
}

template <typename T, int LPL>
__global__ void __launch_bounds__(kThreads)
sweep_lw_scan_kernel(const T* __restrict__ planck, const T* __restrict__ bg_od,
                     const T* __restrict__ od_fit, const int* __restrict__ seg,
                     const T* __restrict__ emis,
                     const T* __restrict__ surf_planck, int nlay,
                     const int* __restrict__ i1, const int* __restrict__ i2,
                     T* __restrict__ partial, int nrows, int n, int nseg) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count;
  const int nlev = nlay + 1;
  T* s_in = reinterpret_cast<T*>(smem);    // planck rows, then bg_od rows
  T* s_bg = s_in + (size_t)nlev * kLd;
  T* s_flux = s_bg + (size_t)nlay * kLd;   // 2*nlev rows: dn, then up
  Reducer<T> red;
  red.init_list(reinterpret_cast<int*>(s_flux + (size_t)nrows * kLd),
                &s_count, i1, i2, partial, nrows, n, nseg);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kChunk;
  const int c1 = min(c0 + kChunk, n);
  for (int w0 = c0; w0 < c1; w0 += kTile) {
    const int width = min(kTile, n - w0);
    // Stage the tile: each warp reads 32 neighbouring wavenumbers of a row.
    for (int idx = threadIdx.x; idx < (nlev + nlay) * kTile;
         idx += kThreads) {
      const int r = idx / kTile, c = idx - r * kTile;
      T v = T(0);
      if (c < width)
        v = r < nlev ? planck[(size_t)r * n + w0 + c]
                     : bg_od[(size_t)(r - nlev) * n + w0 + c];
      s_in[r * kLd + c] = v;
    }
    __syncthreads();

    for (int c = warp; c < width; c += kWarps) {
      const int w = w0 + c;
      const int s = seg[w];
      const bool has_fit = s >= 0 && s < nseg;
      // This lane's layers; those at or below nlay are the identity map.
      T a[LPL], b_dn[LPL], b_up[LPL];
#pragma unroll
      for (int k = 0; k < LPL; ++k) {
        const int lay = lane * LPL + k;
        a[k] = T(1);
        b_dn[k] = T(0);
        b_up[k] = T(0);
        if (lay < nlay) {
          const T od = has_fit ? s_bg[lay * kLd + c]
                                     + od_fit[(size_t)lay * nseg + s]
                               : s_bg[lay * kLd + c];
          T coeff_top, factor;
          lw_coeffs(od, a[k], coeff_top, factor);
          const T p_top = s_in[lay * kLd + c];
          const T p_base = s_in[(lay + 1) * kLd + c];
          b_dn[k] = p_top * coeff_top + p_base * factor;
          b_up[k] = p_base * coeff_top + p_top * factor;
        }
      }

      // Downward: this lane's maps composed in layer order, then an
      // inclusive scan over the lanes (later layers after earlier ones).
      T A = T(1), B = T(0);
#pragma unroll
      for (int k = 0; k < LPL; ++k) {
        B = a[k] * B + b_dn[k];
        A = a[k] * A;
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const T a2 = __shfl_up_sync(0xffffffffu, A, d);
        const T b2 = __shfl_up_sync(0xffffffffu, B, d);
        if (lane >= d) compose_after(A, B, a2, b2);
      }
      // Maps below nlay are the identity, so the last lane holds the
      // surface flux; the lanes before this one give the flux entering it.
      const T dn_surf = __shfl_sync(0xffffffffu, B, 31);
      T flux = __shfl_up_sync(0xffffffffu, B, 1);
      if (lane == 0) {
        flux = T(0);
        s_flux[c] = T(0);    // level 0 carries no downward flux
      }
#pragma unroll
      for (int k = 0; k < LPL; ++k) {
        const int lay = lane * LPL + k;
        flux = a[k] * flux + b_dn[k];
        if (lay < nlay) s_flux[(lay + 1) * kLd + c] = flux;
      }

      // Upward: maps composed from the surface up, a suffix scan over the
      // lanes, applied to the boundary.
      const T e = emis[w];
      const T boundary = surf_planck[w] * e + (T(1) - e) * dn_surf;
      A = T(1);
      B = T(0);
#pragma unroll
      for (int k = LPL - 1; k >= 0; --k) {
        B = a[k] * B + b_up[k];
        A = a[k] * A;
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const T a2 = __shfl_down_sync(0xffffffffu, A, d);
        const T b2 = __shfl_down_sync(0xffffffffu, B, d);
        if (lane + d < 32) compose_after(A, B, a2, b2);
      }
      const T a_above = __shfl_down_sync(0xffffffffu, A, 1);
      const T b_above = __shfl_down_sync(0xffffffffu, B, 1);
      flux = lane == 31 ? boundary : a_above * boundary + b_above;
      if (lane == 0) s_flux[(nlev + nlay) * kLd + c] = boundary;
#pragma unroll
      for (int k = LPL - 1; k >= 0; --k) {
        const int lay = lane * LPL + k;
        flux = a[k] * flux + b_up[k];
        if (lay < nlay) s_flux[(nlev + lay) * kLd + c] = flux;
      }
    }
    __syncthreads();

    red.w0 = w0;
    red.reduce(s_flux, nrows, kLd, width, [](int g) { return g; });
    __syncthreads();
  }
}

template <typename T, int LPL>
int launch_scan(const void* planck, const void* bg_od, const void* od_fit,
                const void* seg, const void* emis, const void* surf_planck,
                const void* i1, const void* i2, void* partial, void* out,
                int nlay, int n, int nseg, cudaStream_t stream) {
  return launch_reduced_smem<T>(
      sweep_lw_scan_kernel<T, LPL>, scan_smem_bytes<T>(nlay, nseg),
      static_cast<T*>(partial), static_cast<T*>(out),
      static_cast<const int*>(i1), static_cast<const int*>(i2),
      2 * (nlay + 1), n, nseg, stream, static_cast<const T*>(planck),
      static_cast<const T*>(bg_od), static_cast<const T*>(od_fit),
      static_cast<const int*>(seg), static_cast<const T*>(emis),
      static_cast<const T*>(surf_planck), nlay);
}

template <typename T>
int sweep_lw_scan(const void* planck, const void* bg_od, const void* od_fit,
                  const void* seg, const void* emis, const void* surf_planck,
                  const void* i1, const void* i2, void* partial, void* out,
                  int nlay, int n, int nseg, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nlay < 1 || nlay > kMaxLayers) return (int)cudaErrorInvalidValue;
  if (nlay <= 32)
    return launch_scan<T, 1>(planck, bg_od, od_fit, seg, emis, surf_planck,
                             i1, i2, partial, out, nlay, n, nseg, st);
  if (nlay <= 64)
    return launch_scan<T, 2>(planck, bg_od, od_fit, seg, emis, surf_planck,
                             i1, i2, partial, out, nlay, n, nseg, st);
  return launch_scan<T, 4>(planck, bg_od, od_fit, seg, emis, surf_planck, i1,
                           i2, partial, out, nlay, n, nseg, st);
}

}  // namespace ecckd

extern "C" {

int ecckd_scan_max_layers() { return ecckd::kMaxLayers; }

// Wavenumbers per chunk of the reducer of interval_reduce.cuh.
int ecckd_chunk_size() { return ecckd::kChunk; }

// Inputs as ecckd_sweep_lw_f64 (sweep_lw.cu), with the bounds ``i1``, ``i2``
// in place of its table: ``out`` is (2*(nlay+1), nseg), flux_dn rows then
// flux_up rows; ``partial`` is scratch of ceil(n / ecckd_chunk_size()) *
// 2*(nlay+1) * nseg values; 1 <= nlay <= ecckd_scan_max_layers().  Returns
// the CUDA error code of the launches.
int ecckd_sweep_lw_scan_f64(const void* planck, const void* bg_od,
                            const void* od_fit, const void* seg,
                            const void* emis, const void* surf_planck,
                            const void* i1, const void* i2, void* partial,
                            void* out, int nlay, int n, int nseg,
                            void* stream) {
  return ecckd::sweep_lw_scan<double>(planck, bg_od, od_fit, seg, emis,
                                      surf_planck, i1, i2, partial, out, nlay,
                                      n, nseg, stream);
}

int ecckd_sweep_lw_scan_f32(const void* planck, const void* bg_od,
                            const void* od_fit, const void* seg,
                            const void* emis, const void* surf_planck,
                            const void* i1, const void* i2, void* partial,
                            void* out, int nlay, int n, int nseg,
                            void* stream) {
  return ecckd::sweep_lw_scan<float>(planck, bg_od, od_fit, seg, emis,
                                     surf_planck, i1, i2, partial, out, nlay,
                                     n, nseg, stream);
}

}  // extern "C"
