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
// What bounds it on an H100: device memory, as K1, with the f64 operations
// close behind.  It reads planck (nlay+1 rows) and bg_od (nlay rows) once,
// ~0.87 GB at 2^20 x 50 in f64 (0.26 ms at 3.35 TB/s), against an expm1, a
// division and ~20 more flops a layer and wavenumber (~0.2 ms of f64
// operations), each layer's coefficients computed once, where K1 computes
// them in both passes.
// What the design does about it (the sweep layout of interval_stream.cuh):
//  * one warp per strip of kScanStrip wavenumbers (16: the level buffer
//    of a strip sets the warps an SM holds, 16 at 50 layers in f64, and
//    16 ran faster than 32 or 8 in both types, PERF.md), on the strip-granular
//    interval table, StripSums slots, [row][slot] partials and sum_slots
//    of K1 and K2: no block barrier, a strip that no interval meets is not
//    swept, and an interval's sums depend only on the data, its clamped
//    bounds and the fixed strips;
//  * the recurrence is a scan across the layer axis, not a serial loop per
//    wavenumber: a group of G lanes takes one wavenumber, each lane LPL
//    consecutive layers (G = 8 in f64 and 4 in f32, doubled until LPL <= 8;
//    at 50 layers G = 8, LPL = 7), so a warp step takes 32 / G wavenumbers
//    and the affine pairs are composed by log2(G) steps of __shfl_up_sync
//    (down) and __shfl_down_sync (up) within the group;
//  * rows are stored wavenumber-fastest, and a lane wants a wavenumber's
//    layers: the warp first copies its strip of planck and bg_od into its
//    own buffer in shared memory, a row of kScanStrip neighbouring values
//    a request, every request of the strip in flight at once (cp.async,
//    no registers held), and the steps read their columns from there.
//    Other warps of the SM compute while one waits; there is no block
//    barrier.  Each lane reading its layers from device memory instead
//    (every 32-byte sector still used whole) ran 1.3x slower (PERF.md);
//  * each layer's coefficients are computed once and kept in registers for
//    both passes;
//  * a step writes its flux levels into the columns it has read, in the
//    same buffer (level rows of kScanStrip + 1 wavenumbers), and after the
//    strip's last step StripSums::put_rows sums each level over each entry
//    of the strip, a lane per level, in wavenumber order; only __syncwarp
//    orders them.  The buffer, 2*(nlay+1) rows, sets the warps an SM
//    holds.
// The TPU workarounds of the Pallas kernel are not carried over: expm1
// (not 1 - exp), a plain gather of od_fit (not a one-hot matmul), no bf16
// split products.
#include "interval_stream.cuh"
#include "lw_coeffs.cuh"

namespace ecckd {

constexpr int kMaxLayers = 128;
constexpr int kScanStrip = 16;              // wavenumbers per warp
constexpr int kScanLd = kScanStrip + 1;     // row stride of a level buffer
constexpr int kScanWarps = 2;               // warps per block
constexpr int kScanMaxLpl = 8;              // layers per lane, at most
template <typename T> constexpr int kScanGroup = 4;   // lanes per wavenumber
template <> constexpr int kScanGroup<double> = 8;
// A floor on the blocks an SM holds (at 50 layers the level buffers allow
// 8 blocks in f64, 27.7 KB each, and 16 in f32), stated to the compiler,
// which otherwise caps the registers of some instantiations lower and
// spills (PERF.md).
template <typename T> constexpr int kScanMinBlocks = 8;
template <> constexpr int kScanMinBlocks<double> = 4;

// Dynamic shared memory of a block: a level buffer per warp.
template <typename T>
inline size_t scan_smem_bytes(int nrows) {
  return sizeof(T) * (size_t)kScanWarps * nrows * kScanLd;
}

// x -> a x + b composed after (a2, b2): (a, b) <- (a a2, a b2 + b).
template <typename T>
__device__ __forceinline__ void compose_after(T& a, T& b, T a2, T b2) {
  b = a * b2 + b;
  a = a * a2;
}

// Copy the strip's inputs into the warp's level buffer: planck's level l
// to row l, bg_od's layer l to row nlay + 1 + l, wavenumber s0 + c to
// column c (zero past n), each row as one request of kScanStrip
// neighbouring values, all of them in flight at once (cp.async, with no
// registers held), then wait for them.
template <typename T>
__device__ __forceinline__ void stage_strip(T* buf, const T* __restrict__ planck,
                                            const T* __restrict__ bg_od,
                                            int nlay, int n, int s0) {
  const int nlev = nlay + 1;
  for (int i = threadIdx.x & 31; i < (nlev + nlay) * kScanStrip; i += 32) {
    const int r = i / kScanStrip, c = i - r * kScanStrip;
    T* dst = buf + r * kScanLd + c;
    if (s0 + c < n) {
      const T* src = r < nlev ? planck + (size_t)r * n
                              : bg_od + (size_t)(r - nlev) * n;
      const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                   :: "r"(saddr), "l"(src + s0 + c), "n"(sizeof(T)));
    } else {
      *dst = T(0);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

template <typename T, int G, int LPL>
__global__ void __launch_bounds__(32 * kScanWarps, kScanMinBlocks<T>)
sweep_lw_scan_kernel(const T* __restrict__ planck, const T* __restrict__ bg_od,
                     const T* __restrict__ od_fit, const int* __restrict__ seg,
                     const T* __restrict__ emis,
                     const T* __restrict__ surf_planck, int nlay, int nseg,
                     const int* __restrict__ table, T* __restrict__ partial,
                     int nentries, int nrows, int n) {
  using namespace stream;
  constexpr int W = 32 / G;                 // wavenumbers per warp step
  constexpr int kSteps = kScanStrip / W;
  // Lanes of a group whose partial maps a scan step combines: G, or 1 in
  // the ablation's copy (scripts/ablate_kernels.py: no scans)
  constexpr int kScanWidth = G;
  static_assert(kScanStrip % W == 0, "whole steps in a strip");
  extern __shared__ __align__(16) unsigned char smem[];
  StripSums<T, kScanStrip> sums;
  if (!sums.init(table, n, partial, nentries, nrows)) return;
  const int lane = threadIdx.x & 31;
  const int m = lane % G, g = lane / G;     // member and wavenumber of a step
  const int nlev = nlay + 1;
  const int lay0 = m * LPL;
  T* buf = reinterpret_cast<T*>(smem)
           + (size_t)(threadIdx.x >> 5) * nrows * kScanLd;
  stage_strip<T>(buf, planck, bg_od, nlay, n, sums.s0);

  for (int step = 0; step < kSteps; ++step) {
    const int c = step * W + g;             // this lane's column of the strip
    const int w = sums.s0 + c;
    const int sg = w < n ? __ldg(seg + w) : -1;
    const T e = w < n ? __ldg(emis + w) : T(0);
    const T sp = w < n ? __ldg(surf_planck + w) : T(0);
    // This lane's inputs: planck at its LPL + 1 levels, bg_od of its
    // layers, read before any lane writes levels over them.
    T p[LPL + 1], od[LPL];
#pragma unroll
    for (int k = 0; k <= LPL; ++k) {
      const int l = lay0 + k;
      p[k] = l > nlay ? T(0) : buf[l * kScanLd + c];
    }
#pragma unroll
    for (int k = 0; k < LPL; ++k) {
      const int l = lay0 + k;
      od[k] = l >= nlay ? T(0) : buf[(nlev + l) * kScanLd + c];
    }
    __syncwarp();

    // This lane's layers; those at or below nlay are the identity map.
    const bool has_fit = sg >= 0 && sg < nseg;
    T a[LPL], b_dn[LPL], b_up[LPL];
#pragma unroll
    for (int k = 0; k < LPL; ++k) {
      a[k] = T(1);
      b_dn[k] = T(0);
      b_up[k] = T(0);
      const int lay = lay0 + k;
      if (lay < nlay) {
        T od_k = od[k];
        if (has_fit) od_k += __ldg(od_fit + (size_t)lay * nseg + sg);
        T coeff_top, factor;
        lw_coeffs(od_k, a[k], coeff_top, factor);
        b_dn[k] = p[k] * coeff_top + p[k + 1] * factor;
        b_up[k] = p[k + 1] * coeff_top + p[k] * factor;
      }
    }

    // Downward: this lane's maps composed in layer order, then an
    // inclusive scan over the group (later layers after earlier ones).
    T A = T(1), B = T(0);
#pragma unroll
    for (int k = 0; k < LPL; ++k) {
      B = a[k] * B + b_dn[k];
      A = a[k] * A;
    }
#pragma unroll
    for (int d = 1; d < kScanWidth; d <<= 1) {
      const T a2 = __shfl_up_sync(0xffffffffu, A, d, G);
      const T b2 = __shfl_up_sync(0xffffffffu, B, d, G);
      if (m >= d) compose_after(A, B, a2, b2);
    }
    // Maps below nlay are the identity, so the group's last lane holds the
    // surface flux; the lanes before this one give the flux entering it.
    const T dn_surf = __shfl_sync(0xffffffffu, B, G - 1, G);
    T flux = __shfl_up_sync(0xffffffffu, B, 1, G);
    if (m == 0) {
      flux = T(0);
      buf[c] = T(0);                        // level 0 carries no flux
    }
#pragma unroll
    for (int k = 0; k < LPL; ++k) {
      const int lay = lay0 + k;
      flux = a[k] * flux + b_dn[k];
      if (lay < nlay) buf[(lay + 1) * kScanLd + c] = flux;
    }

    // Upward: maps composed from the surface up, a suffix scan over the
    // group, applied to the boundary.
    const T boundary = sp * e + (T(1) - e) * dn_surf;
    A = T(1);
    B = T(0);
#pragma unroll
    for (int k = LPL - 1; k >= 0; --k) {
      B = a[k] * B + b_up[k];
      A = a[k] * A;
    }
#pragma unroll
    for (int d = 1; d < kScanWidth; d <<= 1) {
      const T a2 = __shfl_down_sync(0xffffffffu, A, d, G);
      const T b2 = __shfl_down_sync(0xffffffffu, B, d, G);
      if (m + d < G) compose_after(A, B, a2, b2);
    }
    const T a_below = __shfl_down_sync(0xffffffffu, A, 1, G);
    const T b_below = __shfl_down_sync(0xffffffffu, B, 1, G);
    flux = m == G - 1 ? boundary : a_below * boundary + b_below;
    if (m == G - 1) buf[(nlev + nlay) * kScanLd + c] = boundary;
#pragma unroll
    for (int k = LPL - 1; k >= 0; --k) {
      const int lay = lay0 + k;
      flux = a[k] * flux + b_up[k];
      if (lay < nlay) buf[(nlev + lay) * kScanLd + c] = flux;
    }
  }
  __syncwarp();
  sums.put_rows(buf, kScanLd);
}

// A kernel shape: G lanes a wavenumber, LPL layers a lane.
template <int G, int LPL>
struct Shape {
  static constexpr int kGroup = G;
  static constexpr int kLpl = LPL;
};

// f(Shape<G, LPL>{}) for G from LPL = lpl to kScanMaxLpl.
template <int G, int Lo, typename F>
int visit_lpl(int lpl, F&& f) {
  if constexpr (Lo > kScanMaxLpl) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (lpl == Lo) return f(Shape<G, Lo>{});
    return visit_lpl<G, Lo + 1>(lpl, f);
  }
}

// f(Shape<G, LPL>{}) of the kernel that takes ``nlay`` layers: G =
// kScanGroup<T>, doubled until LPL = ceil(nlay / G) <= kScanMaxLpl.
template <typename T, typename F>
int visit_shape(int nlay, F&& f) {
  if (nlay < 1 || nlay > kMaxLayers) return (int)cudaErrorInvalidValue;
  int group = kScanGroup<T>;
  while (group * kScanMaxLpl < nlay) group *= 2;
  const int lpl = (nlay + group - 1) / group;
  // A group wider than kScanGroup<T> takes more than kScanMaxLpl / 2
  // layers a lane, else the narrower group would
  constexpr int kHalf = kScanMaxLpl / 2 + 1;
  if constexpr (kScanGroup<T> == 4) {
    if (group == 4) return visit_lpl<4, 1>(lpl, f);
  }
  if (group == 8)
    return visit_lpl<8, kScanGroup<T> == 8 ? 1 : kHalf>(lpl, f);
  return visit_lpl<16, kHalf>(lpl, f);
}

template <typename T>
int sweep_lw_scan(const void* planck, const void* bg_od, const void* od_fit,
                  const void* seg, const void* emis, const void* surf_planck,
                  const void* table, void* partial, void* out, int nlay,
                  int n, int nseg, int nentries, void* stream) {
  const int nrows = 2 * (nlay + 1);
  return visit_shape<T>(nlay, [&](auto shape) {
    using S = decltype(shape);
    return stream::launch_strips<T, kScanStrip>(
        sweep_lw_scan_kernel<T, S::kGroup, S::kLpl>, kScanWarps,
        scan_smem_bytes<T>(nrows), static_cast<const int*>(table), nentries,
        static_cast<T*>(partial), static_cast<T*>(out), nrows, n, nseg,
        static_cast<cudaStream_t>(stream), static_cast<const T*>(planck),
        static_cast<const T*>(bg_od), static_cast<const T*>(od_fit),
        static_cast<const int*>(seg), static_cast<const T*>(emis),
        static_cast<const T*>(surf_planck), nlay, nseg);
  });
}

}  // namespace ecckd

extern "C" {

int ecckd_scan_max_layers() { return ecckd::kMaxLayers; }

// Wavenumbers per strip of E1 (the chunk of its interval table).
int ecckd_scan_strip_size() { return ecckd::kScanStrip; }

// Inputs and outputs as ecckd_sweep_lw_f64 (sweep_lw.cu), with ``table``
// the int32 interval table of the launch at E1's strip
// (ecckd_scan_strip_size()) and ``nentries`` entries: ``out`` is
// (2*(nlay+1), nseg), flux_dn rows then flux_up rows; ``partial`` is
// scratch of 2*(nlay+1) * nentries values; 1 <= nlay <=
// ecckd_scan_max_layers().  Returns the CUDA error code of the launches.
int ecckd_sweep_lw_scan_f64(const void* planck, const void* bg_od,
                            const void* od_fit, const void* seg,
                            const void* emis, const void* surf_planck,
                            const void* table, void* partial, void* out,
                            int nlay, int n, int nseg, int nentries,
                            void* stream) {
  return ecckd::sweep_lw_scan<double>(planck, bg_od, od_fit, seg, emis,
                                      surf_planck, table, partial, out, nlay,
                                      n, nseg, nentries, stream);
}

int ecckd_sweep_lw_scan_f32(const void* planck, const void* bg_od,
                            const void* od_fit, const void* seg,
                            const void* emis, const void* surf_planck,
                            const void* table, void* partial, void* out,
                            int nlay, int n, int nseg, int nentries,
                            void* stream) {
  return ecckd::sweep_lw_scan<float>(planck, bg_od, od_fit, seg, emis,
                                     surf_planck, table, partial, out, nlay,
                                     n, nseg, nentries, stream);
}

}  // extern "C"
