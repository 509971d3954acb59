// Layer coefficients of the longwave broadband sweep, shared by kernels K1
// (sweep_lw.cu) and E1 (sweep_lw_scan.cu).
#pragma once

#include <cuda_runtime.h>

namespace ecckd {

// Clamped broadband emissivity coefficients (ecckd_tpu/ops/rt_lw.py,
// _emissivity_factor_bb; ref radiative_transfer_lw.cpp:104-126).  The
// constants are rounded from double once, as the JAX and PyTorch
// versions do with their Python scalars.
template <typename T>
__device__ __forceinline__ void lw_coeffs(T od, T& trans, T& coeff_top,
                                          T& factor) {
  const T diffusivity = T(1.66);
  const T inv_diffusivity = T(1.0 / 1.66);
  const T te = T(1.0e-5);
  const T od_floor = T(1.0e-5 / 1.66);
  const T half_te = T(0.5e-5);
  const T e = -expm1(-diffusivity * od);
  factor = fmax(T(1) - inv_diffusivity * fmax(e, te) / fmax(od, od_floor),
                half_te);
  trans = T(1) - e;
  coeff_top = e - factor;
}

}  // namespace ecckd
