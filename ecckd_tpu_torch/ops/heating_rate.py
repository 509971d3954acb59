"""Heating rate from flux profiles: hr = -(g/cp) d(net flux)/dp.

PyTorch counterpart of ``ecckd_tpu/ops/heating_rate.py``
(ref heating_rate.h:25-72).
"""

from __future__ import annotations

from ..constants import ACCEL_GRAVITY, SPECIFIC_HEAT_AIR


def heating_rate(pressure_hl, flux_dn, flux_up=None):
    """Heating rate (K s-1) per layer from half-level fluxes.

    Args:
      pressure_hl: (..., nlev+1) half-level pressure, Pa.
      flux_dn: (..., nlev+1, *spectral) downwelling flux, W m-2; the level
        axis is ``-1 - nspec`` with ``nspec = flux_dn.ndim -
        pressure_hl.ndim`` trailing spectral axes.
      flux_up: optional upwelling flux, same shape as ``flux_dn``.

    Returns:
      (..., nlev, *spectral) heating rate.
    """
    p = pressure_hl
    fd = flux_dn
    nspec = fd.ndim - p.ndim
    conv = -(ACCEL_GRAVITY / SPECIFIC_HEAT_AIR) / (p[..., 1:] - p[..., :-1])
    conv = conv.reshape(conv.shape + (1,) * nspec)
    lev_axis = fd.ndim - 1 - nspec
    nlev1 = fd.shape[lev_axis]
    lo = fd.narrow(lev_axis, 0, nlev1 - 1)
    hi = fd.narrow(lev_axis, 1, nlev1 - 1)
    net_diff = hi - lo
    if flux_up is not None:
        net_diff = (net_diff - flux_up.narrow(lev_axis, 1, nlev1 - 1)
                    + flux_up.narrow(lev_axis, 0, nlev1 - 1))
    return conv * net_diff
