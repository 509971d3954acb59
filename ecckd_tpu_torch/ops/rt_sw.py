"""Shortwave radiative transfer: direct beam and no-Rayleigh upwelling.

PyTorch counterpart of ``ecckd_tpu/ops/rt_sw.py``
(ref radiative_transfer_sw.cpp:24-184).  Downwelling is Beer-Lambert
attenuation of the direct beam at sec(sza); the no-Rayleigh upwelling
reflects off the surface with the albedo and propagates at the fixed
two-stream secant 2 (Zdunkowski 1980).  The layer recurrences are Python
loops over layers (nlay ~ 50), vectorised over the spectral axis.

* :func:`rt_direct_sw`, :func:`rt_norayleigh_sw` — spectral fluxes.
* :func:`rt_sw_bb_intervals` — per-interval broadband fluxes of a batch of
  candidate intervals; the plain version of kernel K2
  (:mod:`ecckd_tpu_torch.ops.kernels.sweep_sw`).
"""

from __future__ import annotations

import torch

from ..constants import SW_DIFFUSE_SECANT
from .segments import interval_sum_fused


def rt_direct_sw(cos_sza, ssi, od):
    """Spectral direct-beam downwelling flux (nlay+1, nwav) from the solar
    irradiance ``ssi`` (nwav,) and the layer od (nlay, nwav)."""
    minus_sec = -1.0 / cos_sza
    flux = cos_sza * ssi
    rows = [flux]
    for k in range(od.shape[0]):
        flux = flux * torch.exp(minus_sec * od[k])
        rows.append(flux)
    return torch.stack(rows)


def rt_norayleigh_sw(cos_sza, ssi, od, albedo):
    """Spectral (flux_dn, flux_up), each (nlay+1, nwav), with the surface
    reflecting ``albedo`` (nwav,) of the direct beam and no Rayleigh
    scattering."""
    flux_dn = rt_direct_sw(cos_sza, ssi, od)
    flux = flux_dn[-1] * albedo
    rows = [flux]
    for k in range(od.shape[0] - 1, -1, -1):
        flux = flux * torch.exp(-SW_DIFFUSE_SECANT * od[k])
        rows.append(flux)
    return flux_dn, torch.stack(rows[::-1])


def rt_sw_bb_intervals(cos_sza, ssi, bg_od, grey_od_wav, albedo, i1, i2,
                       with_upwelling=True):
    """Per-interval broadband SW fluxes for batched candidates.

    Each wavenumber carries its own grey (fitted) od; per wavenumber tile
    the direct flux at every level follows from a cumulative sum of od down
    the layers, the upward transmittance from a suffix sum up from the
    surface, scaled by ``albedo * flux_dn_surf``; the (2*(nlay+1), tile)
    rows are summed over each inclusive interval [i1[k], i2[k]].  Same
    arithmetic as the JAX package's XLA form.

    Args:
      ssi: (nwav,); bg_od, grey_od_wav: (nlay, nwav);
      albedo: scalar or (nwav,); i1, i2: (nseg,) integer tensors.

    Returns:
      (flux_dn, flux_up), each (nlay+1, nseg); flux_up is zeros when
      ``with_upwelling`` is False.
    """
    minus_sec = -1.0 / cos_sza
    nlay, n = bg_od.shape
    albedo = torch.broadcast_to(torch.as_tensor(albedo, dtype=ssi.dtype,
                                                device=ssi.device), (n,))

    def flux_part(start, size):
        sl = lambda a: a.narrow(a.ndim - 1, start, size)
        od = sl(bg_od) + sl(grey_od_wav)
        top = (cos_sza * sl(ssi))[None, :]
        dn = top * torch.exp(minus_sec * torch.cumsum(od, dim=0))
        dn_rows = torch.cat([top, dn], dim=0)
        if not with_upwelling:
            return dn_rows
        # transmittance from the surface up; level nlay is the surface
        a = torch.exp(-SW_DIFFUSE_SECANT
                      * torch.cumsum(od.flip(0), dim=0)).flip(0)
        up = (sl(albedo) * dn[-1])[None, :] * torch.cat(
            [a, torch.ones_like(top)], dim=0)
        return torch.cat([dn_rows, up], dim=0)

    sums = interval_sum_fused([flux_part], n, i1, i2, dtype=ssi.dtype)
    flux_dn = sums[:nlay + 1]
    if not with_upwelling:
        return flux_dn, torch.zeros_like(flux_dn)
    return flux_dn, sums[nlay + 1:]
