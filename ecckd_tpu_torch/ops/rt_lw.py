"""Longwave no-scattering two-stream radiative transfer.

PyTorch counterpart of ``ecckd_tpu/ops/rt_lw.py``
(ref radiative_transfer_lw.cpp:25-142).  The layer recurrences are Python
loops over layers (nlay ~ 50), vectorised over the spectral axis.

* :func:`rt_lw` — full spectral fluxes (nlev+1, nwav).
* :func:`rt_lw_bb_intervals` — per-interval broadband fluxes of a batch of
  candidate intervals; the plain version of kernel K1
  (:mod:`ecckd_tpu_torch.ops.kernels.sweep_lw`).
"""

from __future__ import annotations

import torch

from ..constants import LW_DIFFUSIVITY
from .segments import interval_sum_fused

# Below this emissivity the linear-in-planck "factor" is replaced by its
# small-od limit (ref radiative_transfer_lw.cpp:42, :104)
THRESHOLD_EMISSIVITY = 1.0e-5


def _emissivity_factor(od):
    """Emissivity and linear-in-Planck source factor (spectral form,
    ref radiative_transfer_lw.cpp:41-43)."""
    emissivity = -torch.expm1(-LW_DIFFUSIVITY * od)
    safe_od = torch.where(od > 0.0, od, 1.0)
    factor = torch.where(
        emissivity > THRESHOLD_EMISSIVITY,
        1.0 - emissivity * (1.0 / LW_DIFFUSIVITY) / safe_od,
        0.5 * emissivity)
    return emissivity, factor


def _emissivity_factor_bb(od):
    """Clamped emissivity/factor of the broadband variant
    (ref radiative_transfer_lw.cpp:104-126)."""
    te = THRESHOLD_EMISSIVITY
    emissivity = -torch.expm1(-LW_DIFFUSIVITY * od)
    factor = torch.clamp(
        1.0 - (1.0 / LW_DIFFUSIVITY) * torch.clamp(emissivity, min=te)
        / torch.clamp(od, min=te / LW_DIFFUSIVITY),
        min=0.5 * te)
    return emissivity, factor


def rt_lw(planck_hl, od, surf_emissivity, surf_planck):
    """Spectral longwave fluxes.

    Args:
      planck_hl: (nlev+1, nwav) Planck function at half levels, W m-2.
      od: (nlay, nwav) layer optical depth.
      surf_emissivity, surf_planck: (nwav,).

    Returns:
      (flux_dn, flux_up), each (nlev+1, nwav).
    """
    emissivity, factor = _emissivity_factor(od)
    trans = 1.0 - emissivity
    nlay = od.shape[0]
    dn = [torch.zeros_like(planck_hl[0])]
    for k in range(nlay):
        t, f = trans[k], factor[k]
        dn.append(dn[-1] * t + planck_hl[k] * (1.0 - t - f)
                  + planck_hl[k + 1] * f)
    surf = surf_planck * surf_emissivity + (1.0 - surf_emissivity) * dn[-1]
    up = [surf]
    for k in range(nlay - 1, -1, -1):
        t, f = trans[k], factor[k]
        up.append(up[-1] * t + planck_hl[k + 1] * (1.0 - t - f)
                  + planck_hl[k] * f)
    return torch.stack(dn), torch.stack(up[::-1])


def rt_lw_bb_intervals(planck_hl, bg_od, grey_od_wav, surf_emissivity,
                       surf_planck, i1, i2):
    """Per-interval broadband longwave fluxes for batched candidates.

    Each wavenumber carries its own grey (fitted) optical depth; the flux
    recurrence runs once over all wavenumbers and the 2*(nlev+1) flux rows
    are summed over each candidate interval [i1[k], i2[k]] (inclusive).
    Same recurrence as the JAX package's XLA form: hoisted source terms
    and an upward sweep affine in its surface boundary.

    Args:
      planck_hl: (nlev+1, nwav); bg_od, grey_od_wav: (nlay, nwav);
      surf_emissivity, surf_planck: (nwav,);
      i1, i2: (nseg,) integer tensors of inclusive bounds.

    Returns:
      (flux_dn, flux_up), each (nlev+1, nseg).
    """
    nlay = bg_od.shape[0]
    n = bg_od.shape[-1]

    def flux_part(start, size):
        sl = lambda a: a.narrow(a.ndim - 1, start, size)
        p = sl(planck_hl)
        od = sl(bg_od) + sl(grey_od_wav)
        se = sl(surf_emissivity)
        sp = sl(surf_planck)
        emissivity, factor = _emissivity_factor_bb(od)
        trans = 1.0 - emissivity
        coeff_top = emissivity - factor
        src_dn = p[:-1] * coeff_top + p[1:] * factor
        src_up = p[1:] * coeff_top + p[:-1] * factor

        flux_dn = torch.zeros_like(se)
        b = torch.zeros_like(se)
        a = torch.ones_like(se)
        dn_rows = [flux_dn]
        b_rows = [None] * (nlay + 1)
        a_rows = [None] * (nlay + 1)
        b_rows[nlay] = b
        a_rows[nlay] = a
        for k in range(nlay):
            up_lay = nlay - 1 - k
            flux_dn = flux_dn * trans[k] + src_dn[k]
            b = b * trans[up_lay] + src_up[up_lay]
            a = a * trans[up_lay]
            dn_rows.append(flux_dn)
            b_rows[up_lay] = b
            a_rows[up_lay] = a
        boundary = sp * se + (1.0 - se) * flux_dn
        up = torch.stack(b_rows) + boundary[None, :] * torch.stack(a_rows)
        return torch.cat([torch.stack(dn_rows), up], dim=0)

    sums = interval_sum_fused([flux_part], n, i1, i2, dtype=planck_hl.dtype)
    return sums[:nlay + 1], sums[nlay + 1:]
