"""Plain PyTorch physics of ecCKD, written from the reference's equations.

Nothing here imports the program under test: the constants are ecCKD's
(``constants.h``, ``planck_function.cpp``), the radiative transfer is the
two-stream scheme of ``radiative_transfer_lw.cpp`` and
``radiative_transfer_sw.cpp``.  Loops run over layers, vectorised over
wavenumbers, in the dtype of the inputs.
"""

from __future__ import annotations

import torch

ACCEL_GRAVITY = 9.80665
SPECIFIC_HEAT_AIR = 1004.0
LW_DIFFUSIVITY = 1.66
MOLAR_MASS_DRY_AIR = 28.970
PLANCK_H = 6.62606896e-34
SPEED_OF_LIGHT = 2.99792458e8
BOLTZMANN_K = 1.3806504e-23
PI = 3.14159265358979323846
HR_WEIGHT = 3600.0 * 24.0               # K s-1 to K day-1
SW_DIFFUSE_SECANT = 2.0
THRESHOLD_EMISSIVITY = 1.0e-5
# Largest mean transmission the fits take (average_optical_depth.cpp:48)
TRANS_CLAMP = 0.9999999999999999


def planck(temperature, wav, dwav):
    """Planck irradiance of each wavenumber interval, W m-2:
    (..., nt) temperatures -> (..., nt, nwav)."""
    c_hz = 100.0 * SPEED_OF_LIGHT
    f = wav * c_hz
    pre = dwav * (2.0 * PLANCK_H * c_hz * PI / SPEED_OF_LIGHT ** 2) * f ** 3
    t = temperature.to(wav.dtype)[..., None]
    return pre / torch.expm1((PLANCK_H / BOLTZMANN_K) * f / t)


def heating_rate(p_hl, flux_dn, flux_up=None):
    """Heating rate (K s-1) of each layer from half-level fluxes whose
    first axis is the level."""
    net = flux_dn if flux_up is None else flux_dn - flux_up
    dp = p_hl[1:] - p_hl[:-1]
    shape = (-1,) + (1,) * (net.ndim - 1)
    return (-(ACCEL_GRAVITY / SPECIFIC_HEAT_AIR)
            * (net[1:] - net[:-1]) / dp.reshape(shape))


def lw_fluxes(planck_hl, od, surf_planck, clamped=False):
    """(flux_dn, flux_up), each (nlay + 1, nwav), of a black surface.
    ``clamped`` takes the broadband form of the emissivity and source
    factor, as the candidate sweep does (radiative_transfer_lw.cpp:
    104-126); otherwise the spectral form (:41-43)."""
    emis = -torch.expm1(-LW_DIFFUSIVITY * od)
    if clamped:
        te = THRESHOLD_EMISSIVITY
        factor = torch.clamp(
            1.0 - torch.clamp(emis, min=te) / LW_DIFFUSIVITY
            / torch.clamp(od, min=te / LW_DIFFUSIVITY), min=0.5 * te)
    else:
        safe = torch.where(od > 0.0, od, torch.ones_like(od))
        factor = torch.where(emis > THRESHOLD_EMISSIVITY,
                             1.0 - emis / LW_DIFFUSIVITY / safe, 0.5 * emis)
    trans = 1.0 - emis
    nlay = od.shape[0]
    dn = [torch.zeros_like(surf_planck)]
    for k in range(nlay):
        dn.append(dn[-1] * trans[k] + planck_hl[k] * (emis[k] - factor[k])
                  + planck_hl[k + 1] * factor[k])
    up = [surf_planck]
    for k in range(nlay - 1, -1, -1):
        up.append(up[-1] * trans[k]
                  + planck_hl[k + 1] * (emis[k] - factor[k])
                  + planck_hl[k] * factor[k])
    return torch.stack(dn), torch.stack(up[::-1])


def sw_direct(cos_sza, ssi, od):
    """Direct-beam downwelling flux (nlay + 1, nwav)."""
    rows = [cos_sza * ssi]
    for k in range(od.shape[0]):
        rows.append(rows[-1] * torch.exp(-od[k] / cos_sza))
    return torch.stack(rows)


def sw_reflected(flux_dn, od, albedo):
    """Upwelling flux (nlay + 1, nwav): the direct beam reflected by the
    surface, up at the two-stream secant with no scattering."""
    rows = [flux_dn[-1] * albedo]
    for k in range(od.shape[0] - 1, -1, -1):
        rows.append(rows[-1] * torch.exp(-SW_DIFFUSE_SECANT * od[k]))
    return torch.stack(rows[::-1])


def layer_weight(p_hl, min_pressure):
    """Layer weights of the heating-rate cost: the difference of the square
    roots of pressure, none above ``min_pressure``, summing to 1."""
    w = torch.sqrt(p_hl[1:]) - torch.sqrt(p_hl[:-1])
    w = torch.where(0.5 * (p_hl[1:] + p_hl[:-1]) < min_pressure,
                    torch.zeros_like(w), w)
    return w / w.sum()


def cost(p_hl, lw, flux_weight, hr_fit, hr_true, dn_err, up_err):
    """The candidate cost of ecCKD (calc_cost_function_lw.cpp:104-110):
    layer-weighted squared heating-rate error in K/day plus weighted
    squared boundary-flux errors, square-rooted."""
    err = hr_fit - hr_true
    return torch.sqrt(HR_WEIGHT ** 2 * (lw * err * err).sum()
                      + flux_weight * (dn_err * dn_err + up_err * up_err))
