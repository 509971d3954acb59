"""Plain reference of create_lut's look-up table (longwave).

For every gas, temperature column, layer and g-point: the Planck-weighted
mean transmission of the g-point's wavenumbers at the layer's temperature,
turned back into an optical depth (average_optical_depth.cpp:120-197),
held between the least and the largest od of those wavenumbers, and the
three converted to molar absorption coefficients with the gas's reference
mole fraction (:168-187).  One g-point at a time, each a plain gather.
"""

from __future__ import annotations

import numpy as np
import torch

from .physics import (ACCEL_GRAVITY, LW_DIFFUSIVITY, MOLAR_MASS_DRY_AIR,
                      TRANS_CLAMP, planck)


def gas_tables(cfg, spec, gas, members, device):
    """(molar_abs, min, max), each (ncol, nlay, ng) float64 numpy, of one
    gas; ``members`` holds the wavenumber indices of each g-point."""
    p_hl = torch.as_tensor(spec.pressure_hl, device=device)
    p_fl = 0.5 * (p_hl[1:] + p_hl[:-1])
    dp = (p_hl[1:] - p_hl[:-1])[:, None]
    wav = torch.as_tensor(spec.wavenumber, device=device)
    dwav = torch.as_tensor(spec.d_wavenumber, device=device)
    to_k = ACCEL_GRAVITY * 0.001 * MOLAR_MASS_DRY_AIR / gas["vmr"]
    out = []
    for off in cfg["temperature_offsets_k"]:
        sp = spec.profiles[gas["name"]][off]
        t_hl = torch.as_tensor(sp.temperature_hl, device=device)
        t_fl = 0.5 * (t_hl[1:] * p_hl[1:] + t_hl[:-1] * p_hl[:-1]) / p_fl
        od = torch.as_tensor(sp.optical_depth, device=device)
        cols = []
        for idx in members:
            o = od[:, idx]
            w = planck(t_fl, wav[idx], dwav[idx])
            mean = torch.clamp((w * -torch.expm1(-LW_DIFFUSIVITY * o)).sum(1)
                               / w.sum(1), max=TRANS_CLAMP)
            fit = torch.abs(-torch.log1p(-mean) / LW_DIFFUSIVITY)
            lo, hi = o.min(1).values, o.max(1).values
            fit = torch.maximum(lo, torch.minimum(fit, hi))
            degenerate = (lo > 0.0) & (lo >= hi)
            lo = torch.where(degenerate, 0.99 * lo, lo)
            hi = torch.where(degenerate, 1.01 * hi, hi)
            cols.append(torch.stack([fit, lo, hi]))
        del od
        out.append(to_k * torch.stack(cols, -1) / dp[None])   # (3, nlay, ng)
    return tuple(torch.stack([o[i] for o in out]).cpu().numpy()
                 for i in range(3))


def check_tables(cfg, spec, g_point, model, device):
    """(transmission gap, extremes gap, faults) of a model against the
    reference.  The fitted od is compared as the layer's transmission,
    exp(-1.66 od): the od of an opaque g-point comes from a mean
    transmission within a few ulps of 1, so that its od, and no
    transmission, carries the rounding of the sums.  The least and largest
    od are compared relative to the entry.  The faults count tables of the
    wrong shape or with entries that are not finite."""
    g_point = torch.as_tensor(np.asarray(g_point), device=device)
    present = torch.unique(g_point[g_point >= 0])
    members = [torch.nonzero(g_point == k)[:, 0] for k in present.tolist()]
    p_hl = np.asarray(spec.pressure_hl)
    dp = (p_hl[1:] - p_hl[:-1])[None, :, None]
    trans_gap = extremes_gap = 0.0
    faults = int(len(model.single_gas_data) != len(cfg["gases"]))
    for gas, got in zip(cfg["gases"], model.single_gas_data):
        ref = gas_tables(cfg, spec, gas, members, device)
        to_od = dp * gas["vmr"] / (ACCEL_GRAVITY * 0.001 * MOLAR_MASS_DRY_AIR)
        tables = [np.asarray(t, np.float64) for t in (
            got.molar_abs, got.min_molar_abs, got.max_molar_abs)]
        if any(t.shape != ref[0].shape or not np.all(np.isfinite(t))
               for t in tables):
            faults += 1
            continue
        trans = lambda k: np.exp(-LW_DIFFUSIVITY * k * to_od)
        trans_gap = max(trans_gap, float(np.abs(trans(tables[0])
                                                - trans(ref[0])).max()))
        for t, r in zip(tables[1:], ref[1:]):
            rel = np.abs(t - r) / np.maximum(np.abs(r), 1e-300)
            extremes_gap = max(extremes_gap, float(rel.max()))
    return trans_gap, extremes_gap, faults
