"""CKD-model accuracy metrics vs line-by-line benchmark fluxes.

NumPy re-implementation of the reference's Matlab evaluation suite
(the acceptance-test layer of the pipeline, SURVEY.md §4):

- ``calc_hr``        — heating rate from flux profiles (plot/calc_hr.m:1-14)
- ``calc_hr_error``  — cube-root-pressure-weighted RMS heating-rate error
                       (plot/calc_hr_error.m:1-24)
- ``evaluate_fluxes``— bias/RMSE of TOA-up and surface-down fluxes plus
                       high/low-altitude heating-rate RMSE, the six summary
                       statistics of plot/evaluate_ckd_lw_fluxes.m:195-259
                       consumed by plot/plot_accuracy_efficiency.m:14-52
- ``accuracy_efficiency_table`` — error vs g-point count across a family of
                       CKD models (plot/plot_accuracy_efficiency.m:26-52)

Array convention: profiles are stored (column, level) as written by
``run_ckd`` (the Matlab scripts work with the loadnc transpose; the
statistics are identical).

The port's own copy of ``ecckd_tpu/evaluate/metrics.py``: the port imports
nothing of the JAX package, and reads its files (either NetCDF container)
through the port's ``NcFile``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# The Matlab evaluation scripts use slightly different constants from the
# C++ pipeline (g=9.81 vs 9.80665, plot/calc_hr.m:6-8); reproduced
# deliberately so evaluation numbers match the reference's published plots.
_EVAL_G = 9.81
_EVAL_CP = 1004.0
_DAY_S = 3600.0 * 24.0

# Pressure bands (hPa) of the summary heating-rate statistics
# (plot/evaluate_ckd_lw_fluxes.m:98-99: [0.02 4] and [4 1100]).
HIGH_PRESSURE_RANGE = (0.02, 4.0)
LOW_PRESSURE_RANGE = (4.0, 1100.0)


def calc_hr(flux_dn: np.ndarray, flux_up: np.ndarray,
            pressure_hl: np.ndarray) -> np.ndarray:
    """Heating rate (K d-1) from half-level fluxes, (ncol, nhl) layout.

    Ref plot/calc_hr.m:4-9: hr = -86400 * g/cp * d(net)/dp with net=dn-up.
    """
    flux_net = np.asarray(flux_dn, np.float64) - np.asarray(flux_up,
                                                            np.float64)
    dnet = np.diff(flux_net, axis=-1)
    dp = np.diff(np.asarray(pressure_hl, np.float64), axis=-1)
    return -_DAY_S * dnet * _EVAL_G / (dp * _EVAL_CP)


def calc_hr_error(pressure_hl_hpa: np.ndarray, hr: np.ndarray,
                  hr_ref: np.ndarray,
                  pressure_range: Tuple[float, float] = (0.0, np.inf),
                  ) -> float:
    """Cube-root-pressure-weighted RMS heating-rate error, K d-1.

    Ref plot/calc_hr_error.m:10-24: per-layer weight is the difference of
    cube roots of the bounding half-level pressures (in hPa), zeroed for
    layers whose full-level pressure falls outside ``pressure_range``
    (lower-inclusive, upper-exclusive), normalized per profile; the error
    is sqrt of the weighted sum of squared errors divided by nprof.
    """
    p_hl = np.asarray(pressure_hl_hpa, np.float64)
    hr = np.asarray(hr, np.float64)
    hr_ref = np.asarray(hr_ref, np.float64)
    p_fl = 0.5 * (p_hl[..., :-1] + p_hl[..., 1:])
    weight = p_hl[..., 1:] ** (1.0 / 3.0) - p_hl[..., :-1] ** (1.0 / 3.0)
    weight = np.where((p_fl < pressure_range[0])
                      | (p_fl >= pressure_range[1]), 0.0, weight)
    norm = weight.sum(axis=-1, keepdims=True)
    weight = np.divide(weight, norm, out=np.zeros_like(weight),
                       where=norm != 0.0)
    nprof = int(np.prod(hr.shape[:-1])) if hr.ndim > 1 else 1
    return float(np.sqrt(np.sum(weight * (hr - hr_ref) ** 2) / nprof))


def flux_stats(ref: Dict[str, np.ndarray], ckd: Dict[str, np.ndarray],
               band: str = "lw") -> Dict[str, float]:
    """The six summary statistics of plot/evaluate_ckd_lw_fluxes.m.

    ``ref``/``ckd`` are dicts with ``pressure_hl`` (Pa) and
    ``flux_up_<band>`` / ``flux_dn_<band>`` (ncol, nhl).  Keys follow the
    stats struct consumed by plot_accuracy_efficiency.m:14-19.
    """
    up, dn = f"flux_up_{band}", f"flux_dn_{band}"
    flux_up_ref = np.asarray(ref[up], np.float64)
    flux_dn_ref = np.asarray(ref[dn], np.float64)
    flux_up_ckd = np.asarray(ckd[up], np.float64)
    flux_dn_ckd = np.asarray(ckd[dn], np.float64)
    p_hl = np.asarray(ref["pressure_hl"], np.float64)
    p_hl_hpa = 0.01 * p_hl

    hr_ref = calc_hr(flux_dn_ref, flux_up_ref, p_hl)
    hr_ckd = calc_hr(flux_dn_ckd, flux_up_ckd,
                     np.asarray(ckd.get("pressure_hl", p_hl), np.float64))

    toa_up_err = flux_up_ckd[:, 0] - flux_up_ref[:, 0]
    surf_dn_err = flux_dn_ckd[:, -1] - flux_dn_ref[:, -1]
    return {
        "toa_up_bias": float(np.mean(toa_up_err)),
        "toa_up_rmse": float(np.sqrt(np.mean(toa_up_err ** 2))),
        "surf_dn_bias": float(np.mean(surf_dn_err)),
        "surf_dn_rmse": float(np.sqrt(np.mean(surf_dn_err ** 2))),
        "heating_rate_high_rmse": calc_hr_error(
            p_hl_hpa, hr_ckd, hr_ref, HIGH_PRESSURE_RANGE),
        "heating_rate_low_rmse": calc_hr_error(
            p_hl_hpa, hr_ckd, hr_ref, LOW_PRESSURE_RANGE),
    }


def _load_fluxes(path: str, band: str) -> Dict[str, np.ndarray]:
    from ..io import NcFile
    out = {}
    with NcFile(path) as f:
        for name in ("pressure_hl", f"flux_up_{band}", f"flux_dn_{band}"):
            if f.exist(name):
                out[name] = np.asarray(f.read(name))
    missing = [k for k in (f"flux_up_{band}", f"flux_dn_{band}")
               if k not in out]
    if missing:
        raise KeyError(f"{path} lacks {missing} — not a {band.upper()} "
                       "flux file")
    return out


def evaluate_fluxes(ref_file: str, ckd_file: str,
                    band: str = "lw") -> Dict[str, float]:
    """File-level wrapper: stats of a CKD flux file vs an LBL benchmark."""
    ref = _load_fluxes(ref_file, band)
    ckd = _load_fluxes(ckd_file, band)
    if "pressure_hl" not in ckd:
        ckd["pressure_hl"] = ref["pressure_hl"]
    return flux_stats(ref, ckd, band)


def _n_gpoints(ckd_definition_file: str) -> int:
    from ..io import NcFile
    with NcFile(ckd_definition_file) as f:
        return int(np.asarray(f.read("gpoint_fraction")).shape[0])


def accuracy_efficiency_table(ref_file: str, ckd_flux_files: Sequence[str],
                              band: str = "lw",
                              ckd_definition_files: Optional[Sequence[str]]
                              = None) -> List[Dict[str, float]]:
    """Error-vs-g-point-count table (plot/plot_accuracy_efficiency.m:26-52).

    Returns one dict per model: the six flux stats plus ``n_g_points``
    (from the matching ckd-definition file when given) and ``file``.
    """
    rows = []
    for i, flux_file in enumerate(ckd_flux_files):
        row = dict(evaluate_fluxes(ref_file, flux_file, band))
        row["file"] = flux_file
        if ckd_definition_files is not None:
            row["n_g_points"] = _n_gpoints(ckd_definition_files[i])
        rows.append(row)
    return rows


def format_stats(stats: Dict[str, float], title: str = "CKD model") -> str:
    """Text summary matching the figure text panel of
    plot/evaluate_ckd_lw_fluxes.m:247-256."""
    lines = [f"CKD model: {title}"]
    lines.append("Bias TOA upwelling: "
                 f"{stats['toa_up_bias']:.2f} W m-2")
    lines.append("Bias surface downwelling: "
                 f"{stats['surf_dn_bias']:.2f} W m-2")
    lines.append("RMSE TOA upwelling: "
                 f"{stats['toa_up_rmse']:.2f} W m-2")
    lines.append("RMSE surface downwelling: "
                 f"{stats['surf_dn_rmse']:.2f} W m-2")
    lines.append("RMSE heating rate (0.02-4 hPa): "
                 f"{stats['heating_rate_high_rmse']:.3f} K d-1")
    lines.append("RMSE heating rate (4-1100 hPa): "
                 f"{stats['heating_rate_low_rmse']:.3f} K d-1")
    return "\n".join(lines)
