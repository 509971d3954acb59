"""Evaluation figures: the reference's Matlab ``plot/`` layer.

Matplotlib equivalents of the offline evaluation scripts (SURVEY.md aux
inventory): ``plot/plot_gpoints.m`` (spectral partition per band),
``plot/evaluate_ckd_lw_fluxes.m`` (flux/heating-rate error profiles +
summary stats), ``plot/plot_accuracy_efficiency.m`` (error vs g-point
count), ``plot/compare_averaging_methods.m`` and
``plot/plot_present_day_fluxes.m``. The numbers behind every figure come
from :mod:`ecckd_tpu_torch.evaluate.metrics`; these functions only draw.

All figures are static (Agg backend), one y-scale per axes, with a fixed
categorical color order (never cycled by rank).

The port's own copy of ``ecckd_tpu/evaluate/plots.py``: the port imports
nothing of the JAX package.  It needs matplotlib, which a machine without
it lacks: importing this module there raises ImportError, as the JAX one
does.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from .metrics import calc_hr, flux_stats, format_stats  # noqa: E402

# Fixed categorical order (validated default palette; assign by entity,
# never by rank). Slot 1 is always the first gas/series encountered.
SERIES_COLORS = ["#2a78d6", "#eb6834", "#1baf7a",
                 "#eda100", "#e87ba4", "#008300"]
GRID_KW = dict(color="0.85", linewidth=0.6)
TEXT_COLOR = "#33322e"


def _style_axes(ax):
    ax.grid(True, **GRID_KW)
    ax.set_axisbelow(True)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)


def _save(fig, output: str):
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    fig.savefig(output, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return output


def discover_gases(gpoint_names: Sequence[str]) -> List[str]:
    """Gas names present in a g-point file (``<gas>_n_g_points`` vars)."""
    return sorted(n[: -len("_n_g_points")] for n in gpoint_names
                  if n.endswith("_n_g_points"))


def plot_gpoints(gpoint_file: str, output: str,
                 gases: Optional[Sequence[str]] = None) -> str:
    """Spectral partition figure (plot/plot_gpoints.m).

    One panel per band; within a panel each gas is one row of colored
    spans, one span per g-point covering its wavenumber-rank interval
    [rank1, rank2] mapped back to wavenumber. Color = gas identity
    (fixed slot per gas); alternating shading separates g-points.
    """
    from ..io import NcFile

    with NcFile(gpoint_file) as f:
        names = f.names()
        if gases is None:
            gases = discover_gases(names)
        wavenumber = np.asarray(f.read("wavenumber"))
        wn1_band = np.atleast_1d(np.asarray(f.read("wavenumber1_band")))
        nband = wn1_band.shape[0]
        per_gas = {}
        for gas in gases:
            per_gas[gas] = dict(
                n_g_points=np.atleast_1d(
                    np.asarray(f.read(f"{gas}_n_g_points"))),
                rank1=np.atleast_1d(np.asarray(f.read(f"{gas}_rank1"))),
                rank2=np.atleast_1d(np.asarray(f.read(f"{gas}_rank2"))),
                band=np.atleast_1d(
                    np.asarray(f.read(f"{gas}_band_number"))),
            )

    ncols = min(nband, 3)
    nrows = (nband + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, squeeze=False,
                             figsize=(4.2 * ncols, 1.1 + 1.5 * len(gases)
                                      * nrows))
    # rank -> wavenumber needs the per-band sorted wavenumbers; ranks are
    # indices into the band's reordered spectrum, so span fractions of the
    # band's rank range are plotted directly (x = rank / n_in_band).
    for iband in range(nband):
        ax = axes[iband // ncols][iband % ncols]
        yticks, ylabels = [], []
        for irow, gas in enumerate(gases):
            g = per_gas[gas]
            color = SERIES_COLORS[irow % len(SERIES_COLORS)]
            sel = np.nonzero(g["band"] == iband)[0]
            if sel.size == 0:
                continue
            lo = g["rank1"][sel].astype(float)
            hi = g["rank2"][sel].astype(float)
            span = max(hi.max() - lo.min(), 1.0)
            x0 = lo.min()
            for k, (a, b) in enumerate(zip(lo, hi)):
                ax.barh(irow, (b - a + 1) / span, left=(a - x0) / span,
                        height=0.62, color=color,
                        alpha=0.45 if k % 2 else 0.9,
                        edgecolor="white", linewidth=1.0)
            yticks.append(irow)
            ylabels.append(gas)
        ax.set_yticks(yticks)
        ax.set_yticklabels(ylabels, color=TEXT_COLOR)
        ax.set_xlim(0, 1)
        ax.set_xlabel("fraction of band (reordered spectrum)",
                      color=TEXT_COLOR)
        ax.set_title(f"Band {iband}", color=TEXT_COLOR, fontsize=10)
        _style_axes(ax)
        ax.invert_yaxis()
    for j in range(nband, nrows * ncols):
        axes[j // ncols][j % ncols].set_visible(False)
    fig.suptitle("g-point partition per band", color=TEXT_COLOR)
    fig.tight_layout(rect=(0, 0, 1, 0.96))
    del wavenumber  # ranks are per-band; wavenumber kept for future use
    return _save(fig, output)


def plot_evaluation(ref_file: str, ckd_file: str, output: str,
                    band: str = "lw", title: str = "CKD model") -> str:
    """Flux/heating-rate evaluation figure (plot/evaluate_ckd_lw_fluxes.m).

    Three panels: heating-rate bias and RMSE profiles vs pressure
    (log-p axis, TOA at top), TOA up-flux errors and surface down-flux
    errors per column, and the six summary statistics as text.
    """
    from .metrics import _load_fluxes

    ref = _load_fluxes(ref_file, band)
    ckd = _load_fluxes(ckd_file, band)
    if "pressure_hl" not in ckd:
        ckd["pressure_hl"] = ref["pressure_hl"]
    stats = flux_stats(ref, ckd, band)

    up, dn = f"flux_up_{band}", f"flux_dn_{band}"
    p_hl = np.asarray(ref["pressure_hl"], np.float64)
    hr_ref = calc_hr(np.asarray(ref[dn]), np.asarray(ref[up]), p_hl)
    hr_ckd = calc_hr(np.asarray(ckd[dn]), np.asarray(ckd[up]),
                     np.asarray(ckd["pressure_hl"], np.float64))
    p_fl_hpa = 0.01 * 0.5 * (p_hl[:, 1:] + p_hl[:, :-1])
    err = hr_ckd - hr_ref
    bias = err.mean(axis=0)
    rmse = np.sqrt((err ** 2).mean(axis=0))
    p_med = np.median(p_fl_hpa, axis=0)

    fig, (ax1, ax2, ax3) = plt.subplots(
        1, 3, figsize=(11, 4), gridspec_kw={"width_ratios": [2, 2, 1.4]})

    ax1.plot(bias, p_med, color=SERIES_COLORS[0], lw=2, label="bias")
    ax1.plot(rmse, p_med, color=SERIES_COLORS[1], lw=2, label="RMSE")
    ax1.axvline(0.0, color="0.6", lw=0.8)
    ax1.set_yscale("log")
    ax1.invert_yaxis()
    ax1.set_xlabel("heating-rate error (K d$^{-1}$)", color=TEXT_COLOR)
    ax1.set_ylabel("pressure (hPa)", color=TEXT_COLOR)
    ax1.legend(frameon=False)
    _style_axes(ax1)

    toa_err = np.asarray(ckd[up])[:, 0] - np.asarray(ref[up])[:, 0]
    surf_err = np.asarray(ckd[dn])[:, -1] - np.asarray(ref[dn])[:, -1]
    cols = np.arange(toa_err.shape[0])
    ax2.plot(cols, toa_err, "o", color=SERIES_COLORS[0], ms=5,
             label="TOA up")
    ax2.plot(cols, surf_err, "s", color=SERIES_COLORS[1], ms=5,
             label="surface down")
    ax2.axhline(0.0, color="0.6", lw=0.8)
    ax2.set_xlabel("column", color=TEXT_COLOR)
    ax2.set_ylabel("flux error (W m$^{-2}$)", color=TEXT_COLOR)
    ax2.legend(frameon=False)
    _style_axes(ax2)

    ax3.axis("off")
    ax3.text(0.0, 0.95, format_stats(stats, title), family="monospace",
             fontsize=8, va="top", color=TEXT_COLOR)
    fig.suptitle(f"{title}: {band.upper()} evaluation", color=TEXT_COLOR)
    fig.tight_layout()
    return _save(fig, output)


def plot_accuracy_efficiency(tables: Dict[str, List[Dict[str, float]]],
                             output: str,
                             metric: str = "heating_rate_low_rmse") -> str:
    """Error vs g-point count (plot/plot_accuracy_efficiency.m).

    ``tables`` maps a label (e.g. band structure) to rows from
    :func:`metrics.accuracy_efficiency_table`; each row needs
    ``n_g_points`` and the chosen metric. Log-log, one line per label.
    """
    fig, ax = plt.subplots(figsize=(5.2, 4))
    for i, (label, rows) in enumerate(sorted(tables.items())):
        rows = sorted(rows, key=lambda r: r["n_g_points"])
        ng = [r["n_g_points"] for r in rows]
        errv = [abs(r[metric]) for r in rows]
        color = SERIES_COLORS[i % len(SERIES_COLORS)]
        ax.plot(ng, errv, "o-", color=color, lw=2, ms=6, label=label)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("number of g-points", color=TEXT_COLOR)
    ax.set_ylabel(metric.replace("_", " "), color=TEXT_COLOR)
    if len(tables) > 1:
        ax.legend(frameon=False)
    ax.set_title("Accuracy vs efficiency", color=TEXT_COLOR)
    _style_axes(ax)
    return _save(fig, output)


def plot_averaging_methods(stats_by_method: Dict[str, Dict[str, float]],
                           output: str,
                           metrics: Sequence[str] = (
                               "heating_rate_low_rmse",
                               "heating_rate_high_rmse")) -> str:
    """Error per averaging method (plot/compare_averaging_methods.m).

    Horizontal bars, one panel per metric so each keeps its own scale
    (never a dual axis). Methods keep file order; bars use one hue —
    identity is carried by the y labels, magnitude by length.
    """
    methods = list(stats_by_method)
    fig, axes = plt.subplots(1, len(metrics),
                             figsize=(3.6 * len(metrics),
                                      0.6 + 0.45 * len(methods)),
                             squeeze=False)
    ypos = np.arange(len(methods))
    for j, metric in enumerate(metrics):
        ax = axes[0][j]
        vals = [abs(stats_by_method[m][metric]) for m in methods]
        ax.barh(ypos, vals, height=0.62, color=SERIES_COLORS[0])
        ax.set_yticks(ypos)
        ax.set_yticklabels(methods if j == 0 else [""] * len(methods),
                           color=TEXT_COLOR)
        ax.invert_yaxis()
        ax.set_xlabel(metric.replace("_", " "), color=TEXT_COLOR,
                      fontsize=9)
        _style_axes(ax)
    fig.suptitle("Averaging-method comparison", color=TEXT_COLOR)
    fig.tight_layout()
    return _save(fig, output)


def plot_flux_profiles(ref_file: str, ckd_file: str, output: str,
                       band: str = "lw") -> str:
    """Median up/down flux profiles, CKD vs LBL
    (plot/plot_present_day_fluxes.m)."""
    from .metrics import _load_fluxes

    ref = _load_fluxes(ref_file, band)
    ckd = _load_fluxes(ckd_file, band)
    if "pressure_hl" not in ckd:
        ckd["pressure_hl"] = ref["pressure_hl"]
    up, dn = f"flux_up_{band}", f"flux_dn_{band}"
    p_hpa = 0.01 * np.median(np.asarray(ref["pressure_hl"]), axis=0)

    fig, ax = plt.subplots(figsize=(5, 4.5))
    for name, key, color in ((f"up", up, SERIES_COLORS[0]),
                             (f"down", dn, SERIES_COLORS[1])):
        ax.plot(np.median(np.asarray(ref[key]), axis=0), p_hpa,
                color=color, lw=2, label=f"LBL {name}")
        ax.plot(np.median(np.asarray(ckd[key]), axis=0), p_hpa,
                color=color, lw=1.4, ls="--", label=f"CKD {name}")
    ax.set_yscale("log")
    ax.invert_yaxis()
    ax.set_xlabel("flux (W m$^{-2}$)", color=TEXT_COLOR)
    ax.set_ylabel("pressure (hPa)", color=TEXT_COLOR)
    ax.legend(frameon=False)
    ax.set_title(f"{band.upper()} median flux profiles", color=TEXT_COLOR)
    _style_axes(ax)
    return _save(fig, output)
