"""The float32 generation chain held against the float64 chain.

Runs the array cores ``reorder_core`` -> ``find_g_points_core`` ->
``create_lut_core`` on one device in ``precision=float64`` and in
``float32`` on a small rig, the LW rig of ``tests/test_torch_pipeline.py``
(h2o, 1024 wavenumbers x 15 layers, 5 profiles, one band, transmission
search and LUT) or the two-band SW rig of
``tests/test_torch_sw_pipeline.py`` (6 profiles, the synthetic solar
spectrum, bands split at 10000 cm-1, total-transmission search), and holds
float32 to the bounds PARITY.md sets for the reference's own float32:

  reorder      the sorting variable to 1e-5; a rank that moves is a tie,
               two values whose order the float32 rounding of each can swap
  search       every candidate cost the float32 search computed, against
               the float64 cost of the same probe: LW 1e-5, SW 2e-4 of the
               cost's scale (the cost of a zero flux fit: the cost is a
               difference of fluxes, so its rounding is that of the fluxes)
  g-points     the ranks and per-g-point errors of the two searches
  LUT          on the float64 search's g-points: linear averaging 1e-5 of
               each entry, transmission 5e-4 plus the conditioning of
               -log1p(-mean) near 1 (8 float32 ulp of the mean, which moves
               od by ulp * exp(1.66 od) / 1.66)

Two limits of float32 move costs and ranks beyond those bounds, and the
comparison shows each by giving the float64 search float32's limits (the
cost kernels' ``fit_limits``) and finding float32 within the bounds again:
the transmission clamp (``1 - 1e-6`` in float32, where -log1p(-mean)
caps the LW fitted od at ~8.3) and the range of the total-transmission
fit's level fluxes (``ssi * exp(-2 * cumulative od)`` underflows in
float32 where float64 keeps it, and an interval with an empty flux falls
back to the linear fit).  Float64 takes only those two limits, not
float32's rounding, and every probe whose costs they leave alone is held
to the bound in float32 as it is.  :func:`compare` returns the levels and
the failures; an empty list of failures is the pass.

Usage: ``python -m ecckd_tpu_torch.scripts.precision [lw|sw ...]
[device=cpu]`` prints one JSON line a rig.
"""

from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import numpy as np
import torch

from ..constants import ACCEL_GRAVITY, MOLAR_MASS_DRY_AIR
from ..models import ConcDependence
from ..tools.common import resolve_device
from ..tools.create_lut import LutGas, SolarSpectrum, create_lut_core
from ..tools.find_g_points import GasInput, find_g_points_core
from ..tools.reorder_spectrum import reorder_core

#: PARITY.md's bounds for the reference's float32 (max relative error
#: against float64)
COST_BOUND = {"lw": 1e-5, "sw": 2e-4}
LINEAR_BOUND = 1e-5
TRANSMISSION_BOUND = 5e-4
SORTING_BOUND = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
CONC = 0.01


def small_rig(kind):
    """(profiles, ssi, bands, tolerance) of the LW or SW rig, the spectra
    of ``tests/synth.py`` (``synth_spectrum_file``, and ``synth_ssi_file``
    for SW) as arrays: lines of varying strength on a continuum, od stored
    as float32."""
    sw = kind == "sw"
    nwav, nlay = 1024, 15
    ncol, seed = (6, 11) if sw else (5, 3)
    rng = np.random.default_rng(seed)
    wav = (np.linspace(250.0, 50000.0, nwav) if sw
           else np.linspace(1.0, 2000.0, nwav))
    k = np.full(nwav, 1e-4)
    centres = rng.uniform(wav[0], wav[-1], 60)
    strengths = 10.0 ** rng.uniform(-1, 3.5, 60)
    widths = rng.uniform(2, 30, 60) * (wav[-1] - wav[0]) / 2000.0
    for c0, s, wd in zip(centres, strengths, widths):
        k = k + s / (1.0 + ((wav - c0) / wd) ** 2)
    p = np.exp(np.linspace(np.log(100.0), np.log(1.013e5), nlay + 1))
    col_mass = np.diff(p) / 9.80665 / 0.02897
    profiles = []
    for icol in range(ncol):
        t = np.linspace(210.0 + 8 * icol, 284.0 + 8 * icol, nlay + 1)
        od = (CONC * col_mass[:, None] * 1e-3 * k[None, :]
              * np.exp(0.02 * (t[1:, None] - 250.0)))
        profiles.append(SimpleNamespace(
            pressure_hl=p, temperature_hl=t, wavenumber=wav,
            d_wavenumber=np.gradient(wav),
            optical_depth=od.astype(np.float32).astype(np.float64),
            ncol=ncol))
    if not sw:
        return profiles, None, (None, None), 0.4
    ssi = 20.0 * np.exp(-((wav - 20000.0) / 15000.0) ** 2) + 0.5
    return (profiles, ssi * (1361.0 / ssi.sum()),
            ([250.0, 10000.0], [10000.0, 50000.0]), 0.5)


def _search(profiles, ssi, order, hr_tol, device, dtype, limits=None):
    """find_g_points_core on ``order`` with a kernel per band (the
    comparison holds each band's probes in its own kernel), its interval
    fits taking the clamp and range of ``limits`` (a float dtype; None:
    ``dtype``'s): (g-points, the candidate-cost kernels by band, every
    probe as (kernel, i1, i2, costs))."""
    sp = profiles[0]
    gas = GasInput("h2o", order["rank"], order["band_number"],
                   order["wavenumber1_band"], order["wavenumber2_band"],
                   order["sorting_variable"], sp.pressure_hl,
                   sp.temperature_hl, sp.wavenumber, sp.d_wavenumber,
                   sp.optical_depth, min_scaling=0.5, max_scaling=2.5)
    calls = []
    gp = find_g_points_core(
        [gas], hr_tol, averaging_method=("total-transmission"
                                         if ssi is not None
                                         else "transmission"),
        device=device, dtype=dtype, ssi=ssi, band_parallel="off",
        cost_options=dict(fit_limits=limits, probe_log=calls))
    kernels = []
    for k, *_ in calls:
        if k not in kernels:
            kernels.append(k)
    return gp, kernels, calls


def _errors(probes, costs64, scales):
    """|cost32 - cost64| over the cost scale of every interval of every
    float32 probe (band, i1, i2, costs), in one array."""
    return np.concatenate([np.abs(c32 - c64) / scale
                           for (_, _, _, c32), c64, scale
                           in zip(probes, costs64, scales)])


def _ranks(gp):
    g = gp.gases[0]
    return np.asarray(g.rank1), np.asarray(g.rank2)


def _lut(profiles, ssi, gp, method, device, dtype):
    sp = profiles[0]
    gas = LutGas("h2o", ConcDependence.LINEAR,
                 [lambda icol: (profiles[icol], CONC)])
    solar = (SolarSpectrum(ssi, float(ssi.sum()), sp.wavenumber)
             if ssi is not None else None)
    model = create_lut_core(gp.g_point, gp.wavenumber1_band,
                            gp.wavenumber2_band, gp.band_number, [gas],
                            averaging_method=method, device=device,
                            dtype=dtype, solar=solar,
                            solar_irradiance=gp.solar_irradiance)
    return model.single_gas_data[0].molar_abs


def compare(kind, device="cpu"):
    """Hold the float32 chain against the float64 chain on the ``kind``
    ('lw' or 'sw') rig on ``device``; returns (levels, failures)."""
    device = resolve_device(device)
    profiles, ssi, bands, hr_tol = small_rig(kind)
    bound = COST_BOUND[kind]
    sp = profiles[0]
    f64, f32 = torch.float64, torch.float32
    lev, fail = {"rig": kind, "device": str(device)}, []

    # reorder: the sorting variable, and every moved rank a tie
    orders = {dt: reorder_core(sp.pressure_hl, sp.wavenumber,
                               sp.d_wavenumber, sp.optical_depth, *bands,
                               threshold_optical_depth=(0.25 if ssi is not None
                                                        else 0.5),
                               device=device, dtype=dt,
                               do_sw=ssi is not None)
              for dt in (f64, f32)}
    sv64 = orders[f64]["sorting_variable"]
    sv32 = orders[f32]["sorting_variable"]
    rounding = np.abs(sv32 - sv64)
    lev["sorting_variable"] = float(np.max(rounding / np.abs(sv64)))
    moved = orders[f64]["rank"] != orders[f32]["rank"]
    lev["order_ranks_moved"] = int(moved.sum())
    at = np.empty(len(sv64), np.int64)
    at[orders[f32]["rank"]] = np.arange(len(sv64))
    a, b = at[:-1], at[1:]
    same_band = orders[f32]["band_number"][a] == orders[f32]["band_number"][b]
    inverted = same_band & (sv64[b] < sv64[a])
    untied = inverted & (sv64[a] - sv64[b] > rounding[a] + rounding[b])
    lev["order_inversions"] = int(inverted.sum())
    if lev["sorting_variable"] > SORTING_BOUND:
        fail.append(f"sorting variable {lev['sorting_variable']:.3e} > "
                    f"{SORTING_BOUND}")
    if untied.any():
        fail.append(f"{int(untied.sum())} order inversions wider than "
                    "float32's rounding of the sorting variable")

    # search, from the float64 order: float64, float32, and float64 with
    # float32's limits; every float32 probe evaluated by the other two
    order = orders[f64]
    gp64, k64, _ = _search(profiles, ssi, order, hr_tol, device, f64)
    gp32, k32, calls32 = _search(profiles, ssi, order, hr_tol, device, f32)
    gpl, kl, _ = _search(profiles, ssi, order, hr_tol, device, f64, f32)
    probes = [(k32.index(k), i1, i2, c) for k, i1, i2, c in calls32]
    scales = [k64[j].zero_fit_costs(i1, i2) for j, i1, i2, _ in probes]
    c64 = [k64[j].costs(i1, i2) for j, i1, i2, _ in probes]
    climits = [kl[j].costs(i1, i2) for j, i1, i2, _ in probes]
    native = _errors(probes, c64, scales)
    limited = _errors(probes, climits, scales)
    # the intervals whose float64 costs float32's limits change, and (SW)
    # those whose fit falls back for an empty flux in float32 and not in
    # float64
    touched = np.concatenate(c64) != np.concatenate(climits)
    fallback = [np.concatenate([k[j].linear_fallback(i1, i2)
                                for j, i1, i2, _ in probes])
                if ssi is not None else np.zeros(len(native), bool)
                for k in (k32, k64)]
    lev["probes"] = len(probes)
    lev["intervals"] = len(native)
    lev["probe_err_native"] = float(native.max())
    lev["intervals_beyond_bound_native"] = int((native > bound).sum())
    lev["intervals_touched_by_limits"] = int(touched.sum())
    empty32 = fallback[0] & ~fallback[1]
    lev["intervals_empty_in_float32_only"] = int(empty32.sum())
    lev["intervals_touched_not_empty_in_float32_only"] = int(
        (touched & ~empty32).sum())
    lev["probe_err_native_untouched"] = float(
        native[~touched].max(initial=0.0))
    lev["probe_err_float32_limits"] = float(limited.max())
    if limited.max() > bound:
        fail.append(f"probe cost error {limited.max():.3e} > {bound} with "
                    "float32's clamp and range in float64")
    # SW takes no transmission clamp: its limit is the range alone
    if ssi is not None and lev["intervals_touched_not_empty_in_float32_only"]:
        fail.append(f"{lev['intervals_touched_not_empty_in_float32_only']} "
                    "intervals whose float64 costs float32's limits change "
                    "have no empty flux in float32 that float64 lacks")
    if lev["probe_err_native_untouched"] > bound:
        fail.append("native probe cost error "
                    f"{lev['probe_err_native_untouched']:.3e} > {bound} "
                    "where float32's limits change no float64 cost")
    r64, r32, rl = _ranks(gp64), _ranks(gp32), _ranks(gpl)
    lev["ranks_identical_native"] = all(np.array_equal(x, y)
                                        for x, y in zip(r64, r32))
    lev["ranks_identical_float32_limits"] = all(
        np.array_equal(x, y) for x, y in zip(rl, r32))
    if not lev["ranks_identical_float32_limits"]:
        fail.append("float32 ranks differ from float64's with float32's "
                    "clamp and range")
    else:
        g32, gl = gp32.gases[0], gpl.gases[0]
        i1, i2 = r32
        err = np.abs(np.asarray(g32.error) - np.asarray(gl.error))
        # the final g-points' intervals, by band, in the band's kernel
        bands_of = np.asarray(g32.band_number)
        scale = np.concatenate([
            k64[j].zero_fit_costs(*_band_local(order, j, i1[bands_of == j],
                                               i2[bands_of == j]))
            for j in range(len(k64))])
        lev["error_err_float32_limits"] = float(np.max(err / scale))
        if lev["error_err_float32_limits"] > bound:
            fail.append("per-g-point errors differ by "
                        f"{lev['error_err_float32_limits']:.3e} > {bound}")
    if not lev["ranks_identical_native"] and not (
            lev["intervals_beyond_bound_native"] > 0
            and lev["ranks_identical_float32_limits"]):
        fail.append("float32 ranks moved with every probe within the bound")

    # LUT on the float64 search's g-points
    col = (CONC * np.diff(sp.pressure_hl)
           / (ACCEL_GRAVITY * 0.001 * MOLAR_MASS_DRY_AIR))
    for method in ("linear", "transmission"):
        l64, l32 = (_lut(profiles, ssi, gp64, method, device, dt)
                    for dt in (f64, f32))
        rel = np.abs(l32 - l64) / np.abs(l64)
        if method == "linear":
            lev["lut_linear"] = float(rel.max())
            if rel.max() > LINEAR_BOUND:
                fail.append(f"linear LUT {rel.max():.3e} > {LINEAR_BOUND}")
            continue
        x = np.clip(1.66 * l64 * col[None, :, None], 1e-12, 700.0)
        allowed = TRANSMISSION_BOUND + 8 * EPS32 * np.exp(x) / x
        lev["lut_transmission"] = float(rel.max())
        lev["lut_transmission_over_allowed"] = float(np.max(rel / allowed))
        lev["lut_transmission_well_conditioned"] = float(
            rel[allowed <= 2 * TRANSMISSION_BOUND].max(initial=0.0))
        if np.any(rel > allowed):
            fail.append("transmission LUT beyond 5e-4 and its conditioning "
                        f"({lev['lut_transmission_over_allowed']:.3f} of "
                        "it)")
    return lev, fail


def _band_local(order, band, i1, i2):
    """Global rank bounds of a band's g-points as the band kernel's local
    indices."""
    first = int(np.sum(np.asarray(order["band_number"]) < band))
    return np.asarray(i1) - first, np.asarray(i2) - first


def main(argv):
    keys = dict(a.split("=", 1) for a in argv if "=" in a)
    kinds = [a for a in argv if "=" not in a] or ["lw", "sw"]
    failed = False
    for kind in kinds:
        lev, fail = compare(kind, keys.get("device", "cuda"))
        print(json.dumps({**lev, "failures": fail}), flush=True)
        failed |= bool(fail)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
