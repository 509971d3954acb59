"""find_g_points: partition reordered spectra into g-points.

PyTorch counterpart of ``ecckd_tpu/tools/find_g_points.py``
(ref find_g_points.cpp:430-1662).  Per gas and band an equipartition search
finds rank intervals of equal heating-rate error; every sweep of candidate
intervals is one call of a candidate-cost kernel,
:class:`~ecckd_tpu_torch.partition.CandidateCostLw` (kernels K3 and K1 on
the card) in the longwave or
:class:`~ecckd_tpu_torch.partition.CandidateCostSw` (K3 and K2) in the
shortwave, where ``ssi`` is given.  Covered: per-gas background spectra,
min/max g-point overrides with sqrt-spaced re-initialisation,
``g_split`` sub-bands, base_split/base_wavenumber_boundary dissection, the
SW total-transmission method with its low/high scaled runs, the SW cloud
pseudo-gas, ``debug_partition``, ``band_parallel`` (every band's search on
its own thread against one gas-level kernel,
:mod:`~ecckd_tpu_torch.partition.band_parallel`), the cost kernels'
prefix path (``cost_options={"use_prefix": True}``), the hypercube gas
overlap and the g-point NetCDF schema, and ``sharded`` sweeps: with a
mesh (:mod:`ecckd_tpu_torch.parallel`) every candidate-cost kernel splits
its band's wavenumbers over the mesh's spectral shards.

:func:`find_g_points_core` works on arrays; :func:`find_g_points` is the
file tool around it (``python -m ecckd_tpu_torch.tools.find_g_points
key=value ... [device=cuda|cpu] [profile_dir=DIR]``; ``profile_dir``: a
``torch.profiler`` trace of the core with the port's spans of every
thread, :class:`~.common.maybe_profile`).
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import logs
from ..config import Config
from ..constants import LW_DIFFUSIVITY, REFERENCE_COS_SZA
from ..ops.heating_rate import heating_rate
from ..ops.planck import planck_function
from ..ops.rt_lw import rt_lw
from ..ops.rt_sw import rt_direct_sw, rt_norayleigh_sw
from ..ops.streaming import block_results, read_ahead
from ..partition import (CandidateCostLw, CandidateCostSw, CkdEquipartition,
                         SingleGasData, merged_g_point_map, overlap_g_points)
from ..partition.band_parallel import BandKernelView, ProbeScheduler
from .common import (device_tensor, find_file, maybe_profile,
                     netcdf_format, read_string_list, resolve_device, setup,
                     sharded_mesh, tool_prologue)

# Surface albedo of the no-Rayleigh SW bands (find_g_points.cpp:415-417)
REFERENCE_ALBEDO = 0.15
# Wavenumbers a block of a gas's od copied to the device (_device_copy):
# at 5.6M x 50 float64 on an H100, blocks of 2^17-2^21 all copy at ~20
# GB/s once staged, and 2^20 was the steadiest (PERF.md)
COPY_BLOCK_WAV = 1 << 20


@dataclasses.dataclass
class GasInput:
    """One gas's inputs to the g-point search, in wavenumber order.

    The order fields come from reorder_spectrum; ``optical_depth`` and
    ``bg_optical_depth`` are (nlay, nwav) float64 arrays of one profile
    (the background is the sum of the other gases, or None).  The
    per-band overrides default to the reference's values; the SW
    total-transmission method scales the gas's od by at most
    ``min(0.5, min_scaling)`` and at least ``max(2.5, max_scaling)``.
    ``g_split`` (per band; -1 for none) splits the optically thin part of
    a band, its ranks up to that fraction of the band, into sub-bands at
    ``subband_wavenumber_boundary``, each searched on its own (ref
    find_g_points.cpp:788-870); it excludes ``base_split``."""
    name: str
    rank: np.ndarray
    band_number: np.ndarray
    wavenumber1_band: np.ndarray
    wavenumber2_band: np.ndarray
    sorting_variable: np.ndarray
    pressure_hl: np.ndarray
    temperature_hl: np.ndarray
    wavenumber: np.ndarray
    d_wavenumber: np.ndarray
    optical_depth: np.ndarray
    bg_optical_depth: Optional[np.ndarray] = None
    base_split: Optional[Sequence[float]] = None
    min_g_points: Optional[Sequence[int]] = None
    max_g_points: Optional[Sequence[int]] = None
    base_wavenumber_boundary: Sequence[float] = ()
    min_scaling: float = 1.0
    max_scaling: float = 1.0
    g_split: Optional[Sequence[float]] = None
    subband_wavenumber_boundary: Optional[Sequence[float]] = None


@dataclasses.dataclass
class CloudInput:
    """The SW cloud pseudo-gas: the fields of its order file (written by
    reorder_cloud_spectrum, this package's or the JAX package's) and the
    largest range of reflectance one of its g-points may span."""
    name: str
    rank: np.ndarray
    band_number: np.ndarray
    wavenumber1_band: np.ndarray
    wavenumber2_band: np.ndarray
    sorting_variable: np.ndarray
    max_reflectance_range: float = 0.26


@dataclasses.dataclass
class GPoints:
    """Result of :func:`find_g_points_core`: per-gas g-points, the merged
    g-points' band numbers, the merged per-wavenumber map and, in the
    shortwave, the solar irradiance of each merged g-point."""
    gases: List[SingleGasData]
    band_number: np.ndarray
    g_point: np.ndarray
    wavenumber1_band: np.ndarray
    wavenumber2_band: np.ndarray
    wavenumber: np.ndarray
    solar_irradiance: Optional[np.ndarray] = None


@dataclasses.dataclass
class _Shortwave:
    """The SW state of a search.  ``max_no_rayleigh_wavenumber`` is
    reassigned by each gas to the largest bound of its no-Rayleigh bands
    and carries over to the next gas, as in the reference."""
    ssi: np.ndarray
    max_no_rayleigh_wavenumber: float
    cos_sza: float = REFERENCE_COS_SZA


def calc_median_sorting_variable(sorting_variable, weight, i1, i2):
    """Weight-weighted median of the sorting variable over [i1, i2]
    (ref find_g_points.cpp:36-49)."""
    w = np.asarray(weight[i1:i2 + 1])
    half = 0.5 * w.sum()
    idx = int(np.searchsorted(np.cumsum(w), half))
    idx = min(idx, i2 - i1)   # loop runs iind < i2 so caps at i2
    return float(sorting_variable[i1 + idx])


def _sqrt_bounds(ng):
    return np.sqrt(np.arange(ng + 1, dtype=np.float64) / ng)


def _per_band(values, nband, fill, dtype):
    out = np.full(nband, fill, dtype)
    if values is not None:
        n = min(nband, len(values))
        out[:n] = np.asarray(values)[:n]
    return out


def _lw_truth(temperature_hl, pressure_hl, wavenumber, d_wavenumber, od,
              bg_od, block_wav):
    """LW truth fields (planck_hl, hr, flux_dn_surf, flux_up_toa) on the
    device of ``od``, computed in wavenumber blocks so the full spectral
    flux arrays never exist (ref find_g_points.cpp:1060-1110)."""
    nlay, nwav = od.shape
    planck_hl = torch.empty((nlay + 1, nwav), dtype=od.dtype,
                            device=od.device)
    hr = torch.empty_like(od)
    flux_dn_surf = torch.empty(nwav, dtype=od.dtype, device=od.device)
    flux_up_toa = torch.empty_like(flux_dn_surf)
    for i0 in range(0, nwav, block_wav):
        sl = slice(i0, min(i0 + block_wav, nwav))
        pblk = planck_function(temperature_hl, wavenumber[sl],
                               d_wavenumber[sl])
        tot = od[:, sl] if bg_od is None else bg_od[:, sl] + od[:, sl]
        fd, fu = rt_lw(pblk, tot, torch.ones_like(pblk[-1]), pblk[-1])
        planck_hl[:, sl] = pblk
        hr[:, sl] = heating_rate(pressure_hl, fd, fu)
        flux_dn_surf[sl] = fd[-1]
        flux_up_toa[sl] = fu[0]
    return planck_hl, hr, flux_dn_surf, flux_up_toa


def _sw_truth(cos_sza, pressure_hl, ssi, od, bg_od, albedo, scalings,
              block_wav):
    """SW truth fields on the device of ``od`` in wavenumber blocks: the
    direct-beam heating rate and surface flux, and with ``scalings`` =
    (min_scaling, max_scaling, use_albedo) the ``extras`` of the
    total-transmission method, the same fields of the runs with the gas's
    od scaled (with the reflected beam's TOA flux where ``use_albedo``,
    else zeros) (ref find_g_points.cpp:906-960)."""
    nlay, nwav = od.shape
    hr = torch.empty_like(od)
    flux_dn_surf = torch.empty(nwav, dtype=od.dtype, device=od.device)
    extras = None
    if scalings is not None:
        extras = {}
        for tag in ("low", "high"):
            extras[f"hr_{tag}"] = torch.empty_like(od)
            extras[f"flux_dn_surf_{tag}"] = torch.empty_like(flux_dn_surf)
            extras[f"flux_up_toa_{tag}"] = torch.zeros_like(flux_dn_surf)
    for i0 in range(0, nwav, block_wav):
        sl = slice(i0, min(i0 + block_wav, nwav))
        bg = None if bg_od is None else bg_od[:, sl]
        tot = od[:, sl] if bg is None else bg + od[:, sl]
        fd = rt_direct_sw(cos_sza, ssi[sl], tot)
        hr[:, sl] = heating_rate(pressure_hl, fd)
        flux_dn_surf[sl] = fd[-1]
        if extras is None:
            continue
        min_scaling, max_scaling, use_albedo = scalings
        for tag, scaling in (("low", min_scaling), ("high", max_scaling)):
            od_s = scaling * od[:, sl]
            if bg is not None:
                od_s = bg + od_s
            if use_albedo:
                fds, fus = rt_norayleigh_sw(cos_sza, ssi[sl], od_s,
                                            albedo[sl])
                extras[f"flux_up_toa_{tag}"][sl] = fus[0]
            else:
                fds = rt_direct_sw(cos_sza, ssi[sl], od_s)
            extras[f"hr_{tag}"][:, sl] = heating_rate(pressure_hl, fds)
            extras[f"flux_dn_surf_{tag}"][sl] = fds[-1]
    return hr, flux_dn_surf, extras


def _cloud_pseudo_gas(cloud: CloudInput, ssi: np.ndarray) -> SingleGasData:
    """SW cloud pseudo-gas: per band, g-points of equal solar energy, as
    many as the band's reflectance range needs at ``max_reflectance_range``
    each (ref find_g_points.cpp:545-651).  Host numpy, as in the JAX
    package."""
    irank = np.asarray(cloud.rank).astype(np.int64).copy()
    iband = np.asarray(cloud.band_number)
    sorting_variable = np.asarray(cloud.sorting_variable)
    nband = len(cloud.wavenumber1_band)
    n_g_points = np.zeros(nband, np.int64)
    rank1_l, rank2_l, band_l, error_l, median_l = [], [], [], [], []
    for jband in range(nband):
        logs.log(f"Band {jband}")
        band_index = np.nonzero(iband == jband)[0]
        ibegin, iend = band_index[0], band_index[-1]
        sv_band = sorting_variable[ibegin:iend + 1]
        ng_band = int((sv_band.max() - sv_band.min())
                      / cloud.max_reflectance_range) + 1
        n_g_points[jband] = ng_band
        # Partition into equal ranges of solar energy
        ireorder = np.empty(len(band_index), np.int64)
        ireorder[irank[ibegin:iend + 1] - ibegin] = np.arange(ibegin,
                                                              iend + 1)
        cum_ssi = np.full(len(irank), -1.0)
        cum_ssi[ireorder] = np.cumsum(ssi[ireorder])
        band_irradiance = ssi[ibegin:iend + 1].sum()
        d_irr = band_irradiance * (1.0 + 1.0e-8) / ng_band
        for jg in range(ng_band):
            idx = np.nonzero((iband == jband) & (cum_ssi >= jg * d_irr)
                             & (cum_ssi < (jg + 1) * d_irr))[0]
            rank1_l.append(int(irank[idx].min()))
            rank2_l.append(int(irank[idx].max()))
            error_l.append(float(sorting_variable[idx].max()
                                 - sorting_variable[idx].min()))
            # -2 keeps cloud sorting variables below those of gases
            median_l.append(-2.0 + float(sorting_variable[idx].mean()))
            band_l.append(jband)
    gas = SingleGasData(
        molecule=cloud.name, n_g_points=n_g_points,
        band_number=np.asarray(band_l, np.int32),
        rank1=np.asarray(rank1_l, np.int64),
        rank2=np.asarray(rank2_l, np.int64),
        error=np.asarray(error_l), sorting_variable=np.asarray(median_l))
    gas.store_g_points(irank)
    gas.print()
    return gas


def _debug_partition(gas_name, jband, eq, bounds, kernel):
    """Print the final partition's cost components to stderr (ref
    find_g_points.cpp:1416-1423).  Only the SW cost function has
    components (calc_cost_function_sw.cpp:93-105); LW prints the band
    header alone, as the reference does."""
    print(f"debug_partition_{gas_name.upper()}_band = {jband}",
          file=sys.stderr)
    if not isinstance(kernel, CandidateCostSw):
        return
    i1 = np.asarray([eq.lower_index(b) for b in bounds[:-1]], np.int32)
    i2 = np.asarray([eq.upper_index(b) for b in bounds[1:]], np.int32)
    i2 = np.maximum(i1, i2)
    comps = kernel.components(i1, i2)
    fmt = lambda v: np.array2string(np.atleast_1d(v), max_line_width=10 ** 9,
                                    separator=" ")
    for ig in range(len(i1)):
        for tag, c in comps.items():
            if len(comps) > 1:
                print(f"  debug_partition_{tag}", file=sys.stderr)
            for key in ("flux_dn_surf_true", "flux_dn_surf_fit",
                        "flux_up_toa_true", "flux_up_toa_fit", "hr_true",
                        "hr_fit", "cf_hr", "cf_flux"):
                print(f"    debug_partition.{key} = "
                      f"{fmt(c[key][..., ig])}", file=sys.stderr)


def _check_splits(g_split, subband_wavenumber_boundary, base_split):
    """The JAX tool's errors for ``g_split`` (ecckd_tpu/tools/
    find_g_points.py:360-383)."""
    if g_split is None:
        return
    if subband_wavenumber_boundary is None:
        raise ValueError("g_split must be accompanied by "
                         "subband_wavenumber_boundary")
    if base_split is not None:
        raise ValueError("Cannot use both g_split and base_split")


def _g_split_subbands(irank, ireorder, iband, wavenumber, band_bound1,
                      band_bound2, g_split, subband_wavenumber_boundary):
    """Re-rank the optically thin part of each ``g_split`` band by
    sub-band (ref find_g_points.cpp:788-870): within a band, ranks up to
    the fraction ``g_split`` of the band are renumbered sub-band by
    sub-band, in rank order inside each.  Returns (irank, ireorder,
    subbands), where ``subbands[jband]`` is None or (the (g_start, g_end)
    range of each sub-band, the start of the final overarching sub-band or
    None, the band's g_split)."""
    nband = len(band_bound1)
    subbands = [None] * nband
    for jband in range(nband):
        in_band = ((subband_wavenumber_boundary > band_bound1[jband])
                   & (subband_wavenumber_boundary < band_bound2[jband]))
        if not (g_split[jband] > 0.0 and np.any(in_band)):
            continue
        ibandloc = np.nonzero(iband == jband)[0]
        irank1 = int(ibandloc[0])
        irank3 = int(ibandloc[-1])
        irank2 = irank3
        if g_split[jband] < 1.0:
            irank2 = int(ibandloc[0] + g_split[jband] * (irank3 - irank1))
        nsub = 1 + int(np.sum(in_band))
        wn_bound = np.empty(nsub + 1)
        wn_bound[0] = band_bound1[jband]
        wn_bound[-1] = band_bound2[jband] + 1.0
        if nsub > 1:
            wn_bound[1:-1] = subband_wavenumber_boundary[in_band]
        logs.log(f"  Splitting optically thin part of band {jband} into "
                 f"{nsub} sub-bands")
        wavenumber_cm_1 = wavenumber[ireorder]
        position = irank[ireorder]
        irank_new = irank.copy()
        isub1 = np.empty(nsub, np.int64)
        isub2 = np.empty(nsub, np.int64)
        isub1[0] = irank1
        for isub in range(nsub):
            if isub > 0:
                isub1[isub] = isub2[isub - 1] + 1
            idx = np.nonzero((wavenumber_cm_1 >= wn_bound[isub])
                             & (wavenumber_cm_1 < wn_bound[isub + 1])
                             & (position >= irank1)
                             & (position <= irank2))[0]
            isub2[isub] = isub1[isub] + len(idx) - 1
            irank_new[ireorder[idx]] = np.arange(isub1[isub],
                                                 isub2[isub] + 1)
            logs.log(f"    Creating {wn_bound[isub]}-{wn_bound[isub + 1]} "
                     f"cm-1 sub-band: {len(idx)} spectral points")
        if isub2[-1] != irank2:
            raise ValueError("Failed to account for all wavenumbers in "
                             "split")
        irank = irank_new
        ireorder[irank] = np.arange(len(irank))
        denom = float(irank3 - irank1)
        ranges = [((isub1[k] - irank1) / denom, (isub2[k] - irank1) / denom)
                  for k in range(nsub)]
        final = ((isub2[-1] - irank1) / denom if g_split[jband] < 1.0
                 else None)
        subbands[jband] = (ranges, final, float(g_split[jband]))
    return irank, ireorder, subbands


def _search_band(kernel, tolerance, tolerance_tolerance, max_iterations,
                 min_g, max_g, subbands=None):
    """One band's equipartition search (ref find_g_points.cpp:1152-1266):
    with the min/max g-point overrides, or sub-band by sub-band where
    ``subbands`` (from :func:`_g_split_subbands`) is given, the final
    overarching sub-band re-initialised to at least ``min_g`` g-points
    overall.  Touches only its own search and kernel, so band threads may
    run it side by side.  Returns (istatus, bounds, error, ng, eq)."""
    with logs.span("ecckd.find_g_points.search"):
        eq = CkdEquipartition(kernel)
        eq.set_partition_max_iterations(max_iterations)
        eq.set_partition_tolerance(tolerance_tolerance)
        eq.set_verbose(False)
        if subbands is not None:
            ranges, final, g_split = subbands
            bounds_l: List[float] = []
            error_l: List[float] = []
            ng = 0
            for jsub, (g_start, g_end) in enumerate(ranges):
                logs.log(f"  Subband {jsub}: g range {g_start}-{g_end}")
                istatus, sb, se = eq.equipartition_e(tolerance, g_start, g_end)
                if ng == 0:
                    bounds_l = list(sb)
                else:
                    bounds_l[ng:ng] = list(sb)
                error_l.extend(se)
                ng += len(se)
            if final is not None:
                logs.log(f"  Final overarching subband: g range {final}-1.0")
                istatus, sb, se = eq.equipartition_e(tolerance, final, 1.0)
                nsubg = len(se)
                if ng + nsubg < min_g:
                    nsubg = int(min_g) - ng
                    sb = g_split + (1.0 - g_split) * _sqrt_bounds(nsubg)
                    se = np.zeros(nsubg)
                    eq.invalidate()
                    istatus = eq.equipartition_n(sb, se)
                bounds_l[ng:ng] = list(sb)
                error_l.extend(se)
                ng += nsubg
            return (istatus, np.asarray(bounds_l[:ng + 1]),
                    np.asarray(error_l), ng, eq)
        istatus, bounds, error = eq.equipartition_e(tolerance, 0.0, 1.0)
        ng = len(error)
        if ng < min_g or ng > max_g:
            logs.log(f"  {ng} intervals is "
                     + (f"fewer than minimum of {min_g}" if ng < min_g
                        else f"more than maximum of {max_g}"))
            ng = int(min_g if ng < min_g else max_g)
            bounds = _sqrt_bounds(ng)
            error = np.zeros(ng)
            eq.invalidate()
            istatus = eq.equipartition_n(bounds, error)
        return istatus, bounds, error, ng, eq


_BAND_MODES = {"parallel": "parallel", "1": "parallel", "yes": "parallel",
               "true": "parallel", "serial": "serial",
               "serial_gas": "serial", "off": "off", "0": "off",
               "no": "off", "false": "off", "auto": "auto"}


def _band_mode(band_parallel, device: torch.device, nband: int,
               debug_partition: bool) -> str:
    """The band mode of a gas of ``nband`` bands: "parallel", "serial" or
    "off" (ecckd_tpu/tools/find_g_points.py:701-713).  "auto" is "parallel" on
    the card, as the JAX tool's is on its accelerator, and "off" on the
    CPU, where the plain versions' sums of an interval depend on the rest
    of the launch; one band and ``debug_partition`` (which needs
    band-local kernels) are always "off"."""
    key = str(band_parallel).lower()
    if key not in _BAND_MODES:
        raise ValueError(f"band_parallel={band_parallel!r} not understood; "
                         "choose auto, parallel, serial or off")
    mode = _BAND_MODES[key]
    if mode == "auto":
        mode = "parallel" if device.type == "cuda" else "off"
    if nband <= 1 or debug_partition:
        mode = "off"
    return mode


def _search_bands(kernel, band_ranges, search, mode):
    """Every band's search against the gas-level ``kernel``, through a
    :class:`BandKernelView` of its ranks: one band after another
    ("serial"), or each on its own thread with the probes of all bands
    merged into one dispatch ("parallel").  ``search(jband, view)`` is
    one band's search; returns {jband: its result}.  A band's exception,
    or a failed dispatch, is raised here after every thread has ended."""
    if mode == "serial":
        return {j: search(j, BandKernelView(kernel, b1, b2 - b1 + 1))
                for j, (b1, b2) in enumerate(band_ranges)}
    nband = len(band_ranges)
    logs.log(f"Batching equipartition probes across {nband} bands "
             "(band_parallel)")
    sched = ProbeScheduler(kernel)
    results = {}

    def run(jband):
        b1, b2 = band_ranges[jband]
        try:
            results[jband] = search(jband, BandKernelView(
                kernel, b1, b2 - b1 + 1, sched, jband))
        except BaseException as e:   # noqa: BLE001 (raised below)
            results[jband] = e
        finally:
            sched.done()

    # Every thread registers before any starts: an early starter must not
    # dispatch alone
    for _ in range(nband):
        sched.register()
    threads = [threading.Thread(target=logs.spawned(run), args=(j,),
                                name=f"ecckd-band{j}")
               for j in range(nband)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if sched.error is not None:
        raise sched.error
    for jband in range(nband):
        if isinstance(results[jband], BaseException):
            raise results[jband]
    logs.log(f"  band_parallel: {sched.dispatches} merged dispatches")
    return results


def _device_copy(a, device, dtype):
    """Host array ``a`` (nlay, nwav) as a ``dtype`` tensor on ``device``,
    copied on the port's block loop in blocks of ``COPY_BLOCK_WAV``
    wavenumbers: on a card each block is staged in page-locked memory on
    the prefetch thread and copied one block ahead into its slice of the
    result."""
    a = np.asarray(a)
    out = torch.empty(a.shape, dtype=dtype, device=device)

    def into_slice(i0, block):
        out[:, i0:i0 + block.shape[1]].copy_(block)
        return {}

    blocks = ((i0, a[:, i0:i0 + COPY_BLOCK_WAV])
              for i0 in range(0, a.shape[1], COPY_BLOCK_WAV))
    for _ in block_results(read_ahead(blocks, device), into_slice, device,
                           dtype):
        pass
    return out


def _search_gas(gas: GasInput, hr_tol, tolerance_tolerance, max_iterations,
                averaging_method, flux_weight, min_pressure, block_wav,
                device, dtype, sw: Optional[_Shortwave],
                debug_partition, cost_options, band_parallel, mesh=None
                ) -> SingleGasData:
    """Per-band equipartition of one gas (ref find_g_points.cpp:660-1455);
    shortwave where ``sw`` is given."""
    with logs.span("ecckd.find_g_points.prepare"):
        _check_splits(gas.g_split, gas.subband_wavenumber_boundary,
                      gas.base_split)
        irank = np.asarray(gas.rank).astype(np.int64).copy()
        iband = np.asarray(gas.band_number)
        band_bound1 = np.asarray(gas.wavenumber1_band, np.float64)
        band_bound2 = np.asarray(gas.wavenumber2_band, np.float64)
        nband = len(band_bound1)
        base_wavenumber_boundary = np.asarray(gas.base_wavenumber_boundary,
                                              np.float64)
        base_split = _per_band(gas.base_split, nband, 1.0, np.float64)
        min_g_points = _per_band(gas.min_g_points, nband, 1, np.int64)
        max_g_points = _per_band(gas.max_g_points, nband, 256, np.int64)
        if len(hr_tol) == 1:
            heating_rate_tolerance = np.full(nband, hr_tol[0])
        elif len(hr_tol) == nband:
            heating_rate_tolerance = np.asarray(hr_tol, np.float64)
        else:
            raise ValueError("heating_rate_tolerance must have either 1 "
                             "element, or one per band")
        if sw is not None:
            min_scaling = min(0.5, gas.min_scaling)
            max_scaling = max(2.5, gas.max_scaling)
            # Bands wholly below the no-Rayleigh limit reflect the direct beam
            # in the cost; the limit becomes their largest upper bound
            band_albedo = np.zeros(nband)
            no_rayleigh = band_bound2 <= sw.max_no_rayleigh_wavenumber
            band_albedo[no_rayleigh] = REFERENCE_ALBEDO
            if np.any(no_rayleigh):
                sw.max_no_rayleigh_wavenumber = band_bound2[no_rayleigh].max()

        # ireorder: index that reorders arrays into rank order.  g_split
        # re-ranks before the spectra are gathered into rank order.
        ireorder = np.empty(len(irank), np.int64)
        ireorder[irank] = np.arange(len(irank))
        subbands = [None] * nband
        if gas.g_split is not None:
            g_split = _per_band(gas.g_split, nband, -1.0, np.float64)
            logs.log("Bands will be split at g values according to: "
                     f"{g_split}")
            irank, ireorder, subbands = _g_split_subbands(
                irank, ireorder, iband, np.asarray(gas.wavenumber, np.float64),
                band_bound1, band_bound2, g_split,
                np.asarray(gas.subband_wavenumber_boundary, np.float64))
        sorting_variable = np.asarray(gas.sorting_variable)[ireorder]

        index = torch.from_numpy(ireorder).to(device)
        od = _device_copy(gas.optical_depth, device, dtype).index_select(
            1, index)
        col_od = od.sum(dim=1)
        logs.log(f"    Column optical depth: {col_od.mean().item():g} +/- "
                 f"{col_od.std(unbiased=False).item():g}")
        bg_od = None
        if gas.bg_optical_depth is not None:
            bg_od = _device_copy(gas.bg_optical_depth, device,
                                 dtype).index_select(1, index)
        wavenumber_cm_1 = np.asarray(gas.wavenumber)[ireorder]
        d_wavenumber_cm_1 = np.asarray(gas.d_wavenumber)[ireorder]
        pressure_hl = np.asarray(gas.pressure_hl, np.float64)
        nlay, nwav = od.shape
        logs.log(f"{nlay} layers\n{nwav} spectral points")
        band_ranges = []
        for jband in range(nband):
            band_index = np.nonzero(iband == jband)[0]
            band_ranges.append((int(band_index[0]), int(band_index[-1])))

    with logs.span("ecckd.find_g_points.truth"):
        extras = None
        if sw is None:
            logs.log("Computing Planck function and longwave radiative "
                     "transfer")
            planck_hl, hr, flux_dn_surf, flux_up_toa = _lw_truth(
                *(device_tensor(a, device, dtype)
                  for a in (gas.temperature_hl, pressure_hl, wavenumber_cm_1,
                            d_wavenumber_cm_1)), od, bg_od, block_wav)
            surf_planck = planck_hl[-1]
            weight_for_median = surf_planck.cpu().numpy().astype(np.float64)
        else:
            logs.log("Performing shortwave radiative transfer")
            ssi_reorder = sw.ssi[ireorder]
            # The truth reflects off the surface below the (reassigned)
            # no-Rayleigh limit, compared with "<" (find_g_points.cpp:497-501)
            albedo = np.zeros(nwav)
            albedo[np.asarray(gas.wavenumber)
                   < sw.max_no_rayleigh_wavenumber] = REFERENCE_ALBEDO
            scalings = None
            if averaging_method == "total-transmission":
                scalings = (min_scaling, max_scaling,
                            sw.max_no_rayleigh_wavenumber > 0.0)
            hr, flux_dn_surf, extras = _sw_truth(
                sw.cos_sza, device_tensor(pressure_hl, device, dtype),
                device_tensor(ssi_reorder, device, dtype), od, bg_od,
                device_tensor(albedo[ireorder], device, dtype), scalings,
                block_wav)
            flux_up_toa = torch.zeros_like(flux_dn_surf)
            weight_for_median = ssi_reorder

        layer_weight = np.sqrt(pressure_hl[1:]) - np.sqrt(pressure_hl[:-1])
        pressure_fl = 0.5 * (pressure_hl[1:] + pressure_hl[:-1])
        layer_weight[pressure_fl < min_pressure] = 0.0
        layer_weight /= layer_weight.sum()

        # ---- Metric (ref :1119-1150), transformed in place ----
        if averaging_method in ("transmission", "transmission-2"):
            scale = LW_DIFFUSIVITY * (
                2.0 if averaging_method == "transmission-2" else 1.0)
            metric = od.mul_(-scale).expm1_().neg_()
        elif averaging_method == "square-root":
            metric = od.sqrt_()
        elif averaging_method in ("linear", "logarithmic",
                                  "total-transmission"):
            metric = od
        else:
            raise ValueError(f"Averaging method {averaging_method!r} not "
                             "understood")
        if bg_od is None:
            bg_od = torch.zeros_like(metric)

    def make_kernel(sl, albedo):
        """The candidate-cost kernel over ranks ``sl``: one band, or the
        whole gas for band_parallel (bands are disjoint rank ranges, so a
        band's probes are global intervals of it)."""
        with logs.span("ecckd.find_g_points.prepare"):
            band = lambda a: a[..., sl].contiguous()
            state = dict(layer_weight=device_tensor(layer_weight, device,
                                                    dtype),
                         pressure_hl=device_tensor(pressure_hl, device,
                                                   dtype),
                         flux_dn_surf=band(flux_dn_surf),
                         flux_up_toa=band(flux_up_toa), bg_od=band(bg_od),
                         metric=band(metric), hr=band(hr))
            if sw is None:
                return CandidateCostLw(
                    averaging_method, flux_weight,
                    surf_emissivity=torch.ones_like(band(surf_planck)),
                    surf_planck=band(surf_planck), planck_hl=band(planck_hl),
                    mesh=mesh, **state, **cost_options)
            band_extras = None
            if extras is not None:
                band_extras = {k: band(v) for k, v in extras.items()}
                band_extras.update(min_scaling=min_scaling,
                                   max_scaling=max_scaling)
            return CandidateCostSw(
                averaging_method, flux_weight, cos_sza=sw.cos_sza,
                ssi=device_tensor(ssi_reorder[sl], device, dtype),
                surf_albedo=albedo,
                extras=band_extras, mesh=mesh, **state, **cost_options)

    def search(jband, kernel):
        return _search_band(
            kernel, heating_rate_tolerance[jband], tolerance_tolerance,
            max_iterations, min_g_points[jband], max_g_points[jband],
            subbands[jband])

    logs.log("Finding g points:")
    # ---- Cross-band probe batching (ref ecckd_tpu/tools/find_g_points.py
    # :690-767): one gas-level kernel, SW with each band's albedo ----
    band_results = {}
    gas_kernel = None
    mode = _band_mode(band_parallel, device, nband, debug_partition)
    if mode != "off":
        gas_albedo = None
        if sw is not None:
            gas_albedo = np.zeros(nwav)
            for jband, (b1, b2) in enumerate(band_ranges):
                gas_albedo[b1:b2 + 1] = band_albedo[jband]
            gas_albedo = device_tensor(gas_albedo, device, dtype)
        gas_kernel = make_kernel(slice(0, nwav), gas_albedo)
        band_results = _search_bands(gas_kernel, band_ranges, search, mode)

    n_g_points_per_band = []
    rank1_l, rank2_l, band_l, error_l, median_l = [], [], [], [], []
    for jband in range(nband):
        logs.log(f"Band {jband}")
        ibegin, iend = band_ranges[jband]
        if jband in band_results:
            kernel = gas_kernel
            istatus, bounds, error, ng, eq = band_results.pop(jband)
        else:
            kernel = make_kernel(slice(ibegin, iend + 1),
                                 None if sw is None
                                 else float(band_albedo[jband]))
            istatus, bounds, error, ng, eq = search(jband, kernel)
        with logs.span("ecckd.find_g_points.split"):
            logs.log(f"  Equipartition status: {istatus.describe()}")
            logs.log(f"      computational cost = {eq.total_comp_cost:.2f}")

            # ---- base_split dissection (ref :1268-1383) ----
            bwb_in_band = (len(base_wavenumber_boundary) > 0 and np.any(
                (base_wavenumber_boundary > band_bound1[jband])
                & (base_wavenumber_boundary < band_bound2[jband])))
            if base_split[jband] != 1.0 or bwb_in_band:
                bounds = list(bounds)
                error = list(error)
                if base_split[jband] > 1.0:
                    nabssplit = int(base_split[jband])
                    if nabssplit == 1:
                        raise ValueError("Positive values of base_split "
                                         "must be at least 2")
                else:
                    nabssplit = 2 + int(base_split[jband] * ng)
                in_band = ((base_wavenumber_boundary > band_bound1[jband])
                           & (base_wavenumber_boundary < band_bound2[jband]))
                nwavsplit = 1 + int(np.sum(in_band))
                wn_bound = np.empty(nwavsplit + 1)
                wn_bound[0] = band_bound1[jband]
                wn_bound[-1] = band_bound2[jband] + 1.0
                if nwavsplit > 1:
                    wn_bound[1:-1] = base_wavenumber_boundary[in_band]
                nsplit = nwavsplit * nabssplit
                logs.log(f"  Splitting base interval into {nsplit} pieces: "
                         f"{nwavsplit} by wavenumber * {nabssplit} by "
                         "absorption")
                iwav1 = np.zeros(nwavsplit, np.int64)
                iwav2 = np.zeros(nwavsplit, np.int64)
                iwav1[0] = ibegin
                iwav2[-1] = iend
                if nwavsplit > 1:
                    ind2 = eq.upper_index(bounds[1]) + ibegin
                    iwav1[0] = 0
                    irank_new = irank.copy()
                    for iws in range(nwavsplit):
                        if iws > 0:
                            iwav1[iws] = iwav2[iws - 1] + 1
                        sel = ((wavenumber_cm_1 >= wn_bound[iws])
                               & (wavenumber_cm_1 < wn_bound[iws + 1])
                               & (irank[ireorder] <= ind2))
                        idx = np.nonzero(sel)[0]
                        iwav2[iws] = iwav1[iws] + len(idx) - 1
                        irank_new[ireorder[idx]] = np.arange(iwav1[iws],
                                                             iwav2[iws] + 1)
                        logs.log(f"    Creating {wn_bound[iws]}-"
                                 f"{wn_bound[iws + 1]} cm-1 sub-band: "
                                 f"{len(idx)} spectral points")
                    if iwav2[-1] != ind2:
                        raise ValueError("Failed to account for all "
                                         "wavenumbers in split")
                    irank = irank_new
                    ireorder[irank] = np.arange(len(irank))
                    sorting_variable = sorting_variable[ireorder]
                    wavenumber_cm_1 = wavenumber_cm_1[ireorder]
                    if sw is not None:
                        ssi_reorder = weight_for_median = sw.ssi[ireorder]

                upper_bound = bounds[1]
                lower_bound_local = bounds[0]
                error[0] = -1.0
                ibnd = 0
                for iws in range(nwavsplit):
                    upper_bound_local = (upper_bound * iwav2[iws]
                                         / float(iwav2[-1]))
                    for iabs in range(nabssplit):
                        if iabs < nabssplit - 1 or iws < nwavsplit - 1:
                            bounds.insert(ibnd + 1, lower_bound_local
                                          + (upper_bound_local
                                             - lower_bound_local)
                                          * (iabs + 1) / float(nabssplit))
                            error.insert(ibnd, -1.0)
                            ibnd += 1
                    lower_bound_local = upper_bound_local
                ng += nsplit - 1

            bounds = np.asarray(bounds, np.float64)
            error = np.asarray(error, np.float64)
            if np.any(np.diff(bounds) <= 0.0):
                raise ValueError("Bounds are not monotonically increasing")
            n_g_points_per_band.append(ng)
            for ig in range(ng):
                ind1 = eq.lower_index(bounds[ig]) + ibegin
                ind2 = eq.upper_index(bounds[ig + 1]) + ibegin
                rank1_l.append(ind1)
                rank2_l.append(ind2)
                error_l.append(float(error[ig]))
                band_l.append(jband)
                median_l.append(calc_median_sorting_variable(
                    sorting_variable, weight_for_median, ind1, ind2))
            if debug_partition:
                _debug_partition(gas.name, jband, eq, bounds, kernel)
            kernel = eq = None   # free the band before the next one

    gas_data = SingleGasData(
        molecule=gas.name,
        n_g_points=np.asarray(n_g_points_per_band, np.int64),
        band_number=np.asarray(band_l, np.int32),
        rank1=np.asarray(rank1_l, np.int64),
        rank2=np.asarray(rank2_l, np.int64),
        error=np.asarray(error_l),
        sorting_variable=np.asarray(median_l))
    with logs.span("ecckd.find_g_points.store"):
        with logs.span("ecckd.find_g_points.store.map"):
            gas_data.store_g_points(irank, device)
        gas_data.print()
    return gas_data


def find_g_points_core(gases: Sequence[GasInput], heating_rate_tolerance,
                       tolerance_tolerance=0.02, max_iterations=60,
                       averaging_method="linear", flux_weight=0.02,
                       min_pressure=0.0, block_wav=1 << 20, device="cuda",
                       dtype=torch.float64, ssi=None,
                       cloud: Optional[CloudInput] = None,
                       max_no_rayleigh_wavenumber=10000.0,
                       debug_partition=False,
                       cost_options=None, band_parallel="auto",
                       mesh=None) -> GPoints:
    """Array-level find_g_points: search every gas, then overlap them
    (Hogan 2010) into merged g-points and their per-wavenumber map.

    With ``ssi``, the (nwav,) solar spectral irradiance in wavenumber
    order, the search is shortwave: costs of the direct beam (reflected
    below ``max_no_rayleigh_wavenumber``), SSI weights, the cloud
    pseudo-gas if ``cloud`` is given, and the solar irradiance of each
    merged g-point in the result.  The candidate costs run on ``device``,
    the card unless ``device="cpu"`` (raises without one).
    ``cost_options`` are keywords for every candidate-cost kernel
    (``fit_limits``, ``probe_log``, ``use_prefix``:
    :mod:`~ecckd_tpu_torch.partition.cost_kernel`).  ``band_parallel`` is
    "parallel" (or 1: each band's search on its own thread, all bands'
    probes in one dispatch of one gas-level kernel), "serial" (that
    kernel, one band after another), "off" (or 0: a kernel per band) or
    "auto" (the default: "parallel" on the card, "off" on the CPU); a
    gas of one band and ``debug_partition`` are always "off".  With
    ``mesh`` (:func:`ecckd_tpu_torch.parallel.make_mesh`) every kernel
    splits its band's wavenumbers over the mesh's spectral shards, the
    prefix path off (the JAX tool's ``sharded``)."""
    with logs.span("ecckd.find_g_points.core"):
        device = resolve_device(device)
        hr_tol = np.atleast_1d(np.asarray(heating_rate_tolerance, np.float64))
        sw = None
        if ssi is not None:
            sw = _Shortwave(np.asarray(ssi, np.float64),
                            float(max_no_rayleigh_wavenumber))
        single_gas_data = []
        band_bounds = None
        if cloud is not None:
            if sw is None:
                raise ValueError("Don't yet know how to sort cloud properties "
                                 "in the longwave")
            logs.log(f"*** FINDING G POINTS FOR {cloud.name}")
            single_gas_data.append(_cloud_pseudo_gas(cloud, sw.ssi))
            band_bounds = (cloud.wavenumber1_band, cloud.wavenumber2_band)
        for gas in gases:
            logs.log(f"*** FINDING G POINTS FOR {gas.name.upper()}")
            single_gas_data.append(_search_gas(
                gas, hr_tol, tolerance_tolerance, max_iterations,
                averaging_method, flux_weight, min_pressure, block_wav, device,
                dtype, sw, debug_partition, cost_options or {}, band_parallel,
                mesh))
            band_bounds = (gas.wavenumber1_band, gas.wavenumber2_band)
            logs.log("")
        logs.log("*** COMPUTING SPECTRAL OVERLAP OF GASES")
        with logs.span("ecckd.find_g_points.overlap"):
            with logs.span("ecckd.find_g_points.overlap.hypercube"):
                band_number = overlap_g_points(single_gas_data)
            ng = len(band_number)
            wavenumber = (np.asarray(gases[-1].wavenumber, np.float64) if gases
                          else np.zeros(0))
            with logs.span("ecckd.find_g_points.overlap.map"):
                g_point = merged_g_point_map(single_gas_data, ng,
                                             len(wavenumber), device)
            solar_irradiance = None
            if sw is not None:
                solar_irradiance = np.zeros(ng)
                for ig in range(ng):
                    solar_irradiance[ig] = sw.ssi[g_point == ig].sum()
                nbad = int(np.sum(solar_irradiance <= 0.0))
                if nbad:
                    logs.warning(f"{nbad} shortwave g points have zero solar "
                                 "irradiance")
        return GPoints(single_gas_data, band_number, g_point,
                       np.asarray(band_bounds[0], np.float64),
                       np.asarray(band_bounds[1], np.float64), wavenumber,
                       solar_irradiance)


def _read_gas(cfg: Config, gas_str: str, iprofile: int) -> GasInput:
    """One gas's order file and merged spectra, as the JAX tool reads
    them."""
    from ..io import read_order
    from ..io.spectrum import open_merged_spectrum_profile

    g_split = cfg.read_floats(f"{gas_str}.g_split", default=None)
    subband_wavenumber_boundary = cfg.read_floats(
        f"{gas_str}.subband_wavenumber_boundary", default=None)
    base_split = cfg.read_floats(f"{gas_str}.base_split", default=None)
    _check_splits(g_split, subband_wavenumber_boundary, base_split)
    reordering_input = cfg.read_string(f"{gas_str}.reordering_input")
    logs.log(f"Reading {reordering_input}")
    order = read_order(find_file(reordering_input))
    bg = None
    wavenumber = None
    if cfg.exist(f"{gas_str}.background_input"):
        logs.log("Generating background optical depth")
        with open_merged_spectrum_profile(
                cfg, iprofile, f"{gas_str}.background_") as bgpb:
            bg = bgpb.materialize().optical_depth
            wavenumber = bgpb.wavenumber
    logs.log("Generating target optical depth")
    with open_merged_spectrum_profile(cfg, iprofile, f"{gas_str}.") as pb:
        sp = pb.materialize()
    return GasInput(
        name=gas_str, rank=order.rank, band_number=order.band_number,
        wavenumber1_band=order.wavenumber1_band,
        wavenumber2_band=order.wavenumber2_band,
        sorting_variable=order.sorting_variable,
        pressure_hl=sp.pressure_hl, temperature_hl=sp.temperature_hl,
        wavenumber=sp.wavenumber if wavenumber is None else wavenumber,
        d_wavenumber=sp.d_wavenumber, optical_depth=sp.optical_depth,
        bg_optical_depth=bg,
        base_split=base_split,
        min_g_points=cfg.read_ints(f"{gas_str}.min_g_points", default=None),
        max_g_points=cfg.read_ints(f"{gas_str}.max_g_points", default=None),
        base_wavenumber_boundary=cfg.read_floats(
            f"{gas_str}.base_wavenumber_boundary", default=None) or (),
        min_scaling=cfg.read_float(f"{gas_str}.min_scaling", default=1.0),
        max_scaling=cfg.read_float(f"{gas_str}.max_scaling", default=1.0),
        g_split=g_split,
        subband_wavenumber_boundary=subband_wavenumber_boundary)


def _read_cloud(cfg: Config, cloud_str: str) -> CloudInput:
    """The cloud pseudo-gas's order file and reflectance range."""
    from ..io import read_order

    reordering_input = cfg.read_string(f"{cloud_str}.reordering_input")
    logs.log(f"Reading {reordering_input}")
    order = read_order(find_file(reordering_input))
    return CloudInput(
        name=cloud_str, rank=order.rank, band_number=order.band_number,
        wavenumber1_band=order.wavenumber1_band,
        wavenumber2_band=order.wavenumber2_band,
        sorting_variable=order.sorting_variable,
        max_reflectance_range=cfg.read_float(
            f"{cloud_str}.max_reflectance_range", default=0.26))


def write_g_points(output: str, result: GPoints, cfg: Config, argv):
    """The g-point NetCDF file with the JAX tool's schema
    (ref find_g_points.cpp:1485-1661)."""
    from ..io import NcWriter, write_standard_attributes

    gases = result.gases
    ng = len(result.band_number)
    nwav = len(result.g_point)
    w = NcWriter(output, format=netcdf_format(cfg))
    w.define_dimension("band", len(result.wavenumber1_band))
    if ng > 0:
        w.define_dimension("g_point", ng)
    for g in gases:
        w.define_dimension(f"{g.molecule}_g_point", g.ng())
    if nwav > 0:
        w.define_dimension("wavenumber", nwav)

    w.define_variable("n_gases", "int")
    w.write_long_name("Number of gases treated", "n_gases")
    w.write_comment('The gases are listed in the global attribute '
                    '"constituent_id".', "n_gases")
    w.define_variable("wavenumber1_band", "float", "band")
    w.write_long_name("Lower wavenumber bound of band", "wavenumber1_band")
    w.write_units("cm-1", "wavenumber1_band")
    w.define_variable("wavenumber2_band", "float", "band")
    w.write_long_name("Upper wavenumber bound of band", "wavenumber2_band")
    w.write_units("cm-1", "wavenumber2_band")
    w.define_variable("band_number", "short", "g_point")
    w.write_long_name("Band number of each g point", "band_number")
    sw = result.solar_irradiance is not None
    if sw:
        w.define_variable("solar_irradiance", "float", "g_point")
        w.write_long_name("Solar irradiance across each g point",
                          "solar_irradiance")
        w.write_units("W m-2", "solar_irradiance")

    for g in gases:
        m, M = g.molecule, g.Molecule
        dim = f"{m}_g_point"
        w.define_variable(f"{m}_n_g_points", "int", "band")
        w.write_long_name(f"Number of g points for {M}", f"{m}_n_g_points")
        w.define_variable(f"{m}_band_number", "short", dim)
        w.write_long_name(f"Band number of each {M} g point",
                          f"{m}_band_number")
        w.define_variable(f"{m}_rank1", "int", dim)
        w.write_long_name(f"Rank of first wavenumber for {M}", f"{m}_rank1")
        w.define_variable(f"{m}_rank2", "int", dim)
        w.write_long_name(f"Rank of last wavenumber for {M}", f"{m}_rank2")
        w.define_variable(f"{m}_error", "float", dim)
        w.write_long_name(f"Root-mean-square heating-rate error for {M}",
                          f"{m}_error")
        w.write_units("K d-1", f"{m}_error")
        w.define_variable(f"{m}_sorting_variable", "float", dim)
        w.write_long_name(f"Median in g-point of variable used to sort {M} "
                          "spectrum", f"{m}_sorting_variable")
        if ng > 0:
            w.define_variable(f"{m}_g_min", "int", "g_point")
            w.write_long_name(f"Minimum {M} g point contributing to merged "
                              "g points", f"{m}_g_min")
            w.define_variable(f"{m}_g_max", "int", "g_point")
            w.write_long_name(f"Maximum {M} g point contributing to merged "
                              "g points", f"{m}_g_max")

    if nwav > 0:
        w.define_variable("wavenumber", "double", "wavenumber")
        w.write_long_name("Wavenumber", "wavenumber")
        w.write_units("cm-1", "wavenumber")
        w.define_variable("g_point", "short", "wavenumber", deflate=2)
        w.write_long_name("G point", "g_point")
        for g in gases:
            w.define_variable(f"{g.molecule}_g_point", "short", "wavenumber",
                              deflate=2)
            w.write_long_name(f"{g.Molecule} g point", f"{g.molecule}_g_point")

    write_standard_attributes(
        w, "Definition of the spectral intervals of a "
        + ("shortwave" if sw else "longwave") + " CKD model")
    w.write_attribute(" ".join(g.molecule for g in gases), "constituent_id")
    w.append_history(argv or sys.argv)
    w.write_attribute(cfg.sprint(), "config")

    w.write(len(gases), "n_gases")
    w.write(result.wavenumber1_band, "wavenumber1_band")
    w.write(result.wavenumber2_band, "wavenumber2_band")
    w.write(result.band_number, "band_number")
    if sw:
        w.write(result.solar_irradiance, "solar_irradiance")
    for g in gases:
        m = g.molecule
        w.write(np.asarray(g.n_g_points, np.int32), f"{m}_n_g_points")
        w.write(np.asarray(g.band_number, np.int16), f"{m}_band_number")
        w.write(np.asarray(g.rank1, np.int32), f"{m}_rank1")
        w.write(np.asarray(g.rank2, np.int32), f"{m}_rank2")
        w.write(g.error, f"{m}_error")
        w.write(g.sorting_variable, f"{m}_sorting_variable")
        if ng > 0:
            w.write(np.asarray(g.g_min, np.int32), f"{m}_g_min")
            w.write(np.asarray(g.g_max, np.int32), f"{m}_g_max")
    if nwav > 0:
        w.write(result.wavenumber, "wavenumber")
        w.write(np.asarray(result.g_point, np.int16), "g_point")
        for g in gases:
            w.write(np.asarray(g.g_point, np.int16), f"{g.molecule}_g_point")
    w.close()


def find_g_points(cfg: Config, argv=()) -> str:
    """The file tool: read order files and spectra, search, write the
    g-point file."""
    device, dtype = setup(cfg)
    band_parallel = cfg.read_string("band_parallel", default="auto")
    mesh = sharded_mesh(cfg.read_string("sharded", default="auto"), device,
                        "find_g_points")
    ssi = None
    ssi_file_name = cfg.read_string("ssi", default=None)
    if ssi_file_name:
        from ..io import NcFile
        logs.log("Assuming shortwave spectral region (ssi provided)")
        with NcFile(find_file(ssi_file_name)) as f:
            ssi = np.asarray(f.read("solar_spectral_irradiance"), np.float64)
    else:
        logs.log("Assuming longwave spectral region (ssi not provided)")
    output = cfg.read_string("output")
    iprofile = cfg.read_int("iprofile", default=0)
    cloud_str = cfg.read_string("cloud", default=None)
    cloud = _read_cloud(cfg, cloud_str) if cloud_str else None
    gases = [_read_gas(cfg, g, iprofile)
             for g in read_string_list(cfg, "gases")]
    with maybe_profile(cfg):
        result = find_g_points_core(
            gases, cfg.read_floats("heating_rate_tolerance"),
            tolerance_tolerance=cfg.read_float("tolerance_tolerance",
                                               default=0.02),
            max_iterations=cfg.read_int("max_iterations", default=60),
            averaging_method=cfg.read_string("averaging_method",
                                             default="linear"),
            flux_weight=cfg.read_float("flux_weight", default=0.02),
            min_pressure=cfg.read_float("min_pressure", default=0.0),
            block_wav=cfg.read_int("streaming_block_wav", default=1 << 20),
            device=device, dtype=dtype, ssi=ssi, cloud=cloud,
            max_no_rayleigh_wavenumber=cfg.read_float(
                "max_no_rayleigh_wavenumber", default=10000.0),
            debug_partition=cfg.read_bool("debug_partition", default=False),
            band_parallel=band_parallel, mesh=mesh)
    logs.log(f"Writing {output}")
    write_g_points(output, result, cfg, argv)
    return output


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: find_g_points(tool_prologue(argv),
                              argv=["find_g_points"] + argv),
        name="find_g_points")


if __name__ == "__main__":
    sys.exit(main())
