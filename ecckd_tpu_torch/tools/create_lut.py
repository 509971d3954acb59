"""create_lut: build a raw CKD look-up table.

PyTorch counterpart of ``ecckd_tpu/tools/create_lut.py``
(ref create_look_up_table.cpp:27-606).  Line-by-line optical depths of each
gas are averaged into each g-point over a set of temperature profiles (and
concentrations, for a LUT gas), giving a ckd-definition file with min/max
absorption bounds and the gpoint_fraction spectral mapping; a longwave
model carries a Planck LUT, a shortwave one (``ssi`` given, SSI weights)
the solar irradiance per g-point and per interval and its Rayleigh
coefficients.  A profile whose od and weights would exceed
``streaming_memory_mb`` is averaged in wavenumber blocks streamed from its
file (ref create_look_up_table.cpp:242-298 streams one profile at a time
for the same reason); ``streaming=1`` or ``0`` forces the choice.  With a
mesh (``sharded``; :mod:`ecckd_tpu_torch.parallel`) each profile, or each
streamed block, is split over the mesh's spectral shards and its g-point
partials combined over them; the two compose.

:func:`create_lut_core` works on arrays; :func:`create_lut` is the file
tool around it (``python -m ecckd_tpu_torch.tools.create_lut key=value ...
[device=cuda|cpu] [profile_dir=DIR]``; ``profile_dir``: a ``torch.profiler``
trace of the core with the port's spans of every thread,
:class:`~.common.maybe_profile`).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import logs
from ..config import Config
from ..models import CkdModel, ConcDependence, GasData
from ..io.spectrum import spectrum_blocks
from ..ops.average import od_to_molar_abs
from ..ops.planck import planck_function
from ..ops.segments import gpoint_onehot
from ..ops.streaming import (average_od_to_gpoints,
                             streaming_average_od_to_gpoints)
from ..parallel.sharded_average import (
    sharded_average_od_to_gpoints, streaming_sharded_average_od_to_gpoints)
from .common import (device_tensor, find_file, maybe_profile,
                     netcdf_format, read_string_list, resolve_device, setup,
                     sharded_mesh, tool_prologue)

_CONC_DEPENDENCE = {
    "none": ConcDependence.NONE,
    "linear": ConcDependence.LINEAR,
    "lut": ConcDependence.LUT,
    "relative-linear": ConcDependence.RELATIVE_LINEAR,
}


@dataclasses.dataclass
class LutGas:
    """One gas of the LUT.

    ``tables`` holds one profile source per concentration of a LUT gas, or
    a single one: ``open_profile(iprof) -> (spectrum, reference_vmr)``,
    where ``spectrum`` has ``pressure_hl``, ``temperature_hl``,
    ``wavenumber``, ``d_wavenumber``, ``ncol`` (the number of temperature
    profiles) and either ``optical_depth`` (nlay, nwav) or, as an
    io.spectrum.ProfileBlocks has, ``iter_blocks`` and ``materialize``;
    a spectrum with ``close`` is closed once it has been averaged."""
    name: str
    conc_dependence: ConcDependence
    tables: List[Callable]
    vmr: Optional[np.ndarray] = None
    reference_vmr: Optional[float] = None
    composite_molecules: str = ""
    composite_vmr: Optional[np.ndarray] = None


class _Execution:
    """Per-run choice of the averaging's execution path
    (``ecckd_tpu/tools/create_lut.py:_Execution``).

    ``streaming``: "auto" streams wavenumber blocks from the profile's
    source when one profile's od and weight in float64 exceed
    ``memory_mb`` (CKDMIP spectra are ~5.6M wavenumbers, so the whole
    array need not be resident); "1"/"yes"/"true" always, "0"/"no"/"false"
    never.  ``block_wav`` is the block of the reduction on either path.
    ``mesh``: the spectral mesh each profile or block is split over, or
    None (the tool's ``sharded`` key, :func:`.common.sharded_mesh`)."""

    def __init__(self, streaming="auto", block_wav=1 << 20,
                 memory_mb=1024.0, mesh=None):
        self.streaming = str(streaming).lower()
        self.block_wav = int(block_wav)
        self.memory_mb = float(memory_mb)
        self.mesh = mesh

    @classmethod
    def from_config(cls, cfg: Config, device=None) -> "_Execution":
        """The keys of a run on ``device``, its mesh resolved there (none
        without a device)."""
        mesh = None if device is None else sharded_mesh(
            cfg.read_string("sharded", default="auto"), device, "create_lut")
        return cls(cfg.read_string("streaming", default="auto"),
                   cfg.read_int("streaming_block_wav", default=1 << 20),
                   cfg.read_float("streaming_memory_mb", default=1024.0),
                   mesh)

    def use_streaming(self, nlay: int, nwav: int) -> bool:
        if self.streaming in ("1", "yes", "true"):
            return True
        if self.streaming in ("0", "no", "false"):
            return False
        return 2.0 * 8.0 * nlay * nwav > self.memory_mb * 1.0e6


@dataclasses.dataclass
class SolarSpectrum:
    """The solar spectral irradiance file of a SW model: ``ssi`` (W m-2
    per spectral point) on ``wavenumber`` (cm-1), the spectrum's grid, and
    the total solar irradiance."""
    ssi: np.ndarray
    total_solar_irradiance: float
    wavenumber: np.ndarray


def _average_profile(ng, g_point, source, weight_fn, averaging_method,
                     pressure_fl, pressure_hl, reference_surface_vmr,
                     execution, device, dtype, first):
    """One temperature profile -> (molar_abs, min, max), each (nlay, ng)
    numpy: streamed in wavenumber blocks from ``source`` where
    ``execution`` says so (ref create_look_up_table.cpp:242-298), else
    from its whole od in memory, each split over ``execution.mesh`` where
    there is one (``ecckd_tpu/tools/create_lut.py:88-112``).
    ``weight_fn(i0, nb)`` gives the Planck or SSI weights of wavenumbers i0
    to i0 + nb on the device."""
    with logs.span("ecckd.create_lut.profile"):
        nlay, nwav = len(pressure_hl) - 1, len(source.wavenumber)
        mesh = execution.mesh
        if execution.use_streaming(nlay, nwav):
            if first:
                logs.log(f"  Streaming {nwav} wavenumbers in blocks of "
                         f"{execution.block_wav}")
            blocks = (source if hasattr(source, "iter_blocks")
                      else spectrum_blocks(source))
            if mesh is not None:
                fit, mn, mx = streaming_sharded_average_od_to_gpoints(
                    mesh, blocks, ng, g_point, weight_fn, averaging_method,
                    block_wav=execution.block_wav, pressure_fl=pressure_fl,
                    dtype=dtype)
            else:
                fit, mn, mx = streaming_average_od_to_gpoints(
                    blocks, ng, g_point, weight_fn, averaging_method,
                    block_wav=execution.block_wav, pressure_fl=pressure_fl,
                    device=device, dtype=dtype)
        else:
            od = (source.optical_depth if hasattr(source, "optical_depth")
                  else source.materialize().optical_depth)
            if mesh is not None:
                if torch.is_tensor(pressure_fl):
                    pressure_fl = pressure_fl.cpu().numpy()
                fit, mn, mx = sharded_average_od_to_gpoints(
                    mesh, ng, g_point, np.asarray(od), weight_fn(0, nwav),
                    averaging_method, pressure_fl=pressure_fl, dtype=dtype)
            else:
                fit, mn, mx = average_od_to_gpoints(
                    ng, g_point, device_tensor(od, device, dtype),
                    weight_fn(0, nwav), averaging_method,
                    pressure_fl=pressure_fl, block_wav=execution.block_wav)
        return tuple(od_to_molar_abs(a, pressure_hl, reference_surface_vmr)
                     for a in (fit, mn, mx))


def _gpoint_fraction(ng, g_point, wavenumber, d_wavenumber, wavenumber1,
                     wavenumber2):
    """Fraction of each g-point's spectrum in fixed wavenumber intervals
    (ref create_look_up_table.cpp:516-548), via a 2-D histogram."""
    nint = len(wavenumber1)
    dwav = (wavenumber1[1] - wavenumber1[0] if nint > 1
            else wavenumber2[0] - wavenumber1[0])
    # Interval such that wavenumber1 < wn <= wavenumber2
    ibin = np.ceil((wavenumber - wavenumber1[0]) / dwav).astype(np.int64) - 1
    ibin = np.clip(ibin, -1, nint - 1)
    valid = (g_point >= 0) & (ibin >= 0)
    frac = np.zeros((ng, nint))
    np.add.at(frac, (g_point[valid], ibin[valid]), d_wavenumber[valid])
    per_g = np.zeros(ng)
    np.add.at(per_g, g_point[valid], d_wavenumber[valid])
    per_g[per_g == 0.0] = 1.0
    return frac / per_g[:, None]


def _remap_g_points(g_point, band_number, band_wn1, band_wn2,
                    base_wavenumber_boundary, wavenumber_hr,
                    solar_irradiance=None, ssi=None):
    """Remove empty g-points (ref :111-160) and split the base g-point of a
    band by wavenumber (ref :162-224), carrying the SW ``solar_irradiance``
    per g-point along (a split g-point's is summed anew from ``ssi``).
    Returns (g_point, band_number, solar_irradiance, changed)."""
    ng = int(g_point.max()) + 1
    counts = np.bincount(g_point[g_point >= 0], minlength=ng)
    bad = np.nonzero(counts == 0)[0]
    changed = False
    if len(bad) > 0:
        logs.log(f"Removing {len(bad)} g point(s) that occupy none of the "
                 "spectrum")
        keep = np.nonzero(counts > 0)[0]
        remap = np.full(ng, -1, np.int64)
        remap[keep] = np.arange(len(keep))
        g_point = np.where(g_point >= 0, remap[g_point], -1)
        band_number = band_number[keep]
        if solar_irradiance is not None:
            solar_irradiance = solar_irradiance[keep]
        ng = len(keep)
        changed = True
    for iband in range(len(band_wn1)):
        in_band = ((base_wavenumber_boundary > band_wn1[iband])
                   & (base_wavenumber_boundary < band_wn2[iband]))
        nsplit = int(np.sum(in_band))
        if nsplit == 0:
            continue
        logs.log(f"Splitting base g-point of band {iband} into {nsplit + 1}")
        ig = int(np.nonzero(band_number == iband)[0].min())
        new_band_number = np.empty(ng + nsplit, np.int64)
        new_band_number[:ig + 1] = band_number[:ig + 1]
        new_band_number[ig + 1:ig + nsplit + 1] = iband
        new_band_number[ig + nsplit + 1:] = band_number[ig + 1:]
        new_g_point = np.where(g_point > ig, g_point + nsplit, g_point)
        new_bounds = np.concatenate([[band_wn1[iband]],
                                     base_wavenumber_boundary[in_band],
                                     [band_wn2[iband]]])
        for k in range(nsplit + 1):
            sel = ((g_point == ig) & (wavenumber_hr >= new_bounds[k])
                   & (wavenumber_hr < new_bounds[k + 1]))
            new_g_point[sel] = ig + k
        if solar_irradiance is not None:
            new_si = np.empty(ng + nsplit)
            new_si[:ig] = solar_irradiance[:ig]
            new_si[ig + nsplit + 1:] = solar_irradiance[ig + 1:]
            for k in range(nsplit + 1):
                new_si[ig + k] = ssi[new_g_point == ig + k].sum()
            solar_irradiance = new_si
        band_number, g_point = new_band_number, new_g_point
        ng += nsplit
        changed = True
    return g_point, band_number, solar_irradiance, changed


def _gas_tables(gas: LutGas, ng, g_point, averaging_method,
                temperature_stride, pressure_fl, device, dtype, execution,
                ssi=None):
    """Loop a gas's tables and temperature profiles, averaging each profile
    to g-points (ref create_look_up_table.cpp:242-340) with Planck weights,
    or with the solar irradiance ``ssi`` in the shortwave, each streamed or
    in memory as ``execution`` decides.  ``pressure_fl`` is that of the
    first profile of the first gas (None before it is read).  Returns (k,
    kmin, kmax per table, temperature_fl, pressure_fl, last spectrum)."""
    gp = torch.as_tensor(g_point, device=device)
    ssi_t = None if ssi is None else device_tensor(ssi, device, dtype)
    k_c, kmin_c, kmax_c = [], [], []
    t_fl = sp = None
    for open_profile in gas.tables:
        k_l, kmin_l, kmax_l, t_l = [], [], [], []
        ncol = 1
        icol = 0
        while icol < ncol:
            sp, ref_vmr = open_profile(icol * temperature_stride)
            try:
                ncol = ((sp.ncol + temperature_stride - 1)
                        // temperature_stride)
                p_hl = np.asarray(sp.pressure_hl, np.float64)
                if pressure_fl is None:
                    pressure_fl = 0.5 * (p_hl[:-1] + p_hl[1:])
                t_x_p = np.asarray(sp.temperature_hl) * p_hl
                t_fl_col = 0.5 * (t_x_p[:-1] + t_x_p[1:]) / pressure_fl
                t_l.append(t_fl_col)
                if ssi_t is None:
                    t_t, wav_t, dwav_t = (
                        device_tensor(a, device, dtype)
                        for a in (t_fl_col, sp.wavenumber, sp.d_wavenumber))

                    def weight_fn(i0, nb):
                        return planck_function(t_t, wav_t[i0:i0 + nb],
                                               dwav_t[i0:i0 + nb])
                else:
                    def weight_fn(i0, nb):
                        return ssi_t[i0:i0 + nb]
                k, kmin, kmax = _average_profile(
                    ng, gp, sp, weight_fn, averaging_method, pressure_fl,
                    p_hl, ref_vmr, execution, device, dtype, icol == 0)
            finally:
                if hasattr(sp, "close"):
                    sp.close()
            k_l.append(k)
            kmin_l.append(kmin)
            kmax_l.append(kmax)
            icol += 1
        k_c.append(np.stack(k_l))
        kmin_c.append(np.stack(kmin_l))
        kmax_c.append(np.stack(kmax_l))
        t_fl = np.stack(t_l)
    return k_c, kmin_c, kmax_c, t_fl, pressure_fl, sp


def create_lut_core(g_point, band_wn1, band_wn2, band_number,
                    gases: Sequence[LutGas],
                    averaging_method="transmission", temperature_stride=1,
                    base_wavenumber_boundary=(), wavenumber_hr=None,
                    device="cuda", dtype=torch.float64, history="",
                    config="", solar: Optional[SolarSpectrum] = None,
                    solar_irradiance=None, streaming="auto",
                    streaming_block_wav=1 << 20,
                    streaming_memory_mb=1024.0, mesh=None) -> CkdModel:
    """Array-level create_lut: the CkdModel of the given g-points.

    ``g_point`` is the merged per-wavenumber map of find_g_points and
    ``band_number`` the band of each merged g-point; ``wavenumber_hr``
    (the g-point file's wavenumbers) is needed only for a base split.
    With ``solar`` the averages are SSI-weighted on a 50 cm-1 interval
    grid; with ``solar_irradiance`` too (per g-point, from a SW g-point
    file) the model is shortwave.  The averages run on ``device``, the
    card unless ``device="cpu"`` (raises without one).  ``streaming``
    ("auto", or "1"/"0" to force it) chooses per profile between the
    block-wise average of a source streamed from disk and the average of
    its whole od in memory, by whether its od and weight in float64 would
    exceed ``streaming_memory_mb``; both reduce blocks of
    ``streaming_block_wav`` wavenumbers, and so give the same bits.  With
    ``mesh`` (:func:`ecckd_tpu_torch.parallel.make_mesh`) each profile in
    memory, or each streamed block, is split over the mesh's spectral
    shards (the JAX tool's ``sharded``): the same min and max, the sums in
    another order."""
    with logs.span("ecckd.create_lut.core"):
        device = resolve_device(device)
        g_point = np.asarray(g_point, np.int64)
        band_wn1 = np.asarray(band_wn1, np.float64)
        band_wn2 = np.asarray(band_wn2, np.float64)
        base_wavenumber_boundary = np.asarray(base_wavenumber_boundary,
                                              np.float64)
        if len(base_wavenumber_boundary) and wavenumber_hr is None \
                and solar is not None:
            wavenumber_hr = solar.wavenumber
        if solar_irradiance is not None:
            if solar is None:
                raise ValueError("a shortwave g-point file needs the solar "
                                 "spectrum (ssi)")
            solar_irradiance = np.asarray(solar_irradiance, np.float64)
        ssi = None if solar is None else np.asarray(solar.ssi, np.float64)
        g_point, band_number, solar_irradiance, changed_g = _remap_g_points(
            g_point, np.asarray(band_number, np.int64), band_wn1, band_wn2,
            base_wavenumber_boundary, wavenumber_hr, solar_irradiance, ssi)
        ng = len(band_number)
        execution = _Execution(streaming, streaming_block_wav,
                               streaming_memory_mb, mesh)

        single_gas_data = []
        temperature_fl = pressure_fl = sp = None
        for gas in gases:
            logs.log(f"Creating look-up table for {gas.name.upper()}")
            logs.log(f"  Averaging method = {averaging_method}")
            k_c, kmin_c, kmax_c, temperature_fl, pressure_fl, sp = _gas_tables(
                gas, ng, g_point, averaging_method, temperature_stride,
                pressure_fl, device, dtype, execution, ssi)
            g = GasData(gas.name, gas.conc_dependence)
            if gas.conc_dependence == ConcDependence.LUT:
                g.molar_abs = np.stack(k_c)
                g.min_molar_abs = np.stack(kmin_c)
                g.max_molar_abs = np.stack(kmax_c)
                g.vmr = np.asarray(gas.vmr)
            else:
                g.molar_abs, g.min_molar_abs, g.max_molar_abs = (
                    k_c[0], kmin_c[0], kmax_c[0])
                g.reference_vmr = gas.reference_vmr
                g.composite_molecules = gas.composite_molecules
                g.composite_vmr = gas.composite_vmr
            single_gas_data.append(g)

        # ---- gpoint_fraction on the fixed interval grid (ref :507-548) ----
        with logs.span("ecckd.create_lut.finish"):
            logs.log("Computing fraction of spectrum contributing to each "
                     "g-point")
            dwav = 10 if solar is None else 50
            startwav = int(np.floor(band_wn1.min() / dwav) * dwav)
            endwav = int(np.ceil(band_wn2.max() / dwav) * dwav)
            wavenumber1 = dwav * np.arange(startwav // dwav, endwav // dwav,
                                           dtype=np.float64)
            wavenumber2 = wavenumber1 + dwav
            wavenumber_cm_1 = np.asarray(sp.wavenumber, np.float64)
            d_wavenumber_cm_1 = np.asarray(sp.d_wavenumber, np.float64)
            gpoint_fraction = _gpoint_fraction(ng, g_point, wavenumber_cm_1,
                                               d_wavenumber_cm_1, wavenumber1,
                                               wavenumber2)
            common = dict(history=history, config=config)

            if solar_irradiance is not None:
                # Solar irradiance per fixed interval (ref :555-561)
                nint = len(wavenumber1)
                ibin = np.ceil((np.asarray(solar.wavenumber) - wavenumber1[0])
                               / dwav).astype(np.int64) - 1
                valid = (ibin >= 0) & (ibin < nint)
                ssi_intervals = np.zeros(nint)
                np.add.at(ssi_intervals, ibin[valid], ssi[valid])
                model = CkdModel(
                    single_gas_data, pressure_fl, temperature_fl, wavenumber1,
                    wavenumber2, gpoint_fraction, band_wn1, band_wn2,
                    band_number, solar_irradiance=solar_irradiance,
                    ssi=ssi_intervals, reference_total_solar_irradiance=float(
                        solar.total_solar_irradiance), **common)
            else:
                # Planck LUT: per-temperature sums over each g-point's
                # spectrum, a one-hot matmul (deterministic, unlike an atomic
                # scatter-add)
                logs.log("Generating Planck-function look-up table")
                temperature_lut = np.arange(120.0, 351.0)
                wav_t = device_tensor(wavenumber_cm_1, device, dtype)
                dwav_t = device_tensor(d_wavenumber_cm_1, device, dtype)
                onehot = gpoint_onehot(
                    torch.as_tensor(g_point, device=device), ng, dtype)
                chunk = max(1, min(16, int(256.0e6
                                           / (8 * len(wavenumber_cm_1)))))
                planck_lut = np.concatenate([
                    (planck_function(
                        device_tensor(temperature_lut[i0:i0 + chunk], device,
                                      dtype),
                        wav_t, dwav_t) @ onehot).cpu().numpy()
                    for i0 in range(0, len(temperature_lut), chunk)])
                model = CkdModel(
                    single_gas_data, pressure_fl, temperature_fl, wavenumber1,
                    wavenumber2, gpoint_fraction, band_wn1, band_wn2,
                    band_number, temperature_planck=temperature_lut,
                    planck_function=planck_lut, **common)
            if changed_g:
                model.wavenumber_hr = wavenumber_cm_1
                model.g_point = np.asarray(g_point, np.int32)
        return model


def _file_gas(cfg: Config, gas_str: str) -> LutGas:
    """A gas's table sources from its config keys and spectrum files."""
    from ..io.spectrum import (open_merged_spectrum_profile,
                                       open_spectrum_profile)

    cd_str = cfg.read_string(f"{gas_str}.conc_dependence", default=None)
    if cd_str is None:
        raise ValueError(f"{gas_str}.conc_dependence not found in "
                         "configuration")
    if cd_str not in _CONC_DEPENDENCE:
        raise ValueError(f'conc_dependence "{cd_str}" not understood')
    cd = _CONC_DEPENDENCE[cd_str]

    def from_file(file_name, check_vmr=False):
        def open_profile(iprof):
            pb = open_spectrum_profile(file_name, iprof)
            if check_vmr and pb.reference_surface_vmr < 0.0:
                pb.close()
                raise ValueError(
                    "Invalid reference_surface_vmr for constructing "
                    "VMR-dependent look-up table")
            return pb, pb.reference_surface_vmr
        return open_profile

    if cd == ConcDependence.NONE:
        def open_merged(iprof):
            return open_merged_spectrum_profile(cfg, iprof,
                                                f"{gas_str}."), 1.0
        with open_merged_spectrum_profile(cfg, 0, f"{gas_str}.") as pb0:
            return LutGas(gas_str, cd, [open_merged],
                          composite_molecules=pb0.molecule,
                          composite_vmr=pb0.vmr_fl)
    if cd in (ConcDependence.LINEAR, ConcDependence.RELATIVE_LINEAR):
        ref_conc = None
        if cd == ConcDependence.RELATIVE_LINEAR:
            ref_conc = cfg.read_float(f"{gas_str}.reference_conc",
                                      default=None)
            if ref_conc is None:
                raise ValueError(f"{gas_str}.reference_conc must be provided "
                                 "if conc_dependence is relative-linear")
        file_name = find_file(cfg.read_string(f"{gas_str}.input"))
        return LutGas(gas_str, cd, [from_file(file_name)],
                      reference_vmr=ref_conc)
    files = [find_file(f) for f in read_string_list(cfg, f"{gas_str}.input")]
    vmrs = []
    for file_name in files:
        with open_spectrum_profile(file_name, 0) as pb0:
            vmrs.append(pb0.reference_surface_vmr)
    return LutGas(gas_str, cd, [from_file(f, check_vmr=True) for f in files],
                  vmr=np.asarray(vmrs))


def create_lut(cfg: Config, argv=()) -> str:
    """The file tool: read the g-point file and spectra, write the
    ckd-definition file."""
    from ..io import NcFile

    device, dtype = setup(cfg)
    execution = _Execution.from_config(cfg, device)
    output = cfg.read_string("output")
    input_file = find_file(cfg.read_string("input"))
    solar = None
    ssi_file_name = cfg.read_string("ssi", default=None)
    if ssi_file_name:
        with NcFile(find_file(ssi_file_name)) as f:
            solar = SolarSpectrum(
                np.asarray(f.read("solar_spectral_irradiance"), np.float64),
                float(f.read_scalar("total_solar_irradiance")),
                np.asarray(f.read("wavenumber"), np.float64))
    logs.log(f"Reading {input_file}")
    with NcFile(input_file) as gf:
        if not gf.exist("g_point"):
            raise ValueError(f'"g_point" not found in "{input_file}"')
        g_point = np.asarray(gf.read("g_point"), np.int64)
        band_wn1 = np.asarray(gf.read("wavenumber1_band"), np.float64)
        band_wn2 = np.asarray(gf.read("wavenumber2_band"), np.float64)
        band_number = np.asarray(gf.read("band_number"), np.int64)
        solar_irradiance = (np.asarray(gf.read("solar_irradiance"),
                                       np.float64)
                            if gf.exist("solar_irradiance") else None)
        history = gf.attribute("history", default="") or ""
        config = gf.attribute("config", default="") or ""
        wavenumber_hr = (np.asarray(gf.read("wavenumber"), np.float64)
                         if gf.exist("wavenumber") else None)
    gases = [_file_gas(cfg, g) for g in read_string_list(cfg, "gases")]
    with maybe_profile(cfg):
        model = create_lut_core(
            g_point, band_wn1, band_wn2, band_number, gases,
            averaging_method=cfg.read_string("averaging_method",
                                             default="transmission"),
            temperature_stride=cfg.read_int("temperature_stride", default=1),
            base_wavenumber_boundary=cfg.read_floats(
                "base_wavenumber_boundary", default=None) or (),
            wavenumber_hr=wavenumber_hr, device=device, dtype=dtype,
            history=history, config=config, solar=solar,
            solar_irradiance=solar_irradiance, streaming=execution.streaming,
            streaming_block_wav=execution.block_wav,
            streaming_memory_mb=execution.memory_mb, mesh=execution.mesh)
    logs.log(f"Writing {output}")
    model.write(output, argv=list(argv) or ["create_lut"] + sys.argv[1:],
                config_str=cfg.sprint(), format=netcdf_format(cfg))
    return output


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: create_lut(tool_prologue(argv), argv=["create_lut"] + argv),
        name="create_lut")


if __name__ == "__main__":
    sys.exit(main())
