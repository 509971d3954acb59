"""lw_spectra: line-by-line longwave fluxes of merged spectra.

PyTorch counterpart of ``ecckd_tpu/tools/lw_spectra.py``
(ref src/ecckd/lw_spectra.cpp:25-272): for every profile of a
merged-spectra config, the Planck function and the spectral longwave
radiative transfer, written at full spectral resolution or collapsed to
g-points; the column dimension is unlimited for concatenation.  These are
the training fluxes optimize_lut fits a model to.

:func:`lw_spectra_core` works on one profile's block source (an
io.spectrum.ProfileBlocks: a NetCDF file, a ``.spbin`` shard, or arrays
through ``spectrum_blocks``); :func:`lw_spectra` is the file tool around it
(``python -m ecckd_tpu_torch.tools.lw_spectra key=value ...
[device=cuda|cpu]``).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from .. import logs
from ..config import Config
from ..ops.planck import planck_function
from ..ops.rt_lw import rt_lw
from ..ops.average import (combine_partials, finalize_gpoint_partials,
                           gpoint_block_partials)
from ..ops.streaming import block_results, read_ahead
from .common import (device_tensor, find_file, netcdf_format,
                     resolve_device, setup, tool_prologue)


@dataclasses.dataclass
class LwSpectra:
    """One profile's fluxes (W m-2): broadband ``flux_dn``/``flux_up``
    (nlay+1,); ``spectral_flux_dn``/``_up`` and ``optical_depth`` per
    wavenumber (nlay+1 or nlay, nwav) or, with g-points, summed over each
    g-point's wavenumbers and transmission-averaged (.., ng)."""
    flux_dn: np.ndarray
    flux_up: np.ndarray
    spectral_flux_dn: np.ndarray
    spectral_flux_up: np.ndarray
    optical_depth: np.ndarray


def lw_spectra_core(source, g_point=None, ng=None, block_wav=1 << 20,
                    device="cuda", dtype=torch.float64) -> LwSpectra:
    """One profile's LBL longwave fluxes, computed on ``device`` (the card
    unless ``device="cpu"``; raises without one) in wavenumber blocks on
    create_lut's block loop (:mod:`ecckd_tpu_torch.ops.streaming`).  The
    radiative transfer is independent per wavenumber, so blocks give the
    whole spectrum's fluxes; the broadband fluxes are the blocks' sums
    added in order.

    ``source`` has ``pressure_hl``, ``temperature_hl``, ``wavenumber``,
    ``d_wavenumber`` and ``iter_blocks``.  Without ``g_point`` the spectral
    fluxes and od come back per wavenumber; with it (and ``ng``, by default
    its largest value + 1) they are collapsed to g-points, the od by the
    Planck-weighted transmission average of create_lut, so that no full
    spectral array is ever held."""
    device = resolve_device(device)
    p_hl = np.asarray(source.pressure_hl, np.float64)
    t_hl_np = np.asarray(source.temperature_hl, np.float64)
    t_hl = device_tensor(t_hl_np, device, dtype)
    wav = device_tensor(source.wavenumber, device, dtype)
    dwav = device_tensor(source.d_wavenumber, device, dtype)
    nlay, nwav = len(p_hl) - 1, wav.shape[0]
    blocks = source.iter_blocks(block_wav=block_wav)
    if g_point is not None:
        gp = torch.as_tensor(np.asarray(g_point), device=device)
        ng = int(gp.max()) + 1 if ng is None else ng
        g_range = torch.arange(ng, device=device)
        pressure_fl = 0.5 * (p_hl[:-1] + p_hl[1:])
        t_x_p = t_hl_np * p_hl
        t_fl = device_tensor(0.5 * (t_x_p[:-1] + t_x_p[1:]) / pressure_fl,
                             device, dtype)
    else:
        spectral = [np.empty((nlay + 1, nwav)) for _ in range(2)]
        od_all = np.empty((nlay, nwav))
        blocks = _kept(blocks, od_all)

    def reduce(i0, od):
        sl = slice(i0, i0 + od.shape[1])
        planck = planck_function(t_hl, wav[sl], dwav[sl])
        fd, fu = rt_lw(planck, od, torch.ones_like(planck[0]), planck[-1])
        out = {"flux_dn": fd.sum(1), "flux_up": fu.sum(1)}
        if g_point is None:
            out["fd"], out["fu"] = fd, fu
            return out
        onehot = (gp[sl, None] == g_range[None, :]).to(dtype)
        out["fd_g"], out["fu_g"] = fd @ onehot, fu @ onehot
        out.update(gpoint_block_partials(
            ng, gp[sl], od, planck_function(t_fl, wav[sl], dwav[sl]),
            "transmission"))
        return out

    acc = None
    for i0, part in block_results(read_ahead(blocks, device), reduce,
                                  device, dtype):
        if g_point is None:
            for host, key in zip(spectral, ("fd", "fu")):
                flux = part.pop(key)
                host[:, i0:i0 + flux.shape[1]] = flux
        acc = part if acc is None else combine_partials(acc, part)
    if g_point is None:
        return LwSpectra(acc["flux_dn"], acc["flux_up"], *spectral, od_all)
    od_g = finalize_gpoint_partials(acc, "transmission")[0]
    return LwSpectra(acc["flux_dn"], acc["flux_up"], acc["fd_g"],
                     acc["fu_g"], od_g)


def _kept(blocks, od_all):
    """``blocks``, each host block (numpy or a CPU tensor) also copied
    into ``od_all`` where it lies, on the thread that reads them."""
    for i0, od_blk in blocks:
        od_all[:, i0:i0 + od_blk.shape[1]] = np.asarray(od_blk)
        yield i0, od_blk


def _define_schema(w, cfg, argv, src, ng):
    """The JAX tool's variables and attributes (lw_spectra.py:96-164)."""
    nlay = src.nlay
    w.define_dimension("column", None)    # unlimited for ncrcat
    w.define_dimension("level", nlay)
    w.define_dimension("half_level", nlay + 1)
    if ng is None:
        spec_name = "wavenumber"
        w.define_dimension(spec_name, src.nwav)
    else:
        spec_name = "g_point"
        w.define_dimension(spec_name, ng)
    w.define_dimension("gas", src.vmr_fl.shape[0])

    w.define_variable("pressure_hl", "float", "column", "half_level")
    w.write_long_name("Pressure at half levels", "pressure_hl")
    w.write_units("Pa", "pressure_hl")
    w.define_variable("temperature_hl", "float", "column", "half_level")
    w.write_long_name("Temperature at half levels", "temperature_hl")
    w.write_units("K", "temperature_hl")
    if ng is None:
        w.define_variable("wavenumber", "double", "wavenumber", deflate=2)
        w.write_long_name("Wavenumber", "wavenumber")
        w.write_units("cm-1", "wavenumber")
    w.define_variable("vmr_fl", "float", "column", "gas", "level")
    w.write_long_name("Volume mixing ratio", "vmr_fl")
    w.write_units("mol mol-1", "vmr_fl")
    w.define_variable("flux_dn_lw", "float", "column", "half_level")
    w.write_long_name("Downwelling longwave flux", "flux_dn_lw")
    w.write_units("W m-2", "flux_dn_lw")
    w.define_variable("flux_up_lw", "float", "column", "half_level")
    w.write_long_name("Upwelling longwave flux", "flux_up_lw")
    w.write_units("W m-2", "flux_up_lw")
    w.define_variable("optical_depth", "float", "column", "level",
                      spec_name)
    w.write_long_name("Layer optical depth", "optical_depth")
    w.define_variable("spectral_flux_dn_lw", "float", "column",
                      "half_level", spec_name)
    w.write_long_name("Downwelling longwave spectral flux",
                      "spectral_flux_dn_lw")
    w.write_units("W m-2", "spectral_flux_dn_lw")
    w.define_variable("spectral_flux_up_lw", "float", "column",
                      "half_level", spec_name)
    w.write_long_name("Upwelling longwave spectral flux",
                      "spectral_flux_up_lw")
    w.write_units("W m-2", "spectral_flux_up_lw")
    w.append_history(argv or sys.argv)
    w.write_attribute(src.molecule.replace(",", " "), "molecules")
    w.write_attribute(cfg.sprint(), "config")
    if ng is None:
        w.write(src.wavenumber, "wavenumber")


def lw_spectra(cfg: Config, argv=()) -> str:
    """The file tool: every profile of the merged spectra of ``input``
    (or only ``iprofile``), at full resolution or collapsed to the
    g-points of ``gpoints``, into ``output``."""
    from ..io import NcFile, NcWriter
    from ..io.spectrum import open_merged_spectrum_profile

    device, dtype = setup(cfg)
    output = cfg.read_string("output")
    g_point = ng = None
    gpoint_file = cfg.read_string("gpoints", default=None)
    if gpoint_file:
        with NcFile(find_file(gpoint_file)) as f:
            g_point = np.asarray(f.read("g_point"), np.int64)
        ng = int(g_point.max()) + 1
    iprofile = cfg.read_int("iprofile", default=None)
    block_wav = cfg.read_int("streaming_block_wav", default=1 << 20)

    ncol = 10000
    icol = 0 if iprofile is None else iprofile
    iout = 0
    with NcWriter(output, format=netcdf_format(cfg)) as w:
        while icol < ncol:
            logs.log(f"Profile {icol}")
            with open_merged_spectrum_profile(cfg, icol, "") as src:
                ncol = src.ncol
                if iout == 0:
                    _define_schema(w, cfg, argv, src, ng)
                w.write(src.pressure_hl, "pressure_hl", index=iout)
                w.write(src.temperature_hl, "temperature_hl", index=iout)
                w.write(src.vmr_fl, "vmr_fl", index=iout)
                logs.log("  Planck + longwave RT in wavenumber blocks")
                out = lw_spectra_core(src, g_point, ng, block_wav,
                                      device=device, dtype=dtype)
            w.write(out.flux_dn, "flux_dn_lw", index=iout)
            w.write(out.flux_up, "flux_up_lw", index=iout)
            w.write(out.optical_depth, "optical_depth", index=iout)
            w.write(out.spectral_flux_dn, "spectral_flux_dn_lw", index=iout)
            w.write(out.spectral_flux_up, "spectral_flux_up_lw", index=iout)
            if iprofile is not None:
                break
            icol += 1
            iout += 1
    return output


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: lw_spectra(tool_prologue(argv), argv=["lw_spectra"] + argv),
        name="lw_spectra")


if __name__ == "__main__":
    sys.exit(main())
