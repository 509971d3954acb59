"""run_ckd: evaluate a CKD model on scenario concentrations.

PyTorch counterpart of ``ecckd_tpu/tools/run_ckd.py`` (ref
src/ecckd/run_ckd.cpp:26-373): per-g-point optical depths of a scenario's
(temperature_hl, pressure_hl, per-gas mole fractions) by LUT interpolation,
then the two-stream fluxes, in the CKDMIP-intercomparison format, all
columns at once.

:func:`run_ckd_core` returns every array the tool writes;
:func:`run_ckd` is the file tool (``python -m
ecckd_tpu_torch.tools.run_ckd ckd_model=... input=... output=...
[gases="..."] [co2_scaling=X ...] [write_od_only=1] [tsi=1361]
[device=cuda|cpu]``).
"""

from __future__ import annotations

import sys
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import logs
from ..config import Config
from ..constants import REFERENCE_COS_SZA
from ..models import CkdModel, temperature_fl_from_hl
from ..ops.rt_lw import rt_lw
from ..ops.rt_sw import rt_direct_sw
from .common import (find_file, netcdf_format, read_string_list,
                     resolve_device, setup, tool_prologue)

SCALABLE_GASES = ("co2", "ch4", "n2o", "cfc11", "cfc12")


def run_ckd_core(model: CkdModel, pressure_hl, temperature_hl,
                 mole_fractions: Mapping[str, np.ndarray],
                 gases: Sequence[str] = (),
                 scalings: Optional[Mapping[str, float]] = None,
                 write_od_only=False, tsi=1361.0, device="cuda",
                 dtype=torch.float64) -> Dict[str, np.ndarray]:
    """Array-level run_ckd: {variable name: numpy array} of everything the
    file tool writes, on (ncol, nlev+1) half-level pressure and
    temperature and the full-level mole fractions of the scenario's gases
    (a model gas without one has no concentration dependence).  ``gases``
    restricts the gases summed (empty: all); ``scalings`` multiplies a
    gas's mole fraction by a factor >= 0.  Computed on ``device``, the card
    unless ``device="cpu"`` (raises without one)."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    scalings = scalings or {}
    is_sw = model.is_sw()
    domain = "sw" if is_sw else "lw"
    tsi_scaling = tsi / model.solar_irradiance.sum() if is_sw else -1.0

    pressure_hl = np.asarray(pressure_hl, np.float64)
    temperature_hl = np.asarray(temperature_hl, np.float64)
    p_hl, t_hl = t(pressure_hl), t(temperature_hl)
    temperature_fl = temperature_fl_from_hl(p_hl, t_hl)
    ncol, nlev1 = temperature_hl.shape
    nlay = nlev1 - 1
    ng = model.ng
    out = {"pressure_hl": pressure_hl}

    od = torch.zeros((ncol, nlay, ng), dtype=dtype, device=dev)
    for igas, molecule in enumerate(model.molecules):
        if gases and molecule not in gases:
            logs.log(f"  Skipping {molecule}")
            continue
        g = model.single_gas_data[igas]
        table = t(g.molar_abs)
        if molecule not in mole_fractions:
            logs.log(f"  Computing optical depth of {molecule} assuming no "
                     "concentration dependence")
            od_gas = model.calc_optical_depth(
                igas, p_hl, temperature_fl, molar_abs_override=table)
        else:
            vmr = np.asarray(mole_fractions[molecule], np.float64)
            scale = scalings.get(molecule, -1.0)
            if scale is not None and scale >= 0.0:
                vmr = vmr * scale
                logs.log(f"  Computing optical depth of {molecule} from "
                         f"concentration scaled by {scale}")
            else:
                logs.log(f"  Computing optical depth of {molecule}")
            od_gas = model.calc_optical_depth(igas, p_hl, temperature_fl,
                                              t(vmr), molar_abs_override=table)
        od = od + od_gas
        if not write_od_only:
            out[f"{molecule}_optical_depth"] = od_gas
    od = torch.clamp(od, min=0.0)
    out["optical_depth"] = od

    if is_sw:
        rayleigh_od = model.calc_rayleigh_optical_depth(
            p_hl, t(model.rayleigh_molar_scat))
        out["rayleigh_optical_depth"] = rayleigh_od
        out["incoming_sw"] = np.broadcast_to(
            model.solar_irradiance * tsi_scaling, (ncol, ng))
        if not write_od_only:
            ssi_g = t(tsi_scaling * model.solar_irradiance).expand(ncol, ng)
            flux_dn = rt_direct_sw(REFERENCE_COS_SZA, ssi_g,
                                   (od + rayleigh_od).movedim(-2, 0))
            flux_dn = flux_dn.movedim(0, -2)
            out[f"spectral_flux_dn_direct_{domain}"] = flux_dn
            out[f"flux_dn_direct_{domain}"] = flux_dn.sum(-1)
    else:
        planck_hl = model.calc_planck_function(t_hl)
        out["planck_hl"] = planck_hl
        if not write_od_only:
            planck_surf = model.calc_planck_function(t_hl[:, -1])
            out["planck_surf"] = planck_surf
            flux_dn, flux_up = rt_lw(planck_hl.movedim(-2, 0),
                                     od.movedim(-2, 0),
                                     torch.ones_like(planck_surf),
                                     planck_surf)
            flux_dn, flux_up = flux_dn.movedim(0, -2), flux_up.movedim(0, -2)
            out[f"spectral_flux_up_{domain}"] = flux_up
            out[f"spectral_flux_dn_{domain}"] = flux_dn
            out[f"flux_up_{domain}"] = flux_up.sum(-1)
            out[f"flux_dn_{domain}"] = flux_dn.sum(-1)
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def run_ckd(cfg: Config, argv=()) -> str:
    """The file tool: read the ckd-definition and scenario files, write
    the fluxes in the JAX tool's schema."""
    from ..io import NcFile, NcWriter, write_standard_attributes

    device, dtype = setup(cfg)
    ckd_file = find_file(cfg.read_string("ckd_model"))
    input_file = find_file(cfg.read_string("input"))
    output_file = cfg.read_string("output")
    gas_list = read_string_list(cfg, "gases")
    scalings = {g: cfg.read_float(f"{g}_scaling", default=-1.0)
                for g in SCALABLE_GASES}
    write_od_only = cfg.read_bool("write_od_only", default=False)
    tsi = cfg.read_float("tsi", default=1361.0)

    model = CkdModel.read(ckd_file)
    is_sw = model.is_sw()
    domain = "sw" if is_sw else "lw"

    logs.log(f"Reading {input_file}")
    with NcFile(input_file) as inp:
        temperature_hl = np.asarray(inp.read("temperature_hl"), np.float64)
        pressure_hl = np.asarray(inp.read("pressure_hl"), np.float64)
        global_attrs = {k: inp.attribute(k, default="")
                        for k in ("experiment", "experiment_id",
                                  "sub_experiment", "sub_experiment_id")}
        mole_fractions = {
            m: np.asarray(inp.read(f"{m}_mole_fraction_fl"), np.float64)
            for m in model.molecules if inp.exist(f"{m}_mole_fraction_fl")}
    out = run_ckd_core(model, pressure_hl, temperature_hl, mole_fractions,
                       gases=gas_list, scalings=scalings,
                       write_od_only=write_od_only, tsi=tsi, device=device,
                       dtype=dtype)

    ncol, nlev1 = temperature_hl.shape
    nlay = nlev1 - 1
    logs.log(f"Writing {output_file}")
    w = NcWriter(output_file, format=netcdf_format(cfg))
    w.define_dimension("column", ncol)
    w.define_dimension("level", nlay)
    w.define_dimension("half_level", nlay + 1)
    w.define_dimension("g_point", model.ng)

    w.define_variable("pressure_hl", "float", "column", "half_level")
    w.write_long_name("Pressure", "pressure_hl")
    w.write_units("Pa", "pressure_hl")

    w.define_variable("optical_depth", "float", "column", "level", "g_point")
    if is_sw:
        w.write_long_name("Layer optical depth due to molecular absorption",
                          "optical_depth")
    else:
        w.write_long_name("Layer optical depth", "optical_depth")

    if not write_od_only:
        for molecule in model.molecules:
            w.define_variable(f"{molecule}_optical_depth", "float",
                              "column", "level", "g_point")
            w.write_long_name(f"{molecule} optical depth",
                              f"{molecule}_optical_depth")

    if not is_sw:
        w.define_variable("planck_hl", "float", "column", "half_level",
                          "g_point")
        w.write_long_name("Planck function", "planck_hl")
        w.write_units("W m-2", "planck_hl")
    else:
        w.define_variable("incoming_sw", "float", "column", "g_point")
        w.write_long_name("Incoming shortwave flux at top-of-atmosphere in "
                          "direction of sun", "incoming_sw")
        w.write_units("W m-2", "incoming_sw")
        w.define_variable("rayleigh_optical_depth", "float", "column",
                          "level", "g_point")
        w.write_long_name("Layer optical depth due to Rayleigh scattering",
                          "rayleigh_optical_depth")

    if not write_od_only:
        if not is_sw:
            w.define_variable("planck_surf", "float", "column", "g_point")
            w.write_long_name("Planck function at surface", "planck_surf")
            w.write_units("W m-2", "planck_surf")
            w.define_variable(f"spectral_flux_up_{domain}", "float",
                              "column", "half_level", "g_point")
            w.write_long_name("Spectral upwelling longwave flux",
                              f"spectral_flux_up_{domain}")
            w.write_units("W m-2", f"spectral_flux_up_{domain}")
            w.define_variable(f"spectral_flux_dn_{domain}", "float",
                              "column", "half_level", "g_point")
            w.write_long_name("Spectral downwelling longwave flux",
                              f"spectral_flux_dn_{domain}")
            w.write_units("W m-2", f"spectral_flux_dn_{domain}")
            w.define_variable(f"flux_up_{domain}", "float", "column",
                              "half_level")
            w.write_long_name("Upwelling longwave flux", f"flux_up_{domain}")
            w.write_units("W m-2", f"flux_up_{domain}")
            w.define_variable(f"flux_dn_{domain}", "float", "column",
                              "half_level")
            w.write_long_name("Downwelling longwave flux",
                              f"flux_dn_{domain}")
            w.write_units("W m-2", f"flux_dn_{domain}")
        else:
            w.define_variable(f"spectral_flux_dn_direct_{domain}", "float",
                              "column", "half_level", "g_point")
            w.write_long_name("Spectral downwelling direct shortwave flux",
                              f"spectral_flux_dn_direct_{domain}")
            w.write_units("W m-2", f"spectral_flux_dn_direct_{domain}")
            w.define_variable(f"flux_dn_direct_{domain}", "float", "column",
                              "half_level")
            w.write_long_name("Downwelling direct shortwave flux",
                              f"flux_dn_direct_{domain}")
            w.write_units("W m-2", f"flux_dn_direct_{domain}")

    write_standard_attributes(
        w, "Spectral optical depth from ecCKD gas optics scheme")
    if model.model_id:
        w.write_attribute(model.model_id, "model_id")
    w.append_history(argv or sys.argv)
    for k, v in global_attrs.items():
        if v:
            w.write_attribute(v, k)

    # In the JAX tool's order of writes
    order = (["pressure_hl"]
             + [f"{m}_optical_depth" for m in model.molecules]
             + ["optical_depth", "rayleigh_optical_depth", "incoming_sw",
                "planck_hl", "planck_surf",
                f"spectral_flux_up_{domain}", f"spectral_flux_dn_{domain}",
                f"flux_up_{domain}", f"flux_dn_{domain}",
                f"spectral_flux_dn_direct_{domain}",
                f"flux_dn_direct_{domain}"])
    for name in order:
        if name in out:
            w.write(out[name], name)
    w.close()
    return output_file


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: run_ckd(tool_prologue(argv), argv=["run_ckd"] + argv),
        name="run_ckd")


if __name__ == "__main__":
    sys.exit(main())
