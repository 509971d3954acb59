"""optimize_lut: refine LUT coefficients by autodiff L-BFGS.

PyTorch counterpart of ``ecckd_tpu/tools/optimize_lut.py`` (ref
src/ecckd/optimize_lut.cpp:24-325): minimise a flux/heating-rate cost
against line-by-line training fluxes, with gradients from
``torch.autograd`` through the two-stream radiative transfer, a
Markov-correlation prior, bounded log-space minimisation, and optional
forcing (relative-to) mode.

:func:`optimize_lut_core` works on a model and training fluxes in memory;
:func:`optimize_lut` is the file tool around it (``python -m
ecckd_tpu_torch.tools.optimize_lut key=value ... [device=cuda|cpu]
[precision=float64|float32]``).  ``solver`` is "scipy" (host L-BFGS-B),
"device" (the projected L-BFGS on the card) or "auto" (scipy, JAX's rule
off a TPU); ``data_parallel`` (on by default, as in the JAX tool) splits
the profiles over every visible card, and changes nothing with one card
or on the CPU.  Under ``torch.distributed``
(:func:`ecckd_tpu_torch.parallel.distributed.initialize_from_env`) every
process runs the same minimiser on the all-reduced value and gradient.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import logs
from ..config import Config
from ..io.lbl_fluxes import LblFluxes
from ..models import CkdModel
from ..optimize import MinimizerStatus, SolveResult, solve
from ..optimize.cost_fn import build_scene, make_total_od_fn
from ..optimize.solver import log_state_tree
from .common import (find_file, maybe_profile, netcdf_format,
                     read_string_list, resolve_device, setup, tool_prologue)


def prepare_lbl(fluxes: LblFluxes, model: CkdModel,
                max_no_rayleigh_wavenumber: float):
    """Shared per-scene setup (ref optimize_lut.cpp:204-288)."""
    fluxes.make_gas_mapping(model.molecules)
    if not model.is_sw():
        fluxes.planck_hl = model.calc_planck_function(
            fluxes.temperature_hl).numpy()
        fluxes.surf_planck = model.calc_planck_function(
            fluxes.temperature_hl[:, -1]).numpy()
    else:
        fluxes.solar_irradiance = model.solar_irradiance
    if fluxes.have_band_fluxes:
        fluxes.iband_per_g = model.iband_per_g(fluxes.band_wavenumber1,
                                               fluxes.band_wavenumber2)
    if model.is_sw():
        fluxes.mask_rayleigh_up(max_no_rayleigh_wavenumber)
    return fluxes


def reference_od(model, lbl, device="cuda", dtype=torch.float64):
    """Optical depth (ncol, nlay, ng) of the current model for a scene, on
    ``device`` (used for relative-to fluxes)."""
    scene, meta = build_scene(model, lbl, device=device, dtype=dtype)
    od_fn = make_total_od_fn(model, meta)
    tree = {k: torch.as_tensor(v, dtype=dtype, device=scene.pressure_hl.device)
            for k, v in log_state_tree(model).items()}
    return od_fn(tree, scene)


def optimize_lut_core(model: CkdModel, training_data: Sequence[LblFluxes],
                      gases: Optional[Sequence[str]] = (),
                      relative_to: Optional[LblFluxes] = None,
                      band_mapping=None, flux_weight=0.02,
                      flux_profile_weight=0.0, broadband_weight=0.5,
                      spectral_boundary_weight=0.0, erythemal_weight=0.0,
                      pressure_weight_power=0.5, prior_error=-1.0,
                      min_prior_error=-1.0, max_prior_error=-1.0,
                      prior_error_scaling=1.0, rayleigh_prior_error=0.0,
                      temperature_corr=0.5, pressure_corr=0.5,
                      conc_corr=0.5, convergence_criterion=0.02,
                      max_no_rayleigh_wavenumber=10000.0,
                      max_iterations=3000, negative_od_penalty=1.0e4,
                      is_bounded=True, data_parallel=False, solver="auto",
                      checkpoint_file=None,
                      checkpoint_every=0, profile_dir=None, device="cuda",
                      dtype=torch.float64, mesh=None) -> SolveResult:
    """Array-level optimize_lut: optimise ``model`` (updated in place)
    against the training fluxes, which are prepared here (and, with
    ``relative_to``, taken relative to those fluxes first).

    ``gases`` names the gases to optimise, as the tool's ``gases`` key:
    empty means all, and a positive ``rayleigh_prior_error`` adds
    "rayleigh"; ``gases=None`` keeps the model's own active flags.
    ``band_mapping`` is the tool's key of that name, given to
    ``LblFluxes.read``; here it only says whether fluxes per band may
    differ in number from the g-points.  The cost and its gradient run on
    ``device``, the card unless ``device="cpu"`` (raises without one);
    ``solver``, ``data_parallel`` and ``mesh`` go to :func:`solve`."""
    device = resolve_device(device)
    if gases is not None:
        gas_list = list(gases)
        if rayleigh_prior_error > 0.0:
            logs.log("Optimizing Rayleigh scattering coefficients with prior "
                     f"error of {rayleigh_prior_error}")
            gas_list = gas_list + ["rayleigh"]
        model.set_active(gas_list)

    model.cap_relative_linear_coeffts(0.8)
    model.create_error_covariances(
        prior_error, min_prior_error, max_prior_error, prior_error_scaling,
        pressure_corr, temperature_corr, conc_corr, rayleigh_prior_error)

    # Forcing (relative-to) mode (ref :195-237)
    rel_ckd = None
    if relative_to is not None:
        prepare_lbl(relative_to, model, max_no_rayleigh_wavenumber)
        od = reference_od(model, relative_to, device, dtype)
        rel_ckd = relative_to.calc_ckd_fluxes(od, device=device)

    for fluxes in training_data:
        if relative_to is not None:
            logs.log("  Subtracting reference fluxes")
            fluxes.subtract(relative_to)
        prepare_lbl(fluxes, model, max_no_rayleigh_wavenumber)
        if band_mapping is None and fluxes.nspec() != model.ng:
            raise ValueError(
                "band_mapping not provided, so number of g-points must "
                "match between LBL and CKD models")
    if not training_data:
        raise ValueError('"training_input" not specified')
    relative_list = (None if rel_ckd is None
                     else [rel_ckd] * len(training_data))

    with maybe_profile(Config({"profile_dir": profile_dir})
                       if profile_dir else None):
        result = solve(
            model, list(training_data), flux_weight=flux_weight,
            flux_profile_weight=flux_profile_weight,
            broadband_weight=broadband_weight,
            spectral_boundary_weight=spectral_boundary_weight,
            erythemal_weight=erythemal_weight, prior_error=prior_error,
            max_iterations=max_iterations,
            convergence_criterion=convergence_criterion,
            negative_od_penalty=negative_od_penalty,
            pressure_weight_power=pressure_weight_power,
            is_bounded=is_bounded, relative_fluxes=relative_list,
            data_parallel=data_parallel, solver=solver,
            checkpoint_file=checkpoint_file,
            checkpoint_every=checkpoint_every, device=device, dtype=dtype,
            mesh=mesh)
    logs.log(f"Convergence status: {result.status.describe()}")
    return result


def optimize_lut(cfg: Config, argv=()) -> int:
    """The file tool: read the model and the training fluxes, optimise,
    write the ckd-definition file; 1 on an invalid cost function."""
    from ..io import NcFile

    device, dtype = setup(cfg)
    input_file = find_file(cfg.read_string("input"))
    output_file = cfg.read_string("output")

    gas_list = read_string_list(cfg, "gases")
    logs.log("Optimizing coefficients of: "
             + (" ".join(gas_list) if gas_list else "ALL GASES"))
    rayleigh_prior_error = cfg.read_float("rayleigh_prior_error",
                                          default=0.0)
    band_mapping = cfg.read_ints("band_mapping", default=None)
    if band_mapping is not None:
        band_mapping = np.asarray(band_mapping)

    active = gas_list + (["rayleigh"] if rayleigh_prior_error > 0.0 else [])
    model = CkdModel.read(input_file, active_gas_list=active)
    model.model_id = cfg.read_string("model_id", default="")

    # g-point map for high-res boundary fluxes (ref :167-183)
    g_point = model.g_point
    if g_point is None:
        gpoint_filename = cfg.read_string("gpointfile", default=None)
        if gpoint_filename:
            with NcFile(find_file(gpoint_filename)) as f:
                g_point = np.asarray(f.read("g_point"), np.int64)
            if model.ng != int(g_point.max()) + 1:
                raise ValueError(
                    f"Number of g-points in {input_file} does not match "
                    f"number in {gpoint_filename}")

    relative_to = None
    relative_to_file = cfg.read_string("relative_to", default=None)
    if relative_to_file:
        logs.log("Errors evaluated relative to the following file:")
        relative_to = LblFluxes.read(find_file(relative_to_file),
                                     band_mapping)
    training_data: List[LblFluxes] = [
        LblFluxes.read(find_file(name), band_mapping, g_point)
        for name in read_string_list(cfg, "training_input")]

    if rayleigh_prior_error > 0.0:
        logs.log("Optimizing Rayleigh scattering coefficients with prior "
                 f"error of {rayleigh_prior_error}")
    result = optimize_lut_core(
        model, training_data, gases=None, relative_to=relative_to,
        band_mapping=band_mapping,
        flux_weight=cfg.read_float("flux_weight", default=0.02),
        flux_profile_weight=cfg.read_float("flux_profile_weight",
                                           default=0.0),
        broadband_weight=cfg.read_float("broadband_weight", default=0.5),
        spectral_boundary_weight=cfg.read_float("spectral_boundary_weight",
                                                default=0.0),
        erythemal_weight=cfg.read_float("erythemal_weight", default=0.0),
        pressure_weight_power=cfg.read_float("pressure_weight_power",
                                             default=0.5),
        prior_error=cfg.read_float("prior_error", default=-1.0),
        min_prior_error=cfg.read_float("min_prior_error", default=-1.0),
        max_prior_error=cfg.read_float("max_prior_error", default=-1.0),
        prior_error_scaling=cfg.read_float("prior_error_scaling",
                                           default=1.0),
        rayleigh_prior_error=rayleigh_prior_error,
        temperature_corr=cfg.read_float("temperature_corr", default=0.5),
        pressure_corr=cfg.read_float("pressure_corr", default=0.5),
        conc_corr=cfg.read_float("conc_corr", default=0.5),
        convergence_criterion=cfg.read_float("convergence_criterion",
                                             default=0.02),
        max_no_rayleigh_wavenumber=cfg.read_float(
            "max_no_rayleigh_wavenumber", default=10000.0),
        max_iterations=cfg.read_int("max_iterations", default=3000),
        negative_od_penalty=cfg.read_float("negative_od_penalty",
                                           default=1e4),
        is_bounded=cfg.read_bool("bounded_minimization", default=True),
        data_parallel=cfg.read_bool("data_parallel", default=True),
        solver=cfg.read_string("solver", default="auto"),
        checkpoint_file=cfg.read_string("checkpoint_file", default=None),
        checkpoint_every=cfg.read_int("checkpoint_every", default=0),
        profile_dir=cfg.read_string("profile_dir", default=None),
        device=device, dtype=dtype)

    if cfg.read_bool("remove_min_max", default=False):
        model.save_min_max = False
    model.write(output_file, argv=argv or sys.argv,
                config_str=cfg.sprint(), format=netcdf_format(cfg))

    if result.status == MinimizerStatus.INVALID_COST_FUNCTION:
        return 1
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: optimize_lut(tool_prologue(argv), argv=["optimize_lut"] + argv),
        name="optimize_lut")


if __name__ == "__main__":
    sys.exit(main())
