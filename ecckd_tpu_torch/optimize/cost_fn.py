"""Training cost function for LUT optimisation.

PyTorch counterpart of ``ecckd_tpu/optimize/cost_fn.py`` (ref
calc_cost_function_and_gradient and the Adept tape,
src/ecckd/solve_adept.cpp:23-203): one function of the log-LUT state, a
dict of tensors, whose gradient comes from ``torch.autograd``.  The
profiles of a scene form the leading column axis of every array, where the
JAX package vmaps a one-profile cost (see :mod:`..ops.cost`).

A scene's LUT interpolation weights depend on its atmosphere only, so
:func:`build_scene` computes them once per gas (``SceneArrays.interpolation``)
and each evaluation applies them to the state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..models.gas_optics import (ConcDependence, lut_interpolation,
                                 rayleigh_optical_depth,
                                 temperature_fl_from_hl)
from ..ops.cost import cost_ckd_lw, cost_ckd_sw
from ..tools.common import resolve_device

# Sentinel for log of exactly-zero coefficients (ref solve_adept.cpp:21)
MIN_X = -1.0e20


class SceneArrays(NamedTuple):
    """Device tensors of one training scene."""
    pressure_hl: Any          # (ncol, nlev+1)
    temperature_fl: Any       # (ncol, nlay)
    vmr_fl: Any               # (ncol, ngas_lbl, nlay)
    flux_dn_true: Any         # (ncol, nlev+1, nband)
    flux_up_true: Any
    hr_true: Any              # (ncol, nlay, nband)
    layer_weight: Any         # (ncol, nlay)
    planck_hl: Any            # LW: (ncol, nlev+1, ng); SW: None
    surf_planck: Any          # LW: (ncol, ng)
    surf_emissivity_g: Any    # LW: (ncol, ng)
    mu0: Any                  # SW: (ncol,)
    ssi_g: Any                # SW: (ng,) tsi-scaled solar irradiance
    albedo_g: Any             # SW: (ng,)
    spectral_flux_dn_surf: Any   # (ncol, ng) or None
    spectral_flux_up_toa: Any
    relative_flux_dn: Any     # (ncol, nlev+1, ng) or None
    relative_flux_up: Any
    # One LutInterpolation per model gas, None where the scene lacks the
    # gas's concentration
    interpolation: Any = None


@dataclasses.dataclass
class SceneMeta:
    """Static per-scene metadata.  ``profile_weight`` (ncol,) weights each
    profile's cost: zero for the padding copies of a profile shard
    (:func:`~ecckd_tpu_torch.parallel.mesh.profile_slices`), None for a
    scene of real profiles only."""
    is_sw: bool
    gas_mapping: np.ndarray       # CKD gas index -> LBL vmr index
    band_onehot: np.ndarray       # (ng, nband)
    with_upwelling: bool = True   # SW only
    spectral_boundary_weights: Optional[np.ndarray] = None   # SW (ng,)
    profile_weight: Optional[np.ndarray] = None   # (ncol,), 0 = padding


def _exp_state(log_table):
    """Map log-space state to coefficients, holding zeros at zero."""
    return torch.where(log_table > MIN_X, torch.exp(log_table), 0.0)


def build_scene(model, lbl, pressure_weight_power=0.5,
                erythemal_weight=0.0, relative_fluxes=None, device="cuda",
                dtype=torch.float64, profiles=None,
                profile_weight=None) -> (SceneArrays, SceneMeta):
    """Prepare a training scene's tensors on ``device`` (the card unless
    ``device="cpu"``) and its static metadata from a CkdModel and an
    LblFluxes (host side, done once).

    ``profiles`` (indices, repeats allowed) takes those profiles of the
    LblFluxes only, and ``profile_weight`` weights their costs: one shard
    of the data-parallel cost (:class:`~.solver.TrainingCost`)."""
    dev = resolve_device(device)
    t = lambda a: (None if a is None else
                   torch.as_tensor(np.asarray(a), dtype=dtype, device=dev))
    if profiles is not None:
        rows = np.asarray(profiles, np.int64)
        # Only the per-profile arrays are cut: ssi_g and albedo_g are per
        # g-point whatever their length
        t_all = t
        t = lambda a: t_all(None if a is None else np.asarray(a)[rows])

    nspec = lbl.nspec()
    iband = lbl.iband_per_g
    if iband is None:
        iband = np.arange(nspec)
    nband = int(iband.max()) + 1
    band_onehot = (iband[:, None] == np.arange(nband)[None, :]
                   ).astype(np.float64)

    t_fl = temperature_fl_from_hl(lbl.pressure_hl, lbl.temperature_hl)

    # Layer weights: pressure-power weighting per profile
    # (ref solve_adept.cpp:132-143)
    p = lbl.pressure_hl
    if pressure_weight_power == 1.0:
        lw = np.diff(p, axis=1)
    else:
        lw = (p[:, 1:] ** pressure_weight_power
              - p[:, :-1] ** pressure_weight_power)
    lw = lw / lw.sum(axis=1, keepdims=True)

    planck_hl = surf_planck = surf_emis_g = None
    mu0 = ssi_g = albedo_g = None
    with_upwelling = True
    sbw = None
    if not lbl.is_sw:
        planck_hl = np.asarray(lbl.planck_hl)
        surf_planck = np.asarray(lbl.surf_planck)
        surf_emis_g = lbl.surf_emissivity[:, iband]
    else:
        mu0 = lbl.mu0
        tsi_scaling = lbl.tsi / model.solar_irradiance.sum()
        ssi_g = tsi_scaling * model.solar_irradiance
        albedo_g = lbl.effective_spectral_albedo[iband]
        with_upwelling = bool(np.any(lbl.effective_spectral_albedo > 0.0))
        if erythemal_weight > 0.0 and lbl.erythemal_spectrum is not None:
            sbw = erythemal_weight * lbl.erythemal_spectrum

    rel_dn = rel_up = None
    if relative_fluxes is not None:
        rel_dn, rel_up = relative_fluxes

    t_g = lambda a: (None if a is None else
                     torch.as_tensor(np.asarray(a), dtype=dtype, device=dev))
    pressure_hl, temperature_fl = t(lbl.pressure_hl), t(t_fl)
    vmr_fl = t(lbl.vmr_fl)
    interpolation = []
    for igas, g in enumerate(model.single_gas_data):
        gm = int(lbl.gas_mapping[igas])
        if gm < 0 and g.conc_dependence != ConcDependence.NONE:
            interpolation.append(None)      # gas not present in LBL file
            continue
        interpolation.append(lut_interpolation(
            g.conc_dependence, pressure_hl, temperature_fl,
            model.log_pressure, model.temperature,
            vmr_fl=vmr_fl[:, gm, :] if gm >= 0 else None, lut_vmr=g.vmr,
            reference_vmr=g.reference_vmr))

    arrays = SceneArrays(
        pressure_hl=pressure_hl,
        temperature_fl=temperature_fl,
        vmr_fl=vmr_fl,
        flux_dn_true=t(lbl.spectral_flux_dn),
        flux_up_true=t(lbl.spectral_flux_up),
        hr_true=t(lbl.spectral_heating_rate),
        layer_weight=t(lw),
        planck_hl=t(planck_hl),
        surf_planck=t(surf_planck),
        surf_emissivity_g=t(surf_emis_g),
        mu0=t(mu0),
        ssi_g=t_g(ssi_g),
        albedo_g=t_g(albedo_g),
        spectral_flux_dn_surf=t(lbl.spectral_flux_dn_surf),
        spectral_flux_up_toa=t(lbl.spectral_flux_up_toa),
        relative_flux_dn=t(rel_dn),
        relative_flux_up=t(rel_up),
        interpolation=tuple(interpolation),
    )
    meta = SceneMeta(is_sw=lbl.is_sw, gas_mapping=lbl.gas_mapping,
                     band_onehot=band_onehot,
                     with_upwelling=with_upwelling,
                     spectral_boundary_weights=sbw,
                     profile_weight=(None if profile_weight is None else
                                     np.asarray(profile_weight, np.float64)))
    return arrays, meta


def _constant(cache, name, array, like):
    """A model array as a tensor like ``like``, copied to the device once
    (at the first evaluation, before a CUDA graph of the cost is
    captured)."""
    key = (name, like.device, like.dtype)
    if key not in cache:
        cache[key] = torch.as_tensor(np.asarray(array), dtype=like.dtype,
                                     device=like.device)
    return cache[key]


def make_total_od_fn(model, meta: SceneMeta):
    """Function (state_tree, scene) -> od (ncol, nlay, ng).

    Replaces calc_total_optical_depth (solve_adept.cpp:23-69): sums CKD od
    over gases (the state for active gases, constants otherwise) plus
    Rayleigh (SW).
    """
    gas_info = []
    for igas, g in enumerate(model.single_gas_data):
        gm = int(meta.gas_mapping[igas])
        if gm < 0 and g.conc_dependence != ConcDependence.NONE:
            continue      # gas not present in LBL file
        gas_info.append((igas, g))
    constants = {}

    def total_od(tree, scene: SceneArrays):
        like = scene.pressure_hl
        od = 0.0
        if meta.is_sw:
            if model.rayleigh_is_active and "rayleigh" in tree:
                coeff = _exp_state(tree["rayleigh"])
            else:
                coeff = _constant(constants, "rayleigh",
                                  model.rayleigh_molar_scat, like)
            od = od + rayleigh_optical_depth(scene.pressure_hl, coeff)
        for igas, g in gas_info:
            if g.is_active:
                table = _exp_state(tree[g.molecule])
            else:
                table = _constant(constants, g.molecule, g.molar_abs, like)
            od = od + scene.interpolation[igas].optical_depth(
                table, model.logarithmic_interpolation)
        return od

    return total_od


def make_cost_fn(model, scenes, weights, negative_od_penalty=1.0e4):
    """Build the full training cost as a function of the log-LUT state.

    Args:
      model: CkdModel with active gases flagged.
      scenes: list of (SceneArrays, SceneMeta).
      weights: ops.cost.CostWeights.

    Returns:
      cost(tree) -> scalar tensor, differentiable in the tree.
    """
    od_fns = [make_total_od_fn(model, meta) for _, meta in scenes]
    band_onehots = [torch.as_tensor(meta.band_onehot,
                                    dtype=scene.pressure_hl.dtype,
                                    device=scene.pressure_hl.device)
                    for scene, meta in scenes]

    profile_weights = [None if meta.profile_weight is None else
                       torch.as_tensor(meta.profile_weight,
                                       dtype=scene.pressure_hl.dtype,
                                       device=scene.pressure_hl.device)
                       for scene, meta in scenes]
    # Copied once here: a copy from host memory inside the cost would
    # synchronise every evaluation and cannot be captured in a CUDA graph
    boundary_weights = [None if meta.spectral_boundary_weights is None else
                        torch.as_tensor(meta.spectral_boundary_weights,
                                        dtype=scene.pressure_hl.dtype,
                                        device=scene.pressure_hl.device)
                        for scene, meta in scenes]

    def cost(tree):
        total = 0.0
        for (scene, meta), od_fn, band_onehot, pw, sbw in zip(
                scenes, od_fns, band_onehots, profile_weights,
                boundary_weights):
            od = od_fn(tree, scene)
            # Negative-od quadratic penalty (ref solve_adept.cpp:107-116);
            # minimum/maximum split the gradient at od == 0 as JAX does
            zero = torch.zeros((), dtype=od.dtype, device=od.device)
            neg = torch.minimum(od, zero)
            if pw is None:
                total = total + negative_od_penalty * torch.sum(neg * neg)
            else:
                # A padding copy adds no penalty either (JAX's padded
                # copies do, ROADMAP §3)
                total = total + negative_od_penalty * torch.sum(
                    torch.sum(neg * neg, dim=(1, 2)) * pw)
            od = torch.maximum(od, zero)

            if not meta.is_sw:
                per_profile = cost_ckd_lw(
                    scene.pressure_hl, scene.planck_hl,
                    scene.surf_emissivity_g, scene.surf_planck, od,
                    scene.flux_dn_true, scene.flux_up_true, scene.hr_true,
                    scene.layer_weight, band_onehot, weights,
                    spectral_flux_dn_surf=scene.spectral_flux_dn_surf,
                    spectral_flux_up_toa=scene.spectral_flux_up_toa,
                    relative_flux_dn=scene.relative_flux_dn,
                    relative_flux_up=scene.relative_flux_up)
            else:
                per_profile = cost_ckd_sw(
                    scene.mu0, scene.pressure_hl, scene.ssi_g,
                    scene.albedo_g, od, scene.flux_dn_true,
                    scene.flux_up_true, scene.hr_true, scene.layer_weight,
                    band_onehot, weights,
                    with_upwelling=meta.with_upwelling,
                    spectral_boundary_weights=sbw,
                    spectral_flux_dn_surf=scene.spectral_flux_dn_surf,
                    relative_flux_dn=scene.relative_flux_dn,
                    relative_flux_up=scene.relative_flux_up)
            if pw is not None:
                # Zero-weight profiles are the padding copies of a profile
                # shard; they run but contribute nothing
                per_profile = per_profile * pw
            total = total + torch.sum(per_profile)
        return total

    return cost


def make_prior_fn(model, device="cuda", dtype=torch.float64):
    """Prior cost of the log-state delta tree (ref CkdOptimizable,
    solve_adept.cpp:262-283), differentiable in the tree; its matrices on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    gases = [(g.molecule, t(g.inv_background_shape),
              t(1.0 / g.background_error ** 2))
             for g in model.single_gas_data
             if g.is_active and g.inv_background_shape is not None]
    rayleigh_inv = (t(model.rayleigh_inv_background)
                    if model.rayleigh_is_active
                    and model.rayleigh_inv_background is not None else None)

    def prior(tree, prior_tree):
        cost = 0.0
        for mol, shape_mat, inv_var in gases:
            # Deltas at sentinel positions do not contribute
            delta = torch.where(prior_tree[mol] > MIN_X,
                                tree[mol] - prior_tree[mol], 0.0)
            ng = delta.shape[-1]
            d2 = delta.reshape(-1, ng)
            grad = (shape_mat @ d2) * inv_var[None, :]
            cost = cost + 0.5 * torch.sum(d2 * grad)
        if rayleigh_inv is not None and "rayleigh" in tree:
            delta = torch.where(prior_tree["rayleigh"] > MIN_X,
                                tree["rayleigh"] - prior_tree["rayleigh"],
                                0.0)
            cost = cost + 0.5 * torch.sum(rayleigh_inv * delta * delta)
        return cost

    return prior
