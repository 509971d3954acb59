"""The optimize_lut training step on a synthetic LW problem of production
size.

The port's counterpart of ``bench.py:250-308`` (``build_train_step``): one
value and gradient of the training cost of the log-LUT state (the work of
each evaluation of solve_adept.cpp:240-291), on a model built as
``__graft_entry__.py:22-74`` builds it (a composite background and an
h2o gas linear in its concentration, ng 64, nt 6, np 53) against random
truth fluxes of 48 columns of 50 layers.  ``lut_gas=True`` adds an o3 gas
in LUT concentration mode, active too, so that the tri-linear gather of
``models.gas_optics`` runs in the step.

:func:`descend` is PARITY.md's "20-step cost" (``scripts/tpu_parity.py``:
the cost after 20 fixed-rate gradient-descent steps), and
:func:`precision_levels` holds a float32 step against a float64 one by
PARITY.md's three numbers: the value, the gradient norm and the 20-step
cost.

Usage: ``python -m ecckd_tpu_torch.scripts.train_step [device=cpu]
[ncol=48] [lut_gas=1]`` prints one JSON line: the float64 value and
gradient norm and the float32 levels.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..constants import ACCEL_GRAVITY, SPECIFIC_HEAT_AIR
from ..io.lbl_fluxes import LblFluxes
from ..models import CkdModel, ConcDependence, GasData
from ..ops.cost import CostWeights
from ..ops.planck import planck_function
from ..optimize.solver import TrainingCost, log_state_tree, ravel_tree
from ..tools.common import resolve_device
from ..tools.optimize_lut import prepare_lbl

#: The LUT gas's concentration coordinate
O3_LUT_VMR = np.array([1e-8, 1e-7, 1e-6, 1e-5, 1e-4])


def synthetic_model(ng=32, nt=6, npress=20, lut_gas=False) -> CkdModel:
    """The LW CkdModel of ``__graft_entry__._synthetic_model``, with h2o
    active; ``lut_gas`` adds an active o3 gas with a concentration LUT."""
    pressure = np.exp(np.linspace(np.log(100.0), np.log(1.0e5), npress))
    t_ref = 200.0 + 80.0 * np.linspace(0.0, 1.0, npress)
    temperature = t_ref[None, :] + np.linspace(-40, 40, nt)[:, None]
    nwav = 200
    wav1 = np.linspace(0.0, 2000.0, nwav + 1)[:-1]
    wav2 = np.linspace(0.0, 2000.0, nwav + 1)[1:]
    gpoint_fraction = np.zeros((ng, nwav))
    edges = np.linspace(0, nwav, ng + 1).astype(int)
    for ig in range(ng):
        gpoint_fraction[ig, edges[ig]:edges[ig + 1]] = 1.0
    temperature_planck = np.arange(120.0, 351.0)
    wav_mid = 0.5 * (wav1 + wav2)
    pf = planck_function(temperature_planck, torch.as_tensor(wav_mid),
                         torch.as_tensor(wav2 - wav1)).numpy()
    planck_lut = pf @ gpoint_fraction.T

    def lut(scale, tdep, pdep):
        return scale * np.exp(
            tdep * (temperature - temperature.mean())[:, :, None] / 50.0
            + pdep * np.log(pressure / pressure[-1])[None, :, None]
            + np.linspace(-3.0, 1.5, ng)[None, None, :])

    h2o = GasData("h2o", ConcDependence.LINEAR, molar_abs=lut(2e-3, 0.4,
                                                              -0.2))
    h2o.min_molar_abs = h2o.molar_abs * 0.2
    h2o.max_molar_abs = h2o.molar_abs * 5.0
    h2o.is_active = True
    composite = GasData("composite", ConcDependence.NONE,
                        molar_abs=lut(1e-6, 0.1, 0.3))
    composite.composite_vmr = np.full((1, npress), 4e-4)
    composite.composite_molecules = "co2"
    gases = [composite, h2o]
    if lut_gas:
        # absorption per mole falling as the concentration rises
        per_conc = (O3_LUT_VMR / 1e-6) ** -0.15
        o3 = GasData("o3", ConcDependence.LUT, vmr=O3_LUT_VMR,
                     molar_abs=per_conc[:, None, None, None]
                     * lut(5e-2, 0.2, 0.4)[None])
        o3.min_molar_abs = o3.molar_abs * 0.2
        o3.max_molar_abs = o3.molar_abs * 5.0
        o3.is_active = True
        gases.append(o3)
    return CkdModel(
        gases, pressure, temperature, wav1, wav2, gpoint_fraction,
        np.array([0.0]), np.array([2000.0]), np.zeros(ng, np.int32),
        temperature_planck=temperature_planck, planck_function=planck_lut)


def atmosphere(ncol=8, nlay=50, seed=0):
    """(pressure_hl, temperature_hl, h2o vmr, o3 vmr) of
    ``__graft_entry__._atmosphere``, with an o3 layer peaking near 10 hPa."""
    rng = np.random.default_rng(seed)
    pressure_hl = np.tile(
        np.exp(np.linspace(np.log(120.0), np.log(1.0e5), nlay + 1)),
        (ncol, 1))
    temperature_hl = (np.linspace(215.0, 288.0, nlay + 1)[None, :]
                      + rng.normal(0, 5, (ncol, 1)))
    vmr = 4e-6 + 8e-3 * (pressure_hl[:, 1:] / 1.0e5) ** 3
    log_p = np.log(0.5 * (pressure_hl[:, 1:] + pressure_hl[:, :-1]))
    o3 = 3e-8 + 8e-6 * np.exp(-((log_p - np.log(1.0e3)) / 1.5) ** 2)
    return pressure_hl, temperature_hl, vmr, o3


def training_fluxes(model: CkdModel, ncol=48, nlay=50, seed=0):
    """The LblFluxes of ``bench.build_train_step``: the atmosphere, random
    spectral truth fluxes per g-point and their heating rates, prepared
    for ``model`` as optimize_lut prepares a training file."""
    pressure_hl, temperature_hl, vmr, o3 = atmosphere(ncol, nlay, seed)
    ng = model.ng
    rng = np.random.default_rng(0)
    lbl = LblFluxes()
    lbl.is_sw = False
    lbl.pressure_hl = pressure_hl
    lbl.temperature_hl = temperature_hl
    lbl.vmr_fl = np.stack([vmr, o3], axis=1)
    lbl.molecules = ["h2o", "o3"]
    lbl.spectral_flux_dn = np.abs(rng.normal(5.0, 1.0, (ncol, nlay + 1, ng)))
    lbl.spectral_flux_up = np.abs(rng.normal(5.0, 1.0, (ncol, nlay + 1, ng)))
    lbl.flux_dn = lbl.spectral_flux_dn.sum(-1)
    lbl.flux_up = lbl.spectral_flux_up.sum(-1)
    conv = -(ACCEL_GRAVITY / SPECIFIC_HEAT_AIR) / np.diff(pressure_hl,
                                                          axis=1)
    lbl.spectral_heating_rate = conv[:, :, None] * (
        np.diff(lbl.spectral_flux_dn, axis=1)
        - np.diff(lbl.spectral_flux_up, axis=1))
    lbl.heating_rate = lbl.spectral_heating_rate.sum(-1)
    lbl.surf_emissivity = np.ones((ncol, ng))
    lbl.have_spectral_fluxes = True
    return prepare_lbl(lbl, model, 1.0e4)


def training_cost(ng=64, nt=6, npress=53, ncol=48, nlay=50, lut_gas=True,
                  device="cuda", dtype=torch.float64):
    """(TrainingCost, its starting state as a flat tensor on ``device``)
    of the production-size step (the card unless ``device="cpu"``)."""
    model = synthetic_model(ng=ng, nt=nt, npress=npress, lut_gas=lut_gas)
    lbl = training_fluxes(model, ncol=ncol, nlay=nlay)
    cost = TrainingCost(model, [lbl], CostWeights(), device=device,
                        dtype=dtype)
    return cost, cost.tensor(ravel_tree(log_state_tree(model)))


def descend(cost: TrainingCost, x, steps=20, rate=1.0e-3):
    """The cost after ``steps`` gradient-descent steps of fixed ``rate``
    from ``x`` (PARITY.md's 20-step cost)."""
    for _ in range(steps):
        x = x - rate * cost.value_and_grad(x)[1]
    return float(cost.value_and_grad(x)[0])


def precision_levels(cost64, x64, cost32, x32):
    """Relative differences of float32 from float64: value, gradient norm
    (2-norm) and the 20-step cost, and the float64 numbers."""
    # read before the next call: on the card it overwrites the outputs
    v64, g64 = cost64.value_and_grad(x64)
    v64, n64 = float(v64), float(g64.norm())
    v32, g32 = cost32.value_and_grad(x32)
    v32, n32 = float(v32), float(g32.double().norm())
    s64, s32 = descend(cost64, x64), descend(cost32, x32)
    rel = lambda a, b: abs(a - b) / abs(b)
    return {"value": v64, "gradient_norm": n64, "cost_20": s64,
            "value_rel": rel(v32, v64),
            "gradient_norm_rel": rel(n32, n64),
            "cost_20_rel": rel(s32, s64)}


def main(argv=None) -> int:
    from ..config import Config
    cfg = Config.from_args(sys.argv[1:] if argv is None else list(argv))
    dev = resolve_device(cfg.read_string("device", default="cuda"))
    kw = dict(ncol=cfg.read_int("ncol", default=48),
              lut_gas=cfg.read_bool("lut_gas", default=True), device=dev)
    c64, x64 = training_cost(dtype=torch.float64, **kw)
    c32, x32 = training_cost(dtype=torch.float32, **kw)
    print(json.dumps(precision_levels(c64, x64, c32, x32)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
