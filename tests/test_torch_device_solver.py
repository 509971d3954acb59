"""The port's on-device L-BFGS (``solver="device"``) against the JAX
package's, on the CPU in float64, on the rig of tests/test_optimize.py
(h2o, 1024 wavenumbers, 6 profiles; training fluxes of profiles 0, 2, 4).

Held: the first 10 iterations' costs within 1e-8 relative of JAX's
(optax's L-BFGS and zoom line search, step for step); the final cost
within 5% of scipy's both ways (tests/test_optimize.py's parity check);
bounds and zero sentinels after 60 iterations through the file tool, with
the flux errors falling; the status of convergence, of the iteration cap
and of a non-finite cost as JAX maps them; a checkpoint at a chunk
boundary and a resume that counts total iterations, as JAX's does from the
same file; and one host read after every ``STEPS_PER_READ`` cost
evaluations.
"""

import numpy as np
import pytest
import torch

from ecckd_tpu.config import Config as JConfig
from ecckd_tpu.io.lbl_fluxes import LblFluxes as JLbl
from ecckd_tpu.models import CkdModel as JModel
from ecckd_tpu.ops.cost import CostWeights as JW
from ecckd_tpu.optimize import solver as jsolver
from ecckd_tpu.optimize.cost_fn import (build_scene, make_cost_fn,
                                        make_prior_fn)
from ecckd_tpu.tools import optimize_lut as joptimize
from ecckd_tpu_torch.config import Config
from ecckd_tpu_torch.io.lbl_fluxes import LblFluxes
from ecckd_tpu_torch.models import CkdModel
from ecckd_tpu_torch.ops.cost import CostWeights
from ecckd_tpu_torch.optimize import lbfgs
from ecckd_tpu_torch.optimize import solver as tsolver
from ecckd_tpu_torch.optimize.cost_fn import MIN_X
from ecckd_tpu_torch.tools import optimize_lut as toptimize
from test_torch_optimize import (_flux_errors, _opt_cfg,  # noqa: F401
                                 _recorded, rig)

WEIGHTS = dict(flux_weight=0.02, broadband_weight=0.5)


def _jax_problem(rig):
    """JAX's total cost, start, bounds and sentinels, as its solve builds
    them (ecckd_tpu/optimize/solver.py:330-370)."""
    m = JModel.read(rig["lut"], active_gas_list=["h2o"])
    m.create_error_covariances(prior_error=4.0)
    lbl = JLbl.read(rig["training"])
    joptimize._prepare_lbl(lbl, m, 1e4)
    data = make_cost_fn(m, [build_scene(m, lbl)], JW(**WEIGHTS))
    prior = make_prior_fn(m)
    x0 = jsolver.log_state_tree(m)
    background = {k: v.copy() for k, v in x0.items()}
    lo, hi = jsolver.state_bounds(m)
    sentinel = {k: np.asarray(v) <= MIN_X for k, v in x0.items()}
    return (lambda t: data(t) + prior(t, background)), x0, lo, hi, sentinel


def _port_problem(rig):
    m = CkdModel.read(rig["lut"], active_gas_list=["h2o"])
    m.create_error_covariances(prior_error=4.0)
    lbl = LblFluxes.read(rig["training"])
    toptimize.prepare_lbl(lbl, m, 1e4)
    cost = tsolver.TrainingCost(m, [lbl], CostWeights(**WEIGHTS),
                                device="cpu")
    x0 = tsolver.ravel_tree(tsolver.log_state_tree(m))
    lo, hi = (cost.tensor(tsolver.ravel_tree(t))
              for t in tsolver.state_bounds(m))
    return cost, cost.tensor(x0), lo, hi, torch.as_tensor(x0 <= MIN_X)


def test_first_iterations_match_jax(rig):
    """Each of the first 10 iterations' costs (the value at the point the
    iteration starts from) within 1e-8 relative of JAX's."""
    total, x0, lo, hi, sentinel = _jax_problem(rig)
    want = []
    jsolver._solve_on_device(total, x0, lo, hi, sentinel, 10, 1e-4,
                             chunk=1, on_chunk=lambda t, it, c:
                             want.append(c))
    cost, tx0, tlo, thi, tsent = _port_problem(rig)
    got, stats = [], lbfgs.Stats()
    lbfgs.minimize(cost.value_and_grad, tx0, tlo, thi, tsent, 10, 1e-4,
                   history=got, stats=stats)
    assert len(got) == len(want) == 10
    rel = np.abs(np.asarray(got) / np.asarray(want) - 1.0)
    assert rel.max() <= 1e-8, list(enumerate(rel))
    # one packed read after every STEPS_PER_READ steps (one evaluation
    # each): the 10 iterations are one chunk, read until the state froze,
    # and the steps after it are masked evaluations
    assert stats.iterations == 10
    steps = lbfgs.STEPS_PER_READ
    assert stats.host_reads == -(-stats.evaluations // steps)
    assert (stats.evaluations + stats.masked_evaluations
            == stats.host_reads * steps)


def _solve(rig, **kw):
    m = CkdModel.read(rig["lut"], active_gas_list=["h2o"])
    lbl = LblFluxes.read(rig["training"])
    toptimize.prepare_lbl(lbl, m, 1e4)
    m.create_error_covariances(prior_error=4.0)
    return tsolver.solve(m, [lbl], prior_error=4.0, device="cpu",
                         **WEIGHTS, **kw), m


def _jax_solve(rig, **kw):
    m = JModel.read(rig["lut"], active_gas_list=["h2o"])
    lbl = JLbl.read(rig["training"])
    joptimize._prepare_lbl(lbl, m, 1e4)
    m.create_error_covariances(prior_error=4.0)
    return jsolver.solve(m, [lbl], prior_error=4.0, **WEIGHTS, **kw), m


def test_final_cost_parity_with_scipy(rig):
    """tests/test_optimize.py's check on the port: 400 iterations at most,
    each final cost within 5% of the other."""
    costs = {sv: _solve(rig, max_iterations=400,
                        convergence_criterion=1e-4, solver=sv)[0].cost
             for sv in ("scipy", "device")}
    assert np.isfinite(costs["device"])
    assert costs["device"] <= costs["scipy"] * 1.05 + 1e-12
    assert costs["scipy"] <= costs["device"] * 1.05 + 1e-12


def test_bounds_sentinels_and_improvement(rig, tmp_path):
    """tests/test_optimize.py's test_device_solver_matches_scipy on the
    port's file tool: the flux errors fall, the bounds hold, zeros stay
    zero."""
    out = str(tmp_path / "lut_dev.nc")
    rc = toptimize.optimize_lut(Config(_opt_cfg(
        rig, out, max_iterations=60, convergence_criterion="0.002",
        bounded_minimization=1, solver="device", device="cpu")),
        argv=["optimize_lut"])
    assert rc == 0
    before = _flux_errors(rig["lut"], rig["training"])
    after = _flux_errors(out, rig["training"])
    assert after[0] < 0.7 * before[0]
    assert after[2] < 0.7 * before[2]
    g0 = CkdModel.read(rig["lut"]).gas("h2o")
    g1 = CkdModel.read(out).gas("h2o")
    pos = g0.molar_abs > 0
    assert np.all(g1.molar_abs[pos] <= g0.max_molar_abs[pos] * (1 + 1e-9))
    assert np.all(g1.molar_abs[pos] >= g0.min_molar_abs[pos]
                  * np.where(g0.min_molar_abs[pos] > 0, 1 - 1e-9, 0.0))
    assert np.all(g1.molar_abs[~pos] == 0.0)


@pytest.mark.parametrize("case", ["converged", "cap"])
def test_status_as_jax(rig, case):
    """The status of a run that converges (a loose criterion) and of one
    that reaches the cap, as JAX's device solver reports them, after as
    many iterations."""
    kw = (dict(max_iterations=50, convergence_criterion=1.0)
          if case == "converged"
          else dict(max_iterations=4, convergence_criterion=1e-12))
    res, _ = _solve(rig, solver="device", **kw)
    jres, _ = _jax_solve(rig, solver="device", **kw)
    assert res.status.name == jres.status.name == (
        "SUCCESS" if case == "converged" else "MAX_ITERATIONS_REACHED")
    assert res.n_iterations == jres.n_iterations
    assert abs(res.cost - jres.cost) <= 1e-8 * abs(jres.cost)


def test_status_of_a_non_finite_cost(rig, monkeypatch):
    """A cost that turns NaN ends the run after that iteration with
    INVALID_COST_FUNCTION (JAX's isfinite stop and status)."""
    real = tsolver.TrainingCost.value_and_grad
    calls = [0]

    def poisoned(self, x):
        calls[0] += 1
        value, grad = real(self, x)
        return (value * float("nan") if calls[0] >= 6 else value), grad
    monkeypatch.setattr(tsolver.TrainingCost, "value_and_grad", poisoned)
    res, _ = _solve(rig, solver="device", max_iterations=50,
                    convergence_criterion=1e-12)
    assert res.status.name == "INVALID_COST_FUNCTION"
    assert not np.isfinite(res.cost)
    assert res.n_iterations < 50


def test_checkpoint_and_resume(rig, tmp_path, monkeypatch):
    """A checkpoint at the chunk boundary (here the run's end, iteration
    8, every 4) holds the total count; a resume to 12 runs 4 more and the
    JAX device solver resumed from the same file gives the same LUT."""
    res = _recorded(monkeypatch, toptimize)
    ck = str(tmp_path / "dev.ckpt")
    run = lambda tool, cls, out, ck, n, **kw: tool(cls(_opt_cfg(
        rig, str(tmp_path / out), max_iterations=n, checkpoint_file=ck,
        checkpoint_every=4, convergence_criterion="1e-12", solver="device",
        **kw)), argv=["optimize_lut"])
    run(toptimize.optimize_lut, Config, "o1.nc", ck, 8, device="cpu")
    with np.load(ck) as f:
        assert int(f["_n_iter"]) == 8
        assert set(f.files) == {"_n_iter", "_cost", "state_h2o"}
    jck = str(tmp_path / "jax.ckpt")
    with open(ck, "rb") as src, open(jck, "wb") as dst:
        dst.write(src.read())
    run(toptimize.optimize_lut, Config, "o2.nc", ck, 12, device="cpu")
    assert res[-1].n_iterations == 12
    with np.load(ck) as f:
        assert int(f["_n_iter"]) == 12
    run(joptimize.optimize_lut, JConfig, "j2.nc", jck, 12)
    a = CkdModel.read(str(tmp_path / "o2.nc")).gas("h2o").molar_abs
    b = CkdModel.read(str(tmp_path / "j2.nc")).gas("h2o").molar_abs
    np.testing.assert_allclose(a, b, rtol=1e-6)
