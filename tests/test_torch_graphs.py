"""The device solver as a state machine of one evaluation a step, and the
CUDA graphs of the training step (``ecckd_tpu_torch/optimize/lbfgs.py``,
``optimize/graphs.py``).

On the CPU, in float64, the state machine runs eagerly:
* against JAX's ``_solve_on_device`` on tests/test_optimize.py's rig (the
  first 10 iterations' costs within 1e-8 relative, read after every step
  and after every ``STEPS_PER_READ`` steps over chunk boundaries, the two
  bit-identical; the final cost, gradient norm and iteration count of a
  short run);
* on a bounded Rosenbrock problem with a pinned entry: a frozen step
  leaves every tensor of the state bit for bit; the host's reads, the
  masked evaluations and the chunk boundaries follow from the evaluations
  of each chunk for any number of steps between reads, with the same
  iterates;
* the SW cost with the spectral boundary weights copied at build time is
  the cost with the copy in every call, bit for bit.

On the card (marker ``gpu``, skipped here; run with ``python -m pytest
--noconftest -m gpu tests/test_torch_graphs.py``, which needs no jax): a
graphed value and gradient against the eager one bit for bit, in float64
and float32 and over a mesh of 4 logical shards, capture and replay under
``torch.cuda.set_sync_debug_mode("error")``; the graphed device solver's
iterates against the eager state machine's bit for bit.  The JAX package
is imported inside the CPU tests only.
"""

import math

import numpy as np
import pytest
import torch

from ecckd_tpu_torch.optimize import lbfgs

STEPS = lbfgs.STEPS_PER_READ


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """tests/test_optimize.py's rig as tests/test_torch_optimize.py builds
    it with the JAX tools, imported here so that the card's cases need no
    jax."""
    import test_torch_optimize
    return test_torch_optimize.rig.__wrapped__(tmp_path_factory)


def _rig():
    """The JAX and port problems on the rig."""
    from test_torch_device_solver import _jax_problem, _port_problem
    return _jax_problem, _port_problem


def test_first_iterations_match_jax(rig, monkeypatch):
    """The first 10 iterations' costs within 1e-8 relative of JAX's
    ``_solve_on_device``, with a read after every step and with one after
    every ``STEPS_PER_READ`` steps in chunks of 3 iterations: the two runs
    bit-identical."""
    from ecckd_tpu.optimize import solver as jsolver
    jax_problem, port_problem = _rig()
    total, x0, lo, hi, sentinel = jax_problem(rig)
    want = []
    jsolver._solve_on_device(total, x0, lo, hi, sentinel, 10, 1e-4,
                             chunk=1, on_chunk=lambda t, it, c:
                             want.append(c))
    cost, tx0, tlo, thi, tsent = port_problem(rig)
    runs = {}
    for steps, chunk in ((1, 100), (STEPS, 3)):
        monkeypatch.setattr(lbfgs, "STEPS_PER_READ", steps)
        got, stats = [], lbfgs.Stats()
        params, value, it, gnorm = lbfgs.minimize(
            cost.value_and_grad, tx0, tlo, thi, tsent, 10, 1e-4,
            chunk=chunk, history=got, stats=stats)
        runs[steps] = (got, params.clone(), value, gnorm, stats)
    got = runs[STEPS][0]
    assert len(got) == len(want) == 10
    rel = np.abs(np.asarray(got) / np.asarray(want) - 1.0)
    print(f"first 10 iterations: worst relative difference from JAX "
          f"{rel.max():.3e}")
    assert rel.max() <= 1e-8, list(enumerate(rel))
    (g1, p1, v1, n1, s1), (g2, p2, v2, n2, s2) = runs[1], runs[STEPS]
    assert g1 == g2 and torch.equal(p1, p2) and (v1, n1) == (v2, n2)
    assert s1.evaluations == s2.evaluations and s1.masked_evaluations == 0
    assert s1.host_reads == s1.evaluations


def test_short_run_matches_jax(rig):
    """A run of at most 30 iterations in chunks of 7: JAX's final cost and
    gradient norm within 1e-8 relative, the same iteration count, and a
    chunk boundary at each of JAX's."""
    from ecckd_tpu.optimize import solver as jsolver
    jax_problem, port_problem = _rig()
    total, x0, lo, hi, sentinel = jax_problem(rig)
    jchunks, chunks = [], []
    _, jvalue, jit, jgnorm = jsolver._solve_on_device(
        total, x0, lo, hi, sentinel, 30, 1e-4, chunk=7,
        on_chunk=lambda t, it, c: jchunks.append(it))
    cost, tx0, tlo, thi, tsent = port_problem(rig)
    _, value, it, gnorm = lbfgs.minimize(
        cost.value_and_grad, tx0, tlo, thi, tsent, 30, 1e-4, chunk=7,
        on_chunk=lambda p, it, v: chunks.append(it))
    assert it == jit and chunks == jchunks
    assert abs(value / jvalue - 1.0) <= 1e-8
    assert abs(gnorm / jgnorm - 1.0) <= 1e-8


# -------------------------------------------- a small problem, no model

def _rosenbrock(n=6, device="cpu", dtype=torch.float64):
    """(counting value-and-gradient, x0, lo, hi, sentinel) of a bounded
    Rosenbrock function with its last entry pinned, on ``device``."""
    calls = [0]

    def value_and_grad(x):
        calls[0] += 1
        x = x.detach().requires_grad_(True)
        v = torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                      + (1.0 - x[:-1]) ** 2)
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g

    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    rng = np.random.default_rng(5)
    x0 = t(rng.uniform(-1.5, 0.5, n))
    lo, hi = t(np.full(n, -2.0)), t(np.full(n, 0.9))
    sentinel = torch.zeros(n, dtype=torch.bool, device=device)
    sentinel[-1] = True
    return value_and_grad, calls, x0, lo, hi, sentinel


def test_frozen_step_leaves_the_state():
    """Once the iteration limit is reached the state is frozen: further
    steps evaluate at the parameters and leave every tensor of the state
    bit for bit."""
    vg, calls, x0, lo, hi, sentinel = _rosenbrock()
    m = lbfgs._Machine(x0, lo, hi, sentinel, 1e-12, 50)
    m._point()
    m.limit.fill_(3)
    while not bool(m.frozen()):
        m.step(vg)
    assert int(m.it) == 3 and not bool(m.in_search)
    before = {k: v.clone() for k, v in m.state().items()}
    n = calls[0]
    for _ in range(5):
        m.step(vg)
    assert calls[0] == n + 5
    for k, v in m.state().items():
        assert torch.equal(v, before[k]), k
    # a higher limit thaws it
    m.limit.fill_(4)
    m.step(vg)
    assert bool(m.in_search) and int(m.evaluations) == int(
        before["evaluations"]) + 1


@pytest.mark.parametrize("steps", [1, 3, STEPS])
def test_reads_and_chunks(steps, monkeypatch):
    """23 iterations in chunks of 5 with a read after every ``steps``
    steps: each chunk of E evaluations takes ceil(E / steps) reads and
    leaves the rest of its last batch as masked evaluations; the chunk
    boundaries, the iterates and the values are those of a read after
    every step."""
    def run(steps):
        monkeypatch.setattr(lbfgs, "STEPS_PER_READ", steps)
        vg, calls, x0, lo, hi, sentinel = _rosenbrock()
        seen, history, stats = [], [], lbfgs.Stats()
        params, value, it, gnorm = lbfgs.minimize(
            vg, x0, lo, hi, sentinel, 23, 1e-12, chunk=5,
            on_chunk=lambda p, it, v: seen.append(
                (it, v, p.clone(), calls[0])),
            history=history, stats=stats)
        return seen, history, params, (value, it, gnorm), stats, calls[0]

    ref = run(1)
    got = run(steps)
    # per chunk, the evaluations of the run read after every step
    evals = np.diff([0] + [c for *_, c in ref[0]])
    assert ref[4].masked_evaluations == 0 and evals.sum() == ref[5]
    reads = -(-evals // steps)
    assert got[4].host_reads == reads.sum()
    assert got[4].masked_evaluations == (reads * steps - evals).sum()
    assert got[4].evaluations == ref[4].evaluations == evals.sum()
    assert got[5] == reads.sum() * steps
    assert [s[0] for s in got[0]] == [s[0] for s in ref[0]] == [
        5, 10, 15, 20, 23]
    for (i1, v1, p1, _), (i2, v2, p2, _) in zip(got[0], ref[0]):
        assert (i1, v1) == (i2, v2) and torch.equal(p1, p2)
    assert got[1] == ref[1] and len(got[1]) == 23
    assert torch.equal(got[2], ref[2]) and got[3] == ref[3]


def test_converged_run_stops_inside_its_chunk():
    """A loose criterion stops the run inside its first chunk; the steps of
    the last batch after it are masked, and the status is that of
    convergence."""
    vg, calls, x0, lo, hi, sentinel = _rosenbrock()
    stats = lbfgs.Stats()
    _, value, it, gnorm = lbfgs.minimize(vg, x0, lo, hi, sentinel, 100,
                                         50.0, stats=stats)
    assert 0 < it < 100 and gnorm <= 50.0 and math.isfinite(value)
    assert stats.host_reads == -(-stats.evaluations // STEPS)
    assert calls[0] == stats.host_reads * STEPS


def test_sw_boundary_weights_copied_once():
    """The SW data cost with its spectral boundary weights copied at build
    time against the cost that copies them in every call (the form before
    the copy was hoisted): value and gradient bit for bit."""
    from ecckd_tpu_torch.models import CkdModel
    from ecckd_tpu_torch.io.lbl_fluxes import LblFluxes
    from ecckd_tpu_torch.ops.cost import CostWeights, cost_ckd_sw
    from ecckd_tpu_torch.optimize import cost_fn
    from ecckd_tpu_torch.optimize.solver import (FlatState, log_state_tree,
                                                 ravel_tree)
    from ecckd_tpu_torch.tools import optimize_lut as toptimize
    from synth import synth_sw_ckd_model
    from test_torch_optimize import _lbl, _scene_arrays
    import tempfile
    import os
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.nc")
        synth_sw_ckd_model().write(path, argv=["t"], config_str="")
        model = CkdModel.read(path, active_gas_list=["h2o", "co2"])
    a = _scene_arrays("sw", model.ng)
    lbl = _lbl(LblFluxes, a, "sw", model)
    toptimize.prepare_lbl(lbl, model, 1e4)
    weights = CostWeights(0.02, 0.01, 0.5, 0.0)
    scene, meta = cost_fn.build_scene(model, lbl, erythemal_weight=0.7,
                                      device="cpu")
    assert meta.spectral_boundary_weights is not None
    hoisted = cost_fn.make_cost_fn(model, [(scene, meta)], weights)
    od_fn = cost_fn.make_total_od_fn(model, meta)
    onehot = torch.as_tensor(meta.band_onehot, dtype=torch.float64)

    def per_call(tree):
        od = od_fn(tree, scene)
        zero = torch.zeros((), dtype=od.dtype)
        neg = torch.minimum(od, zero)
        total = 0.0 + 1.0e4 * torch.sum(neg * neg)
        od = torch.maximum(od, zero)
        sbw = torch.as_tensor(meta.spectral_boundary_weights,
                              dtype=od.dtype, device=od.device)
        return total + torch.sum(cost_ckd_sw(
            scene.mu0, scene.pressure_hl, scene.ssi_g, scene.albedo_g, od,
            scene.flux_dn_true, scene.flux_up_true, scene.hr_true,
            scene.layer_weight, onehot, weights,
            with_upwelling=meta.with_upwelling,
            spectral_boundary_weights=sbw,
            spectral_flux_dn_surf=scene.spectral_flux_dn_surf,
            relative_flux_dn=scene.relative_flux_dn,
            relative_flux_up=scene.relative_flux_up))

    tree0 = log_state_tree(model)
    state = FlatState(tree0)
    rng = np.random.default_rng(4)
    x0 = ravel_tree(tree0)
    x0 = np.where(x0 > cost_fn.MIN_X, x0 + rng.normal(0.0, 0.3, x0.shape),
                  x0)
    out = []
    for fn in (hoisted, per_call):
        x = torch.as_tensor(x0).requires_grad_(True)
        v = fn(state.unravel(x))
        (g,) = torch.autograd.grad(v, x)
        out.append((v.detach(), g))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert torch.count_nonzero(out[0][1]) > 0


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _small_cost(device, dtype=torch.float64, mesh=None):
    from ecckd_tpu_torch.ops.cost import CostWeights
    from ecckd_tpu_torch.optimize.solver import (TrainingCost,
                                                 log_state_tree, ravel_tree)
    from ecckd_tpu_torch.scripts.train_step import (synthetic_model,
                                                    training_fluxes)
    model = synthetic_model(ng=8, nt=4, npress=10, lut_gas=True)
    model.create_error_covariances(4.0)
    lbl = training_fluxes(model, ncol=5, nlay=12)
    cost = TrainingCost(model, [lbl], CostWeights(), device=device,
                        dtype=dtype, mesh=mesh)
    return cost, cost.tensor(ravel_tree(log_state_tree(model))), model


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f64", "f32", "mesh"])
def test_graphed_step_is_the_eager_step(cuda, case):
    """A graphed value and gradient against the eager one, bit for bit, at
    two points; capture and replay under sync debug mode "error"."""
    from ecckd_tpu_torch.parallel import make_mesh
    mesh = (make_mesh(devices=[cuda] * 4, data_parallel=1)
            if case == "mesh" else None)
    dtype = torch.float32 if case == "f32" else torch.float64
    cost, x, _ = _small_cost(cuda, dtype, mesh)
    y = x + 0.01 * torch.sin(torch.arange(x.numel(), device=cuda,
                                          dtype=dtype))
    want = [tuple(t.clone() for t in cost.value_and_grad_eager(p))
            for p in (x, y)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tuple(t.clone() for t in cost.value_and_grad(p))
               for p in (x, y)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for (gv, gg), (wv, wg) in zip(got, want):
        assert torch.equal(gv, wv) and torch.equal(gg, wg)
    v, g = cost(x.double().cpu().numpy())
    assert v == float(want[0][0]) and np.array_equal(
        g, want[0][1].double().cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("graph", ["step", "advance"])
def test_graphed_solver_is_the_eager_machine(cuda, graph):
    """The device solver graphed against the eager state machine on the
    card: its step as one graph, or (with a mesh of 4 logical shards) the
    shards' graphs and a graph of the advance; chunk boundaries, history
    and parameters bit for bit."""
    from ecckd_tpu_torch.optimize.solver import (ravel_tree, state_bounds)
    from ecckd_tpu_torch.parallel import make_mesh
    mesh = (make_mesh(devices=[cuda] * 4, data_parallel=1)
            if graph == "advance" else None)
    cost, x, model = _small_cost(cuda, mesh=mesh)
    lo, hi = (cost.tensor(ravel_tree(t)) for t in state_bounds(model))
    sentinel = x <= -1.0e20
    graphed = (cost.value_and_grad_eager if graph == "step"
               else cost.value_and_grad)
    runs = []
    for graph, fn in ((graph, graphed), (None, cost.value_and_grad_eager)):
        seen, history, stats = [], [], lbfgs.Stats()
        params, value, it, gnorm = lbfgs.minimize(
            fn, x, lo, hi, sentinel, 12, 1e-12, chunk=5,
            on_chunk=lambda p, it, v: seen.append((it, v)),
            history=history, stats=stats, graph=graph)
        runs.append((seen, history, params.clone(), value, it, gnorm,
                     stats.evaluations))
    a, b = runs
    assert a[0] == b[0] and a[1] == b[1] and torch.equal(a[2], b[2])
    assert a[3:] == b[3:]
