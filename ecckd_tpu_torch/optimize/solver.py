"""Bounded L-BFGS minimisation of the LUT coefficients.

PyTorch counterpart of ``ecckd_tpu/optimize/solver.py`` (ref solve_adept,
src/ecckd/solve_adept.cpp:309-419): the state is log(k) per active gas
(MIN_X sentinel holding exact zeros at zero), bounds come from the min/max
LUT arrays with the reference's zero-min fixups, and each evaluation runs
the value and gradient of the full training cost on the device.  Two
minimisers: scipy's L-BFGS-B on the host (``solver="scipy"``, and "auto"),
the reference's exact bounded behaviour, and the projected L-BFGS of the
JAX package's ``solver="device"``, whose whole loop runs on tensors on the
device (:mod:`.lbfgs`).

The state is flattened in the JAX package's ``ravel_pytree`` order (gases
sorted by name, each LUT in C order), so the bounds list, the L-BFGS-B
vector and the checkpoints match JAX's element for element.  One scipy
evaluation copies the state to the device once and its value and gradient
back once.  On the card the value and gradient are replays of CUDA graphs
of the eager code (:mod:`.graphs`, the counterpart of JAX's ``jax.jit``),
and the device solver's step is one graph (the counterpart of its jitted
``lax.while_loop`` chunks).  With ``data_parallel`` the profiles are split
over the shards of a mesh
(:func:`~ecckd_tpu_torch.parallel.mesh.profile_slices`): each shard
evaluates its own against a copy of the state, and the values and
gradients are summed in shard order, then over the processes of
``torch.distributed``, where every process runs the same minimiser.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time
from typing import Dict

import numpy as np
import torch

from .. import logs
from ..logs import Timer
from ..ops.cost import CostWeights
from ..parallel.mesh import make_mesh, profile_slices
from ..tools.common import resolve_device
from . import lbfgs
from .cost_fn import MIN_X, build_scene, make_cost_fn, make_prior_fn


class MinimizerStatus(enum.Enum):
    SUCCESS = 0
    MAX_ITERATIONS_REACHED = 1
    FAILED = 2
    INVALID_COST_FUNCTION = 3

    def describe(self):
        return {
            MinimizerStatus.SUCCESS: "Converged",
            MinimizerStatus.MAX_ITERATIONS_REACHED:
                "Maximum iterations reached",
            MinimizerStatus.FAILED: "Failed to converge",
            MinimizerStatus.INVALID_COST_FUNCTION: "Invalid cost function",
        }[self]


def log_state_tree(model) -> Dict[str, np.ndarray]:
    """Log-space state with MIN_X sentinel for zeros
    (ref solve_adept.cpp:335-340)."""
    tree = {}
    for mol, k in model.active_lut_pytree().items():
        k = np.asarray(k, np.float64)
        with np.errstate(divide="ignore"):
            x = np.where(k > 0.0, np.log(np.where(k > 0.0, k, 1.0)), MIN_X)
        tree[mol] = x
    return tree


def state_bounds(model) -> (Dict[str, np.ndarray], Dict[str, np.ndarray]):
    """Log-space bounds from min/max LUTs with zero-min fixups
    (ref solve_adept.cpp:344-377 and ChangeLog v1.5)."""
    x_min_tree, x_max_tree = {}, {}
    for g in model.single_gas_data:
        if not g.is_active:
            continue
        k = np.asarray(g.molar_abs, np.float64)
        kmin = g.min_molar_abs
        kmax = g.max_molar_abs
        lo = np.full(k.shape, -np.inf)
        hi = np.full(k.shape, np.inf)
        if kmin is not None:
            with np.errstate(divide="ignore"):
                x = np.where(k > 0.0, np.log(np.where(k > 0, k, 1)), MIN_X)
                x_max = np.where(kmax > 0.0,
                                 np.log(np.where(kmax > 0, kmax, 1)), np.inf)
                x_min = np.where(kmin > 0.0,
                                 np.log(np.where(kmin > 0, kmin, 1)),
                                 -np.inf)
            # Where min is zero but k>0, widen: twice as far below (log) as
            # x_max is above x, capped at x_max-1
            fix = (kmin == 0.0) & (k > 0.0) & (kmax > 0.0)
            x_min = np.where(fix, np.minimum(3.0 * x - 2.0 * x_max,
                                             x_max - 1.0), x_min)
            bad = (kmax > 0.0) & (x_min >= x_max)
            nbad = int(bad.sum())
            if nbad:
                logs.warning(f"{nbad} bounds on the state variables have "
                             "x_min>=x_max")
                x_min = np.where(bad, x_max - 1.0, x_min)
            lo, hi = x_min, x_max
        x_min_tree[g.molecule] = lo
        x_max_tree[g.molecule] = hi
    if model.rayleigh_is_active:
        k = np.asarray(model.rayleigh_molar_scat, np.float64)
        x_min_tree["rayleigh"] = np.full(k.shape, -np.inf)
        x_max_tree["rayleigh"] = np.full(k.shape, np.inf)
    return x_min_tree, x_max_tree


def ravel_tree(tree) -> np.ndarray:
    """The state as one float64 vector: keys sorted, each array in C order
    (the order of ``jax.flatten_util.ravel_pytree`` on a dict)."""
    return np.concatenate([np.ravel(np.asarray(tree[k], np.float64))
                           for k in sorted(tree)])


class FlatState:
    """Views of a flat state vector as the dict of LUT-shaped arrays it
    ravels (:func:`ravel_tree`)."""

    def __init__(self, tree):
        self.keys = sorted(tree)
        self.shapes = [np.shape(tree[k]) for k in self.keys]
        self.sizes = [int(np.prod(s)) for s in self.shapes]

    def unravel(self, flat):
        out, i0 = {}, 0
        for k, shape, n in zip(self.keys, self.shapes, self.sizes):
            out[k] = flat[i0:i0 + n].reshape(shape)
            i0 += n
        return out


def _save_checkpoint(path: str, tree, n_iter: int, cost: float):
    """Atomically write optimizer state (the log-LUT dict + iteration
    count), in the JAX package's ``.npz`` layout."""
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, _n_iter=np.int64(n_iter), _cost=np.float64(cost),
                 **{f"state_{k}": np.asarray(v) for k, v in tree.items()})
    os.replace(tmp, path)


def _remove_checkpoint(path: str):
    """Drop a completed run's checkpoint so a forced rerun starts clean."""
    try:
        os.remove(path)
    except OSError:
        pass


def _load_checkpoint(path: str, expect_tree):
    """Load a checkpoint if present and shape-compatible, else None."""
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as ck:
        tree = {k[len("state_"):]: np.asarray(ck[k]) for k in ck.files
                if k.startswith("state_")}
        n_iter = int(ck["_n_iter"])
    if set(tree) != set(expect_tree) or any(
            tree[k].shape != np.asarray(expect_tree[k]).shape
            for k in tree):
        logs.warning(f"Checkpoint {path} does not match the state layout; "
                     "ignoring it")
        return None
    return tree, n_iter


class TrainingCost:
    """The training cost (data and prior) of a model's active LUTs against
    its training fluxes, as a function of the flat log-state.

    ``value_and_grad(x)`` takes and returns tensors on ``device``; calling
    the object with a float64 numpy vector returns scipy's (value,
    gradient) with one copy each way.  With a ``mesh`` of more than one
    shard the profiles of every training scene are split over its shards
    (:func:`~ecckd_tpu_torch.parallel.mesh.profile_slices`, padding copies
    of weight zero), each shard's data cost and gradient are evaluated on
    its device against a copy of the state, and both are summed with the
    mesh's collective, in shard order and then over the processes; the
    prior is added on ``device``.

    On the card ``value_and_grad`` replays CUDA graphs of the eager code
    (:class:`~.graphs.GraphedStep`, captured at the first call): one for
    the whole cost, or with a mesh one for each shard's data cost on its
    device and one for the prior, the collective between them running
    eagerly.  :meth:`value_and_grad_eager` is the plain version, which the
    CPU runs."""

    def __init__(self, model, training_data, weights: CostWeights,
                 negative_od_penalty=1.0e4, pressure_weight_power=0.5,
                 erythemal_weight=0.0, relative_fluxes=None, device="cuda",
                 dtype=torch.float64, mesh=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        scene_args = dict(pressure_weight_power=pressure_weight_power,
                          erythemal_weight=erythemal_weight, dtype=dtype)
        rel = [None if relative_fluxes is None else relative_fluxes[i]
               for i in range(len(training_data))]
        if self.mesh is None:
            scenes = [build_scene(model, lbl, relative_fluxes=r,
                                  device=self.device, **scene_args)
                      for lbl, r in zip(training_data, rel)]
            self.data_cost = make_cost_fn(
                model, scenes, weights,
                negative_od_penalty=negative_od_penalty)
        else:
            slices = [profile_slices(self.mesh, lbl.pressure_hl.shape[0])
                      for lbl in training_data]
            self.shards = []
            for k, (_, dev) in enumerate(self.mesh.local_shards()):
                scenes = [build_scene(model, lbl, relative_fluxes=r,
                                      device=dev, profiles=sl[k][1],
                                      profile_weight=sl[k][2], **scene_args)
                          for lbl, r, sl in zip(training_data, rel, slices)]
                self.shards.append((dev, make_cost_fn(
                    model, scenes, weights,
                    negative_od_penalty=negative_od_penalty)))
        self.prior_cost = make_prior_fn(model, self.device, dtype)
        # The prior background is the model state as read, not a resumed
        # checkpoint (ckd_model.cpp:838-877 semantics)
        x0_tree = log_state_tree(model)
        self.state = FlatState(x0_tree)
        self.size = sum(self.state.sizes)
        self.prior_tree = self.state.unravel(self.tensor(ravel_tree(x0_tree)))
        self._graphs = None       # captured at the first call on the card
        self._constant = None     # the value without state variables
        self._staging = None      # scipy's pinned buffers on the card

    def tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def total_cost(self, tree):
        return self.data_cost(tree) + self.prior_cost(tree, self.prior_tree)

    def _prior_only(self, tree):
        return self.prior_cost(tree, self.prior_tree)

    def _value_and_grad_of(self, fn, x):
        x = x.detach().requires_grad_(True)
        value = fn(self.state.unravel(x))
        # A part that does not depend on the state (a prior without terms,
        # a scene without the active gases) is a constant made on the
        # device, as a graph can capture it
        if not torch.is_tensor(value):
            value = torch.full((), value, dtype=x.dtype, device=x.device)
        if not value.requires_grad:
            return value.detach(), torch.zeros_like(x)
        (grad,) = torch.autograd.grad(value, x)
        return value.detach(), grad

    def _parts(self):
        """The eager value and gradient of each part, on its device: the
        whole cost, or each shard's data cost and the prior."""
        if self.mesh is None:
            return [(self.device, lambda x: self._value_and_grad_of(
                self.total_cost, x))]
        return [(dev, lambda x, c=cost: self._value_and_grad_of(c, x))
                for dev, cost in self.shards] + [
            (self.device, lambda x: self._value_and_grad_of(
                self._prior_only, x))]

    def _sum(self, x, parts):
        if self.mesh is None:
            return parts[0](x)
        packed = []
        for (dev, _), part in zip(self.shards, parts):
            v, g = part(x.to(dev))
            packed.append(torch.cat([v.reshape(1), g]))
        # One collective for the value and the gradient of every shard
        data = self.mesh.sum(packed, device=self.device)
        pv, pg = parts[-1](x)
        return data[0] + pv, data[1:] + pg

    def value_and_grad_eager(self, x):
        """The value and gradient at ``x``, every kernel launched from the
        host: the plain version of :meth:`value_and_grad`."""
        return self._sum(x, [fn for _, fn in self._parts()])

    def value_and_grad(self, x):
        """The value and gradient at ``x``.  On the card, replays of the
        captured step: the outputs are the graphs' or made from them, and
        a caller that keeps them past the next call copies them first.
        Without state variables (no active gas) the cost is a constant,
        computed once, and no graph is needed."""
        if self.device.type != "cuda":
            return self.value_and_grad_eager(x)
        if self.size == 0:
            if self._constant is None:
                self._constant = self.value_and_grad_eager(x)
            return self._constant
        if self._graphs is None:
            from .graphs import GraphedStep
            self._graphs = [GraphedStep(fn, x.detach().to(dev))
                            for dev, fn in self._parts()]
        return self._sum(x, self._graphs)

    def __call__(self, x_flat):
        """scipy's (value, gradient) at a float64 numpy vector: one copy to
        the device and one back, through pinned host buffers on the card,
        and one wait for the result."""
        if self.device.type != "cuda":
            value, grad = self.value_and_grad(self.tensor(x_flat))
            out = torch.cat([value.reshape(1), grad]).to(torch.float64)
            out = out.numpy()
            return float(out[0]), out[1:].copy()
        if self._staging is None:
            self._staging = (
                torch.empty(self.size, dtype=self.dtype, pin_memory=True),
                torch.empty(self.size, dtype=self.dtype, device=self.device),
                torch.empty(self.size + 1, dtype=torch.float64,
                            pin_memory=True),
                torch.cuda.Event())
        x_host, x_dev, out_host, done = self._staging
        x_host.copy_(torch.from_numpy(np.asarray(x_flat, np.float64)))
        x_dev.copy_(x_host, non_blocking=True)
        value, grad = self.value_and_grad(x_dev)
        out_host.copy_(torch.cat([value.reshape(1), grad]).to(torch.float64),
                       non_blocking=True)
        done.record()
        done.synchronize()
        out = out_host.numpy()
        return float(out[0]), out[1:].copy()


@dataclasses.dataclass
class SolveResult:
    status: MinimizerStatus
    cost: float
    n_iterations: int
    n_evaluations: int
    gradient_norm: float
    wall_time: float
    seconds_per_iteration: float
    first_cost: float = float("nan")
    device_seconds: float = 0.0     # cost function + gradient, host clock
    minimizer_seconds: float = 0.0
    host_reads: int = 0             # solver="device": packed state reads
    masked_evaluations: int = 0     # solver="device": frozen steps
    capture_seconds: float = 0.0    # solver="device": the step's graph


def solve(model, training_data, flux_weight=0.02, flux_profile_weight=0.0,
          broadband_weight=0.5, spectral_boundary_weight=0.0,
          erythemal_weight=0.0, prior_error=-1.0, max_iterations=3000,
          convergence_criterion=0.02, negative_od_penalty=1.0e4,
          pressure_weight_power=0.5, is_bounded=True,
          relative_fluxes=None, data_parallel=False,
          solver="auto", checkpoint_file=None,
          checkpoint_every=0, device="cuda",
          dtype=torch.float64, mesh=None) -> SolveResult:
    """Optimise the active gases' LUTs against LBL training fluxes.

    ``training_data`` is a list of LblFluxes; the model is updated in place.
    The cost and its gradient run on ``device`` (the card unless
    ``device="cpu"``; raises without one).  ``solver``: "scipy" (host
    L-BFGS-B around the device value and gradient, the reference's exact
    bounded behaviour), "device" (the whole projected L-BFGS on the device,
    :func:`.lbfgs.minimize`; bounds by projection) or "auto", which is
    scipy: JAX's rule off a TPU (``ecckd_tpu/optimize/solver.py:305-306``).

    ``data_parallel`` splits the profiles over the shards of ``mesh`` (by
    default a mesh over every visible card, or none on the CPU); with one
    shard it changes nothing.  Under ``torch.distributed`` every process
    runs the same minimiser on the all-reduced value and gradient.
    """
    from scipy.optimize import minimize

    if solver == "auto":
        solver = "scipy"
    if solver not in ("scipy", "device"):
        raise ValueError(f"solver={solver!r} not understood; choose auto, "
                         "scipy or device")
    device = resolve_device(device)
    if not data_parallel:
        mesh = None
    elif mesh is None and device.type == "cuda":
        mesh = make_mesh()
    if mesh is not None and mesh.size > 1:
        device = mesh.devices[0]
        logs.log(f"  Profiles split over {mesh.size} shards (data_parallel)")

    weights = CostWeights(
        flux_weight=flux_weight, flux_profile_weight=flux_profile_weight,
        broadband_weight=broadband_weight,
        spectral_boundary_weight=spectral_boundary_weight)
    cost = TrainingCost(model, training_data, weights,
                        negative_od_penalty=negative_od_penalty,
                        pressure_weight_power=pressure_weight_power,
                        erythemal_weight=erythemal_weight,
                        relative_fluxes=relative_fluxes, device=device,
                        dtype=dtype, mesh=mesh)

    x0_tree = log_state_tree(model)
    # Resume a long optimisation from its periodic state checkpoint.  The
    # iteration budget counts TOTAL iterations: a resumed run performs at
    # most max_iterations - it_offset further iterations.
    it_offset = 0
    if checkpoint_file:
        resumed = _load_checkpoint(checkpoint_file, x0_tree)
        if resumed is not None:
            x0_tree, it_offset = resumed
            logs.log(f"Resuming optimization from {checkpoint_file} "
                     f"(iteration {it_offset})")
    max_local = max(0, max_iterations - it_offset)
    last_saved = [it_offset]

    def _maybe_checkpoint(tree, n_iter, value):
        if (checkpoint_file and checkpoint_every > 0
                and n_iter - last_saved[0] >= checkpoint_every):
            _save_checkpoint(checkpoint_file, tree, n_iter, value)
            last_saved[0] = n_iter

    x0_flat = ravel_tree(x0_tree)
    sentinel_mask = x0_flat <= MIN_X
    if solver == "device":
        return _solve_device(model, cost, x0_flat, sentinel_mask, is_bounded,
                             max_iterations, max_local, it_offset,
                             convergence_criterion, _maybe_checkpoint,
                             checkpoint_file)

    bounds = None
    if is_bounded:
        lo_tree, hi_tree = state_bounds(model)
        lo_flat, hi_flat = ravel_tree(lo_tree), ravel_tree(hi_tree)
        # Sentinel entries are held fixed
        lo_flat = np.where(sentinel_mask, x0_flat, lo_flat)
        hi_flat = np.where(sentinel_mask, x0_flat, hi_flat)
        lo_flat = np.where(np.isfinite(lo_flat), lo_flat, None)
        hi_flat = np.where(np.isfinite(hi_flat), hi_flat, None)
        bounds = list(zip(lo_flat, hi_flat))
        n_lo = sum(1 for b in bounds if b[0] is not None)
        n_hi = sum(1 for b in bounds if b[1] is not None)
        logs.log(f"  Minimization is bounded: {n_lo} lower, {n_hi} upper "
                 f"bounds out of {len(bounds)} state variables")
    else:
        logs.log("  Minimization is unbounded")

    logs.log(f"Optimizing coefficients with L-BFGS: max iterations = "
             f"{max_iterations}, convergence criterion = "
             f"{convergence_criterion}")
    logs.log("  CKD model interpolation is "
             + ("LOGARITHMIC" if model.logarithmic_interpolation
                else "LINEAR"))

    n_eval = [0]
    first_val = [np.nan]
    last_grad_norm = [np.inf]
    last_val = [np.inf]
    t0 = time.perf_counter()
    # Named-activity breakdown matching the reference's Timer split
    # (solve_adept.cpp:214-231): device cost+gradient vs host minimizer
    timer = Timer()
    timer.start("minimizer")

    def fun(x_flat):
        timer.start("cost function + gradient (device)")
        val, grad_flat = cost(x_flat)
        timer.start("minimizer")
        # Hold sentinels fixed; flush tiny gradients
        # (ref solve_adept.cpp:276-286)
        grad_flat[sentinel_mask] = 0.0
        grad_flat[np.abs(grad_flat) < 1.0e-80] = 0.0
        if n_eval[0] == 0:
            first_val[0] = val
        n_eval[0] += 1
        last_grad_norm[0] = np.abs(grad_flat).max()
        last_val[0] = val
        return val, grad_flat

    n_iter = [0]

    def report(x_flat):
        n_iter[0] += 1
        if n_iter[0] % 10 == 1 or n_iter[0] < 5:
            logs.progress(f"Iteration {n_iter[0]}: gradient norm = "
                          f"{last_grad_norm[0]:.6g}")
        if (checkpoint_file and checkpoint_every > 0
                and n_iter[0] % checkpoint_every == 0):
            _maybe_checkpoint(cost.state.unravel(np.asarray(x_flat)),
                              n_iter[0] + it_offset, last_val[0])

    result = minimize(
        fun, x0_flat, jac=True, method="L-BFGS-B", bounds=bounds,
        callback=report,
        options=dict(maxiter=max_local, gtol=convergence_criterion,
                     ftol=1e-14, maxcor=30))
    wall = time.perf_counter() - t0
    timer.stop()

    tree_final = cost.state.unravel(np.asarray(result.x))
    model.set_active_lut_pytree({
        mol: np.where(v > MIN_X, np.exp(v), 0.0)
        for mol, v in tree_final.items()})

    if not np.isfinite(result.fun):
        status = MinimizerStatus.INVALID_COST_FUNCTION
    elif result.success:
        status = MinimizerStatus.SUCCESS
    elif result.nit >= max_local:
        status = MinimizerStatus.MAX_ITERATIONS_REACHED
    elif last_grad_norm[0] <= convergence_criterion:
        status = MinimizerStatus.SUCCESS
    else:
        status = MinimizerStatus.FAILED

    logs.log(f"Final cost function = {result.fun:.6g} after {result.nit} "
             f"iterations, {n_eval[0]} evaluations, {wall:.1f} s "
             f"({wall / max(result.nit, 1):.3f} s/iter)")
    logs.log(timer.report())
    if status == MinimizerStatus.SUCCESS and checkpoint_file:
        _remove_checkpoint(checkpoint_file)
    return SolveResult(
        status=status, cost=float(result.fun),
        n_iterations=int(result.nit) + it_offset,
        n_evaluations=n_eval[0], gradient_norm=float(last_grad_norm[0]),
        wall_time=wall,
        seconds_per_iteration=wall / max(int(result.nit), 1),
        first_cost=float(first_val[0]),
        device_seconds=timer.total("cost function + gradient (device)"),
        minimizer_seconds=timer.total("minimizer"))


def _solve_device(model, cost, x0_flat, sentinel_mask, is_bounded,
                  max_iterations, max_local, it_offset, gtol, checkpoint,
                  checkpoint_file) -> SolveResult:
    """``solve``'s on-device branch (``ecckd_tpu/optimize/solver.py:
    362-407``): the projected L-BFGS of :mod:`.lbfgs` in chunks of 100
    iterations, checkpoints at chunk boundaries, JAX's status mapping.
    On the card its step is one CUDA graph of the eager cost and the
    advance of the state (with a mesh, the cost's own graphs and the
    collective, then a graph of the advance); on the CPU it runs eagerly."""
    t = cost.tensor
    lo = hi = None
    if is_bounded:
        lo_tree, hi_tree = state_bounds(model)
        lo, hi = t(ravel_tree(lo_tree)), t(ravel_tree(hi_tree))
        logs.log("  Minimization is bounded (projection on device)")
    logs.log(f"Optimizing coefficients with ON-DEVICE L-BFGS: max "
             f"iterations = {max_iterations}, convergence criterion = "
             f"{gtol}")
    if cost.device.type != "cuda":
        value_and_grad, graph = cost.value_and_grad, None
    elif cost.mesh is None:
        value_and_grad, graph = cost.value_and_grad_eager, "step"
    else:
        value_and_grad, graph = cost.value_and_grad, "advance"
    stats = lbfgs.Stats()
    history = []

    def on_chunk(params, n_iter, value):
        tree = cost.state.unravel(params.to(torch.float64).cpu().numpy())
        checkpoint(tree, n_iter + it_offset, value)

    t0 = time.perf_counter()
    x, value, n_local, gnorm = lbfgs.minimize(
        value_and_grad, t(x0_flat), lo, hi,
        torch.as_tensor(sentinel_mask, device=cost.device), max_local, gtol,
        on_chunk=on_chunk if checkpoint_file else None, history=history,
        stats=stats, graph=graph)
    x = x.to(torch.float64).cpu().numpy()
    wall = time.perf_counter() - t0
    n_iter = n_local + it_offset
    tree_final = cost.state.unravel(x)
    model.set_active_lut_pytree({
        mol: np.where(v > MIN_X, np.exp(v), 0.0)
        for mol, v in tree_final.items()})
    if not np.isfinite(value):
        status = MinimizerStatus.INVALID_COST_FUNCTION
    elif gnorm <= gtol:
        status = MinimizerStatus.SUCCESS
    elif n_local >= max_local:
        status = MinimizerStatus.MAX_ITERATIONS_REACHED
    else:
        status = MinimizerStatus.FAILED
    per_iter = wall / max(n_local, 1)
    logs.log(f"Final cost function = {value:.6g} after {n_iter} "
             f"iterations, {stats.evaluations} evaluations "
             f"({stats.masked_evaluations} masked), {stats.host_reads} host "
             f"reads, {wall:.1f} s ({per_iter:.4f} s/iter; "
             f"{stats.capture_seconds:.2f} s of it capturing the step)")
    if status == MinimizerStatus.SUCCESS and checkpoint_file:
        _remove_checkpoint(checkpoint_file)
    return SolveResult(
        status=status, cost=float(value), n_iterations=n_iter,
        n_evaluations=stats.evaluations, gradient_norm=float(gnorm),
        wall_time=wall, seconds_per_iteration=per_iter,
        first_cost=history[0] if history else float("nan"),
        host_reads=stats.host_reads,
        masked_evaluations=stats.masked_evaluations,
        capture_seconds=stats.capture_seconds)
