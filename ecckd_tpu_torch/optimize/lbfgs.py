"""Projected L-BFGS with a zoom line search, on tensors on the device.

The port of what ``ecckd_tpu/optimize/solver.py:_solve_on_device`` runs:
optax 0.2.6's ``lbfgs(memory_size=30)``, that is ``scale_by_lbfgs`` with
``scale_init_precond=True`` (optax/_src/transform.py:1573), ``scale(-1)``
and ``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')`` with optax's defaults (slope_rtol 1e-4,
curv_rtol 0.9, approx_dec_rtol 1e-6, stepsize_precision 1e-5,
increase_factor 2; optax/_src/alias.py:2595-2600, linesearch.py:576,
:1331), step for step, so that the two can be compared iterate by iterate.
The loop is JAX's ``body``/``cond``: the value and gradient at the
parameters, sentinel gradients set to zero, the update with the line search
on the unprojected objective, then the projection (a clip to ``[lo, hi]``
and the sentinels re-pinned to their start); it stops on the gradient's
max-norm reaching ``gtol``, a non-finite value or the iteration cap, in
chunks of ``chunk`` iterations.

Every quantity lives on the device.  Python decides the loop, so each line
search step reads one packed tensor to the host (whether the search is
over, which of its two branches runs next, and the iteration's value and
gradient norm for the stop test): one read per cost evaluation but the
first of each iteration, counted in :class:`Stats`.  A loop with no host
read at all needs the step captured as a graph (ROADMAP §2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import torch

MEMORY_SIZE = 30
MAX_LINESEARCH_STEPS = 20
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
TOL = 0.0


@dataclasses.dataclass
class Stats:
    iterations: int = 0
    evaluations: int = 0
    host_reads: int = 0


class _Memory:
    """``scale_by_lbfgs``'s state and update: the last ``m`` differences of
    parameters and gradients, their weights, the previous parameters and
    gradient, and the count of updates (known to the host)."""

    def __init__(self, like, m=MEMORY_SIZE):
        self.m = m
        self.count = 0
        self.params = torch.zeros_like(like)
        self.updates = torch.zeros_like(like)
        self.dw = torch.zeros((m,) + like.shape, dtype=like.dtype,
                              device=like.device)
        self.du = torch.zeros_like(self.dw)
        self.rho = torch.zeros(m, dtype=like.dtype, device=like.device)

    def precondition(self, updates, params):
        """P_k u_k, updating the memory with the fresh parameters and
        gradient first, as optax does."""
        m, count = self.m, self.count
        memory_idx = count % m
        prev = (count - 1) % m
        if count > 0:
            dp = params - self.params
            dg = updates - self.updates
            vdot = torch.dot(dg, dp)
            self.dw[prev] = dp
            self.du[prev] = dg
            self.rho[prev] = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
            num = torch.dot(dg, dp)
            den = torch.dot(dg, dg)
            scale = torch.where(den > 0.0, num / den, 1.0)
        else:
            # the slot of count 0 holds zeros, which optax writes too
            self.dw[prev] = 0.0
            self.du[prev] = 0.0
            self.rho[prev] = 0.0
            scale = torch.clamp(1.0 / torch.sqrt(torch.dot(updates, updates)),
                                max=1.0)
        # The two loops over the memory from its oldest slot (optax scans
        # all m; a slot never written holds zeros and weight zero, an
        # exact no-op, so only the written ones run)
        order = [(memory_idx + i) % m for i in range(m)][m - min(count, m):]
        vec = updates
        alphas = {}
        for idx in reversed(order):
            alpha = self.rho[idx] * torch.dot(self.dw[idx], vec)
            vec = vec + (-alpha) * self.du[idx]
            alphas[idx] = alpha
        vec = scale * vec
        for idx in order:
            beta = self.rho[idx] * torch.dot(self.du[idx], vec)
            vec = vec + (alphas[idx] - beta) * self.dw[idx]
        self.count = count + 1
        self.params = params
        self.updates = updates
        return vec


def _decrease_error(stepsize, value_step, slope_step, value_init,
                    slope_init):
    err = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - APPROX_DEC_RTOL * torch.abs(
        value_init)
    approx = torch.maximum(approx, delta_values)
    err = torch.clamp(torch.minimum(approx, err), min=0.0)
    return torch.where(torch.isnan(err), math.inf, err)


def _curvature_error(slope_step, slope_init):
    err = torch.clamp(torch.abs(slope_step) - CURV_RTOL * torch.abs(
        slope_init), min=0.0)
    return torch.where(torch.isnan(err), math.inf, err)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * dc * dc)) * v0 + db * db * db * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def _where(cond, new, old):
    return [torch.where(cond, n, o) for n, o in zip(new, old)]


class _ZoomLinesearch:
    """optax's zoom line search on one direction: its state as tensors, a
    step of either branch at a time (the host picks the branch)."""

    def __init__(self, value_and_grad, params, updates, value, grad):
        self.value_and_grad = value_and_grad
        self.params = params
        self.updates = updates
        zero = torch.zeros((), dtype=params.dtype, device=params.device)
        slope = torch.dot(updates, grad)
        inf = zero + math.inf
        false = torch.zeros((), dtype=torch.bool, device=params.device)
        self.count = 0
        self.stepsize = zero
        self.value, self.grad, self.slope = value, grad, slope
        self.value_init, self.slope_init = value, slope
        self.decrease_error = self.curvature_error = self.error = inf
        self.interval_found = self.done = self.failed = false
        self.low, self.value_low, self.slope_low = zero, value, slope
        self.high, self.value_high, self.slope_high = zero, value, slope
        self.cubic_ref, self.value_cubic_ref = zero, value
        self.safe_stepsize, self.safe_value, self.safe_grad = zero, value, grad

    def _on_line(self, stepsize):
        value, grad = self.value_and_grad(self.params
                                          + stepsize * self.updates)
        return value, grad, torch.dot(grad, self.updates)

    def _errors(self, stepsize, value, slope):
        de = _decrease_error(stepsize, value, slope, self.value_init,
                             self.slope_init)
        ce = _curvature_error(slope, self.slope_init)
        return de, ce, torch.maximum(de, ce)

    def search_interval(self):
        iter_num = self.count
        prev = (self.stepsize, self.value, self.slope)
        new_step = (torch.ones_like(self.stepsize) if iter_num == 0
                    else INCREASE_FACTOR * self.stepsize)
        value, grad, slope = self._on_line(new_step)
        de, ce, err = self._errors(new_step, value, slope)
        safe = de <= TOL
        self.safe_stepsize, self.safe_value, self.safe_grad = _where(
            safe, (new_step, value, grad),
            (self.safe_stepsize, self.safe_value, self.safe_grad))
        set_high = (de > 0.0) | ((value >= prev[1]) & (iter_num > 0))
        set_low = (slope >= 0.0) & ~set_high
        (self.low, self.value_low, self.slope_low, self.high,
         self.value_high, self.slope_high) = _where(
            set_low, (new_step, value, slope) + prev,
            prev + (new_step, value, slope))
        found = set_high | set_low | (err <= TOL)
        done = err <= TOL
        self.failed = done.logical_not() & (
            iter_num + 1 >= MAX_LINESEARCH_STEPS)
        self.interval_found, self.done = found, done
        self.stepsize, self.value, self.grad, self.slope = (new_step, value,
                                                            grad, slope)
        self.decrease_error, self.curvature_error, self.error = de, ce, err
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self.count = iter_num + 1

    def zoom_into_interval(self):
        iter_num = self.count
        low, value_low, slope_low = self.low, self.value_low, self.slope_low
        high, value_high, slope_high = (self.high, self.value_high,
                                        self.slope_high)
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        too_small = delta <= STEPSIZE_PRECISION
        middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                 self.cubic_ref, self.value_cubic_ref)
        use_cubic = ((middle_cubic > left + cubic_chk)
                     & (middle_cubic < right - cubic_chk))
        middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
        use_quad = use_cubic.logical_not() & (
            (middle_quad > left + quad_chk) & (middle_quad < right - quad_chk))
        use_bisection = use_cubic.logical_not() & use_quad.logical_not()
        middle = torch.where(use_cubic, middle_cubic, self.cubic_ref)
        middle = torch.where(use_quad, middle_quad, middle)
        middle = torch.where(use_bisection, (low + high) / 2.0, middle)
        value, grad, slope = self._on_line(middle)
        de, ce, err = self._errors(middle, value, slope)
        update_safe = (de <= TOL) & (value < self.safe_value)
        self.safe_stepsize, self.safe_value, self.safe_grad = _where(
            update_safe, (middle, value, grad),
            (self.safe_stepsize, self.safe_value, self.safe_grad))
        done = err <= TOL
        high_to_middle = (de > 0.0) | (value >= value_low)
        high_to_low = (slope * (high - low) >= 0.0) & ~high_to_middle
        low_to_middle = ~high_to_middle
        new_high = _where(high_to_middle, (middle, value, slope),
                          (high, value_high, slope_high))
        new_high = _where(high_to_low, (low, value_low, slope_low), new_high)
        new_low = _where(low_to_middle, (middle, value, slope),
                         (low, value_low, slope_low))
        self.cubic_ref, self.value_cubic_ref = _where(
            high_to_middle | high_to_low, (high, value_high),
            (low, value_low))
        failed = (too_small & (self.safe_stepsize > 0.0)) | (
            iter_num + 1 >= MAX_LINESEARCH_STEPS)
        self.failed = failed & done.logical_not()
        self.done = done
        self.high, self.value_high, self.slope_high = new_high
        self.low, self.value_low, self.slope_low = new_low
        self.stepsize, self.value, self.grad, self.slope = (middle, value,
                                                            grad, slope)
        self.decrease_error, self.curvature_error, self.error = de, ce, err
        self.count = iter_num + 1

    def try_safe_step(self):
        """Where the search failed: the safe step, if any (or where the
        objective is outside its domain), else the current one."""
        use_safe = self.failed & ((self.safe_stepsize > 0.0)
                                  | torch.isinf(self.decrease_error))
        self.stepsize, self.value, self.grad = _where(
            use_safe, (self.safe_stepsize, self.safe_value, self.safe_grad),
            (self.stepsize, self.value, self.grad))


def minimize(value_and_grad: Callable, x0, lo, hi, sentinel,
             max_iterations: int, gtol: float, chunk: int = 100,
             on_chunk: Optional[Callable] = None,
             history: Optional[List[float]] = None, stats: Stats = None):
    """Projected L-BFGS from ``x0`` (a flat tensor on the device).

    ``value_and_grad(x)`` returns the value (0-d tensor) and gradient of
    the unprojected objective; ``lo``, ``hi`` are tensors of bounds (None:
    unbounded); ``sentinel`` a bool tensor of entries held at ``x0``.
    ``on_chunk(params, n_iter, value)`` is called at every chunk boundary
    (params a device tensor); ``history`` gets each iteration's value.
    Returns (params, value, n_iter, gradient max-norm): the value and
    norm at the parameters the last iteration started from, as JAX's."""
    stats = Stats() if stats is None else stats

    def constrain(p):
        if lo is not None:
            p = torch.minimum(torch.maximum(p, lo), hi)
        return torch.where(sentinel, x0, p)

    def counted(x):
        stats.evaluations += 1
        return value_and_grad(x)

    params = constrain(x0)
    memory = _Memory(params)
    value_h, gnorm_h = 0.0, math.inf
    it = 0
    while it < max_iterations:
        limit = min(it + chunk, max_iterations)
        while it < limit and gnorm_h > gtol and math.isfinite(value_h):
            value, grad = counted(params)
            grad = torch.where(sentinel, 0.0, grad)
            gnorm = torch.max(torch.abs(grad))
            direction = -1.0 * memory.precondition(grad, params)
            ls = _ZoomLinesearch(counted, params, direction, value, grad)
            found = False
            while True:
                if found:
                    ls.zoom_into_interval()
                else:
                    ls.search_interval()
                ls.try_safe_step()
                flags = torch.stack([
                    (ls.done | ls.failed).to(value.dtype),
                    ls.interval_found.to(value.dtype), value.detach(),
                    gnorm]).cpu()
                stats.host_reads += 1
                stop, found, value_h, gnorm_h = flags.tolist()
                if stop:
                    break
            params = constrain(params + ls.stepsize * direction)
            it += 1
            stats.iterations = it
            if history is not None:
                history.append(value_h)
        if on_chunk is not None:
            on_chunk(params, it, value_h)
        if it < limit or not math.isfinite(value_h):
            break   # converged (or failed) inside the chunk
    return params, value_h, it, gnorm_h
