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

The loop is a state machine whose step is one cost evaluation and the
advance of the state (:class:`_Machine`), the counterpart of one pass of
JAX's jitted ``lax.while_loop`` body at the granularity of an evaluation.
The step is the same tensor code whether it starts an iteration (the
gradient, the two-loop recursion over all 30 memory slots in optax's order,
a fresh line search) or takes a line-search step (both of optax's branches,
searching for an interval and zooming into it, computed, one chosen by
``where`` on the device flag): which one applies is a device mask, so
Python never branches on a device value inside it.  JAX's ``cond``
(``ecckd_tpu/optimize/solver.py:229-233``) becomes a freeze mask with the
chunk's iteration limit a device tensor: a frozen step evaluates at the
parameters and changes no state.

So the host may run ``STEPS_PER_READ`` steps blindly and read one packed
tensor (iteration, frozen, value, gradient norm, evaluations) after them:
about 2.1 / ``STEPS_PER_READ`` reads an iteration.  On the card the step is
one CUDA graph (:mod:`.graphs`), replayed ``STEPS_PER_READ`` times between
reads; on the CPU the same state machine runs eagerly.  The steps after
the state froze inside a batch are evaluations that change nothing, counted
apart in :class:`Stats` as masked.
"""

from __future__ import annotations

import dataclasses
import math
import time
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

#: Steps between the host's reads of the state.  A read waits for the
#: card; the steps after the state froze inside a batch are masked
#: evaluations.  At 2.13 evaluations an iteration (PERF.md §6), 16 steps
#: give ~0.13 reads an iteration and waste at most 15 evaluations at the
#: end of a chunk of ~213, under 7%.
STEPS_PER_READ = 16


@dataclasses.dataclass
class Stats:
    iterations: int = 0
    evaluations: int = 0          # evaluations that advanced the state
    masked_evaluations: int = 0   # evaluations of a frozen state
    host_reads: int = 0           # packed state reads
    capture_seconds: float = 0.0  # the graph's warm-up and capture


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


class _Memory:
    """``scale_by_lbfgs``'s state and update: the last ``m`` differences of
    parameters and gradients, their weights, the previous parameters and
    gradient, and the count of updates, all on the device."""

    def __init__(self, like, m=MEMORY_SIZE):
        self.m = m
        self.count = torch.zeros((), dtype=torch.int64, device=like.device)
        self.slots = torch.arange(m, device=like.device)
        self.params = torch.zeros_like(like)
        self.updates = torch.zeros_like(like)
        self.dw = torch.zeros((m,) + like.shape, dtype=like.dtype,
                              device=like.device)
        self.du = torch.zeros_like(self.dw)
        self.rho = torch.zeros(m, dtype=like.dtype, device=like.device)

    def precondition(self, updates, params, apply):
        """P_k u_k, updating the memory with the fresh parameters and
        gradient first, as optax does; the memory changes only where the
        device flag ``apply`` is set."""
        first = self.count == 0
        prev = torch.remainder(self.count - 1, self.m).reshape(1)
        dp = params - self.params
        dg = updates - self.updates
        vdot = torch.dot(dg, dp)
        den = torch.dot(dg, dg)
        # the slot of count 0 holds zeros, which optax writes too
        dp = torch.where(first, 0.0, dp)
        dg = torch.where(first, 0.0, dg)
        rho = torch.where(first | (vdot == 0.0), 0.0, 1.0 / vdot)
        scale = torch.where(
            first, torch.clamp(1.0 / torch.sqrt(torch.dot(updates, updates)),
                               max=1.0),
            torch.where(den > 0.0, vdot / den, 1.0))
        for buf, new in ((self.dw, dp), (self.du, dg), (self.rho, rho)):
            old = buf.index_select(0, prev)[0]
            buf.index_copy_(0, prev, torch.where(apply, new, old)[None])
        # The two loops over all m slots from the oldest (optax's order;
        # a slot never written holds zeros and weight zero)
        order = torch.remainder(self.count + self.slots, self.m)
        dw = self.dw.index_select(0, order)
        du = self.du.index_select(0, order)
        rhos = self.rho.index_select(0, order)
        vec = updates
        alphas = [None] * self.m
        for i in reversed(range(self.m)):
            alpha = rhos[i] * torch.dot(dw[i], vec)
            vec = vec + (-alpha) * du[i]
            alphas[i] = alpha
        vec = scale * vec
        for i in range(self.m):
            beta = rhos[i] * torch.dot(du[i], vec)
            vec = vec + (alphas[i] - beta) * dw[i]
        self.count.copy_(torch.where(apply, self.count + 1, self.count))
        self.params.copy_(torch.where(apply, params, self.params))
        self.updates.copy_(torch.where(apply, updates, self.updates))
        return vec


# optax's zoom line-search state carried from one evaluation to the next
_LS_FIELDS = ("stepsize", "value", "slope", "value_init", "slope_init",
              "low", "value_low", "slope_low", "high", "value_high",
              "slope_high", "cubic_ref", "value_cubic_ref", "safe_stepsize",
              "safe_value")


class _Machine:
    """The projected L-BFGS as a state machine on the device.

    :meth:`step` evaluates the objective once, at ``self.x``, and
    :meth:`advance` moves the state by that evaluation and sets the next
    ``x``.  Every tensor of the state is allocated here and updated in
    place, so a CUDA graph of the step replays on it."""

    def __init__(self, x0, lo, hi, sentinel, gtol, max_iterations,
                 m=MEMORY_SIZE):
        dev, dtype = x0.device, x0.dtype
        self.x0, self.lo, self.hi, self.sentinel = x0, lo, hi, sentinel
        self.gtol = gtol
        scalar = lambda v: torch.full((), v, dtype=dtype, device=dev)
        count = lambda: torch.zeros((), dtype=torch.int64, device=dev)
        flag = lambda: torch.zeros((), dtype=torch.bool, device=dev)
        self.params = self.constrain(x0).clone()
        self.direction = torch.zeros_like(self.params)
        self.it, self.limit, self.evaluations = count(), count(), count()
        # JAX's carry: the value and gradient max-norm at the point the
        # last iteration started from
        self.value, self.gnorm = scalar(0.0), scalar(math.inf)
        self.history = torch.zeros(max_iterations + 1, dtype=dtype,
                                   device=dev)
        self.in_search = flag()       # a line search is under way
        self.memory = _Memory(self.params, m)
        self.ls = {k: scalar(0.0) for k in _LS_FIELDS}
        self.ls_count = count()
        self.found = flag()           # the line search has its interval
        # the next evaluation: its point, its step along the direction and
        # the zoom's interval test
        self.x = self.params.clone()
        self.trial = scalar(0.0)
        self.too_small = flag()

    def constrain(self, p):
        if self.lo is not None:
            p = torch.minimum(torch.maximum(p, self.lo), self.hi)
        return torch.where(self.sentinel, self.x0, p)

    def active(self):
        """JAX's ``cond``: the next iteration may start."""
        return ((self.it < self.limit) & (self.gnorm > self.gtol)
                & torch.isfinite(self.value))

    def frozen(self):
        return ~self.in_search & ~self.active()

    def status(self):
        """(iterations, frozen, value, gradient norm, evaluations) packed in
        one float64 tensor: what the host reads."""
        return torch.stack([self.it.to(torch.float64),
                            self.frozen().to(torch.float64),
                            self.value.to(torch.float64),
                            self.gnorm.to(torch.float64),
                            self.evaluations.to(torch.float64)])

    def state(self):
        """Every tensor of the state, by name (for checks of the bits)."""
        out = {k: getattr(self, k) for k in (
            "params", "direction", "it", "evaluations", "value", "gnorm",
            "history", "in_search", "ls_count", "found", "x", "trial",
            "too_small")}
        out.update({f"ls_{k}": v for k, v in self.ls.items()})
        out.update({f"memory_{k}": getattr(self.memory, k) for k in (
            "count", "params", "updates", "dw", "du", "rho")})
        return out

    def step(self, value_and_grad):
        value, grad = value_and_grad(self.x)
        self.advance(value, grad)

    def advance(self, value, grad):
        """Move the state by the evaluation ``(value, grad)`` at ``self.x``
        and set the next point."""
        ls = self.ls
        searching = self.in_search
        start = ~searching & self.active()
        self.evaluations.copy_(self.evaluations + (start | searching).long())

        # An iteration starts: the masked gradient, its norm, the direction
        # and a fresh line search (optax's init)
        g = torch.where(self.sentinel, 0.0, grad)
        gnorm = torch.max(torch.abs(g))
        direction = -1.0 * self.memory.precondition(g, self.params, start)
        slope0 = torch.dot(direction, g)
        zero = torch.zeros_like(value)
        fresh = dict(stepsize=zero, value=value, slope=slope0,
                     value_init=value, slope_init=slope0, low=zero,
                     value_low=value, slope_low=slope0, high=zero,
                     value_high=value, slope_high=slope0, cubic_ref=zero,
                     value_cubic_ref=value, safe_stepsize=zero,
                     safe_value=value)

        # A line-search step: the evaluation at params + trial * direction
        # taken by the branch the search is in
        trial = self.trial
        slope = torch.dot(grad, self.direction)
        de = _decrease_error(trial, value, slope, ls["value_init"],
                             ls["slope_init"])
        ce = _curvature_error(slope, ls["slope_init"])
        done = torch.maximum(de, ce) <= TOL
        at_cap = self.ls_count + 1 >= MAX_LINESEARCH_STEPS
        search = self._search_interval(trial, value, slope, de, done,
                                       at_cap)
        zoom = self._zoom_into_interval(trial, value, slope, de, done,
                                        at_cap)
        moved = {k: torch.where(self.found, zoom[k], search[k])
                 for k in _LS_FIELDS}
        found = self.found | search["found"]
        failed = torch.where(self.found, zoom["failed"], search["failed"])
        # optax's try_safe_step: where the search failed, the safe step if
        # any (or where the objective is outside its domain)
        use_safe = failed & ((moved["safe_stepsize"] > 0.0)
                             | torch.isinf(de))
        moved["stepsize"], moved["value"] = _where(
            use_safe, (moved["safe_stepsize"], moved["safe_value"]),
            (moved["stepsize"], moved["value"]))
        ends = searching & (done | failed)

        for k in _LS_FIELDS:
            ls[k].copy_(torch.where(start, fresh[k], torch.where(
                searching, moved[k], ls[k])))
        self.ls_count.copy_(torch.where(start, 0, torch.where(
            searching, self.ls_count + 1, self.ls_count)))
        self.found.copy_(~start & torch.where(searching, found, self.found))
        self.history.index_copy_(0, self.it.reshape(1), torch.where(
            start, value, self.history.index_select(0, self.it.reshape(1))
        [0])[None])
        self.value.copy_(torch.where(start, value, self.value))
        self.gnorm.copy_(torch.where(start, gnorm, self.gnorm))
        self.direction.copy_(torch.where(start, direction, self.direction))
        # The iteration ends with its line search: the projected update
        self.params.copy_(torch.where(ends, self.constrain(
            self.params + ls["stepsize"] * self.direction), self.params))
        self.it.copy_(self.it + ends.long())
        self.in_search.copy_(start | (searching & ~ends))
        self._point()

    def _search_interval(self, new_step, value, slope, de, done, at_cap):
        """optax's search for an interval, at the step ``new_step``."""
        ls = self.ls
        prev = (ls["stepsize"], ls["value"], ls["slope"])
        out = dict(ls)
        out["safe_stepsize"], out["safe_value"] = _where(
            de <= TOL, (new_step, value),
            (ls["safe_stepsize"], ls["safe_value"]))
        set_high = (de > 0.0) | ((value >= prev[1]) & (self.ls_count > 0))
        set_low = (slope >= 0.0) & ~set_high
        (out["low"], out["value_low"], out["slope_low"], out["high"],
         out["value_high"], out["slope_high"]) = _where(
            set_low, (new_step, value, slope) + prev,
            prev + (new_step, value, slope))
        out["found"] = set_high | set_low | done
        out["failed"] = ~done & at_cap
        out["stepsize"], out["value"], out["slope"] = new_step, value, slope
        out["cubic_ref"], out["value_cubic_ref"] = (out["low"],
                                                    out["value_low"])
        return out

    def _zoom_into_interval(self, middle, value, slope, de, done, at_cap):
        """optax's zoom into the interval, at the step ``middle`` chosen by
        :meth:`_point`."""
        ls = self.ls
        low, value_low, slope_low = (ls["low"], ls["value_low"],
                                     ls["slope_low"])
        high, value_high, slope_high = (ls["high"], ls["value_high"],
                                        ls["slope_high"])
        out = dict(ls)
        out["safe_stepsize"], out["safe_value"] = _where(
            (de <= TOL) & (value < ls["safe_value"]), (middle, value),
            (ls["safe_stepsize"], ls["safe_value"]))
        high_to_middle = (de > 0.0) | (value >= value_low)
        high_to_low = (slope * (high - low) >= 0.0) & ~high_to_middle
        low_to_middle = ~high_to_middle
        new_high = _where(high_to_middle, (middle, value, slope),
                          (high, value_high, slope_high))
        (out["high"], out["value_high"], out["slope_high"]) = _where(
            high_to_low, (low, value_low, slope_low), new_high)
        (out["low"], out["value_low"], out["slope_low"]) = _where(
            low_to_middle, (middle, value, slope),
            (low, value_low, slope_low))
        out["cubic_ref"], out["value_cubic_ref"] = _where(
            high_to_middle | high_to_low, (high, value_high),
            (low, value_low))
        out["failed"] = ((self.too_small & (out["safe_stepsize"] > 0.0))
                         | at_cap) & ~done
        out["stepsize"], out["value"], out["slope"] = middle, value, slope
        return out

    def _point(self):
        """The next evaluation: the parameters where an iteration starts,
        else the trial step of the search's branch along the direction."""
        ls = self.ls
        search_step = torch.where(self.ls_count == 0, 1.0,
                                  INCREASE_FACTOR * ls["stepsize"])
        low, high = ls["low"], ls["high"]
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        middle_cubic = _cubicmin(low, ls["value_low"], ls["slope_low"], high,
                                 ls["value_high"], ls["cubic_ref"],
                                 ls["value_cubic_ref"])
        use_cubic = ((middle_cubic > left + cubic_chk)
                     & (middle_cubic < right - cubic_chk))
        middle_quad = _quadmin(low, ls["value_low"], ls["slope_low"], high,
                               ls["value_high"])
        use_quad = use_cubic.logical_not() & (
            (middle_quad > left + quad_chk) & (middle_quad < right - quad_chk))
        use_bisection = use_cubic.logical_not() & use_quad.logical_not()
        middle = torch.where(use_cubic, middle_cubic, ls["cubic_ref"])
        middle = torch.where(use_quad, middle_quad, middle)
        middle = torch.where(use_bisection, (low + high) / 2.0, middle)
        trial = torch.where(self.found, middle, search_step)
        self.trial.copy_(trial)
        self.too_small.copy_(delta <= STEPSIZE_PRECISION)
        self.x.copy_(torch.where(self.in_search,
                                 self.params + trial * self.direction,
                                 self.params))


def _stepper(machine, value_and_grad, graph):
    """A callable that takes one step of ``machine``: eagerly (``graph``
    None), as one CUDA graph of the evaluation and the advance ("step";
    ``value_and_grad`` must be eager code that a graph can capture), or
    with the evaluation outside and the advance as a graph ("advance";
    ``value_and_grad`` may replay graphs of its own).  The graphs are
    captured with the machine frozen (its limit 0), so their warm-up calls
    change no state."""
    if graph is None:
        return lambda: machine.step(value_and_grad)
    from . import graphs
    if graph == "step":
        g, _ = graphs.capture(lambda: machine.step(value_and_grad),
                              machine.x.device)
        return g.replay
    if graph != "advance":
        raise ValueError(f"graph={graph!r} not understood")
    value = torch.zeros_like(machine.value)
    grad = torch.zeros_like(machine.x)
    g, _ = graphs.capture(lambda: machine.advance(value, grad),
                          machine.x.device)

    def step():
        v, gr = value_and_grad(machine.x)
        value.copy_(v)
        grad.copy_(gr)
        g.replay()
    return step


def minimize(value_and_grad: Callable, x0, lo, hi, sentinel,
             max_iterations: int, gtol: float, chunk: int = 100,
             on_chunk: Optional[Callable] = None,
             history: Optional[List[float]] = None, stats: Stats = None,
             graph: Optional[str] = None):
    """Projected L-BFGS from ``x0`` (a flat tensor on the device).

    ``value_and_grad(x)`` returns the value (0-d tensor) and gradient of
    the unprojected objective; ``lo``, ``hi`` are tensors of bounds (None:
    unbounded); ``sentinel`` a bool tensor of entries held at ``x0``.
    ``on_chunk(params, n_iter, value)`` is called at every chunk boundary
    (params a device tensor); ``history`` gets each iteration's value.
    ``graph``: None runs each step eagerly, "step" or "advance" replays it
    as a CUDA graph (:func:`_stepper`).  The host reads the state after
    every ``STEPS_PER_READ`` steps.
    Returns (params, value, n_iter, gradient max-norm): the value and
    norm at the parameters the last iteration started from, as JAX's."""
    stats = Stats() if stats is None else stats
    machine = _Machine(x0, lo, hi, sentinel, gtol, max_iterations)
    machine._point()
    t0 = time.perf_counter()
    step = _stepper(machine, value_and_grad, graph)
    stats.capture_seconds = time.perf_counter() - t0
    it, value_h, gnorm_h, evaluations, steps = 0, 0.0, math.inf, 0, 0
    while it < max_iterations:
        limit = min(it + chunk, max_iterations)
        machine.limit.fill_(limit)
        frozen = False
        while not frozen:
            for _ in range(STEPS_PER_READ):
                step()
            steps += STEPS_PER_READ
            packed = machine.status().cpu().tolist()
            stats.host_reads += 1
            it, frozen, value_h, gnorm_h, evaluations = packed
        it, evaluations = int(it), int(evaluations)
        stats.iterations = it
        stats.evaluations = evaluations
        stats.masked_evaluations = steps - evaluations
        if on_chunk is not None:
            on_chunk(machine.params, it, value_h)
        if it < limit or not math.isfinite(value_h):
            break   # converged (or failed) inside the chunk
    if history is not None:
        history.extend(machine.history[:it].cpu().tolist())
    return machine.params, value_h, it, gnorm_h
