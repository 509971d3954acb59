"""Equipartition: split a 1-D space into intervals of approximately equal error.

Re-implementation of the reference algorithm (src/ecckd/equipartition.h:64-198,
src/ecckd/equipartition.cpp:161-805): iterative cumulative-error
redistribution with line search, pairwise refinement ("shuffle") fallback,
and secant bound searches for the target-error mode.

The outer control loop is inherently sequential and cheap (dozens of
iterations) and stays in host Python with float64 arithmetic; all interval
cost evaluations of a sweep are delegated to :meth:`calc_error_many`, which a
subclass implements as ONE batched jitted TPU kernel (replacing the OpenMP
``parallel for`` at equipartition.h:100-104).

The port's own copy of ``ecckd_tpu/partition/equipartition.py``: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import enum
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import logs


class EpStatus(enum.Enum):
    SUCCESS = 0
    MAX_ITERATIONS_REACHED = 1
    FAILED_TO_CONVERGE = 2
    RESOLUTION_LIMIT_REACHED = 3
    NO_PROGRESS = 4
    FAILURE = 5
    INPUT_ERROR = 6

    def describe(self) -> str:
        return {
            EpStatus.SUCCESS: "Converged",
            EpStatus.MAX_ITERATIONS_REACHED: "Maximum iterations reached",
            EpStatus.RESOLUTION_LIMIT_REACHED: "Resolution limit reached",
            EpStatus.FAILED_TO_CONVERGE: "Failed to converge",
            EpStatus.NO_PROGRESS: "No progress made",
            EpStatus.FAILURE: "Unspecified failure",
            EpStatus.INPUT_ERROR: "Input error",
        }[self]


def ep_stats(error: np.ndarray):
    """Mean, chi2, fractional std and fractional range of interval errors."""
    error = np.asarray(error, dtype=np.float64)
    mean = error.mean()
    chi2 = float(np.sum((error - mean) ** 2))
    frac_std = math.sqrt(chi2 / error.size) / mean if mean != 0 else np.inf
    frac_range = (error.max() - error.min()) / mean if mean != 0 else np.inf
    return float(mean), chi2, frac_std, frac_range


class Equipartition:
    """Base class; subclasses must implement :meth:`calc_error` and should
    override :meth:`calc_error_many` with a batched evaluation."""

    def __init__(self):
        self.next_bound_error_tolerance = 0.05
        self.partition_tolerance = 0.05
        self.resolution = 0.0
        self.next_bound_max_iterations = 20
        self.partition_max_iterations = 20
        self.line_search_max_iterations = 10
        self.verbose = 0
        self.cubic_interpolation = False
        self.minimize_frac_range = True
        self._errors_up_to_date = False

    # -- interface -------------------------------------------------------
    def calc_error(self, bound1: float, bound2: float) -> float:
        raise NotImplementedError

    def calc_error_many(self, bounds_pairs: Sequence[Tuple[float, float]]
                        ) -> np.ndarray:
        """Evaluate many intervals; default loops, subclasses batch."""
        return np.array([self.calc_error(b1, b2) for b1, b2 in bounds_pairs],
                        dtype=np.float64)

    def calc_error_all(self, bounds: np.ndarray) -> np.ndarray:
        pairs = list(zip(bounds[:-1], bounds[1:]))
        return self.calc_error_many(pairs)

    # -- setters matching the reference API ------------------------------
    def set_partition_max_iterations(self, n): self.partition_max_iterations = n
    def set_line_search_max_iterations(self, n): self.line_search_max_iterations = n
    def set_partition_tolerance(self, t): self.partition_tolerance = t
    def set_cubic_interpolation(self, c): self.cubic_interpolation = c
    def set_resolution(self, r): self.resolution = r
    def set_verbose(self, v): self.verbose = int(v)
    def set_minimize_frac_range(self, m): self.minimize_frac_range = m

    def invalidate(self):
        """Mark any cached per-interval errors stale, forcing the next
        partition call to recompute them.  Callers that overwrite the
        bounds/error arrays from outside (e.g. find_g_points' sqrt-spaced
        re-initialization when min/max g-point limits kick in,
        find_g_points.cpp:1221-1248) must call this before re-running
        ``equipartition_n``."""
        self._errors_up_to_date = False

    # -- cost ------------------------------------------------------------
    def cost_function(self, error: np.ndarray) -> float:
        mean, chi2, frac_std, frac_range = ep_stats(error)
        return frac_range if self.minimize_frac_range else frac_std

    # -- line search (ref equipartition.cpp:161-199) ---------------------
    def _line_search(self, bounds: np.ndarray, newbounds: np.ndarray,
                     error: np.ndarray) -> Tuple[EpStatus, np.ndarray]:
        if not self._errors_up_to_date:
            error[:] = self.calc_error_all(bounds)
            self._errors_up_to_date = True
        start_cost = self.cost_function(error)
        nb = 0.5 * (newbounds + bounds)
        for _ in range(self.line_search_max_iterations):
            err = self.calc_error_all(nb)
            self._errors_up_to_date = False
            if self.cost_function(err) < start_cost:
                bounds[:] = nb
                error[:] = err
                self._errors_up_to_date = True
                return EpStatus.SUCCESS, bounds
            nb = 0.5 * (nb + bounds)
        return EpStatus.NO_PROGRESS, bounds

    # -- pairwise refinement (ref equipartition.cpp:205-330) -------------
    def _equipartition_2(self, bounds: np.ndarray, error: np.ndarray
                         ) -> EpStatus:
        """Optimize bounds[1] of a 2-interval system in place."""
        if not self._errors_up_to_date:
            error[:] = self.calc_error_all(bounds)
            self._errors_up_to_date = True

        bound_left, bound_right = bounds[0], bounds[2]
        denom = error[0] + error[1]
        frac_error = 0.5 * abs(error[1] - error[0]) / denom if denom else 0.0
        frac_error_orig = frac_error
        local_tol = self.partition_tolerance
        newbounds = bounds.copy()
        newerror = error.copy()
        iterations_remaining = self.partition_max_iterations

        def _finite_or(mid, lo, hi):
            """Secant steps divide by an interval error, which can be
            EXACTLY zero on degenerate (constant-metric) intervals.  The
            reference performs the IEEE division and then feeds the
            inf/NaN bound through an int cast (equipartition.cpp:228-231
            — undefined behavior in C++); this port deviates deliberately:
            a non-finite step falls back to bisecting the current bracket,
            which is well-defined and converges."""
            if np.isfinite(mid):
                return mid
            return 0.5 * (lo + hi)

        ediff_left = ediff_right = 0.0
        if error[0] > error[1]:
            bound_right = bounds[1]
            ediff_right = error[1] - error[0]
            while iterations_remaining:
                newbounds[1] = _finite_or(
                    (-ediff_right * newbounds[0]
                     + (newerror[0] + ediff_right) * newbounds[1])
                    / newerror[0] if newerror[0] else np.inf,
                    newbounds[0], newbounds[1])
                newerror[:] = self.calc_error_all(newbounds)
                if newerror[0] < newerror[1]:
                    bound_left = newbounds[1]
                    ediff_left = newerror[1] - newerror[0]
                    break
                ediff_right = newerror[1] - newerror[0]
                iterations_remaining -= 1
        else:
            bound_left = bounds[1]
            ediff_left = error[1] - error[0]
            while iterations_remaining:
                newbounds[1] = _finite_or(
                    (ediff_left * newbounds[2]
                     + (newerror[1] - ediff_left) * newbounds[1])
                    / newerror[1] if newerror[1] else np.inf,
                    newbounds[1], newbounds[2])
                newerror[:] = self.calc_error_all(newbounds)
                if newerror[0] > newerror[1]:
                    bound_right = newbounds[1]
                    ediff_right = newerror[1] - newerror[0]
                    break
                ediff_left = newerror[1] - newerror[0]
                iterations_remaining -= 1

        no_progress = False
        prev_frac_error = frac_error

        while iterations_remaining:
            if no_progress:
                newbounds[1] = 0.5 * (bound_right + bound_left)
            else:
                d = ediff_left - ediff_right
                newbounds[1] = _finite_or(
                    (ediff_left * bound_right - ediff_right * bound_left)
                    / d if d else np.inf, bound_left, bound_right)
            newerror[:] = self.calc_error_all(newbounds)
            ediff = newerror[1] - newerror[0]
            denom = newerror[0] + newerror[1]
            frac_error = 0.5 * abs(ediff) / denom if denom else 0.0
            if frac_error < local_tol and frac_error < frac_error_orig:
                bounds[1] = newbounds[1]
                error[:] = newerror
                self._errors_up_to_date = True
                return EpStatus.SUCCESS
            elif frac_error == prev_frac_error:
                if no_progress:
                    break
                no_progress = True
            if ediff < 0:
                ediff_right = ediff
                bound_right = newbounds[1]
            else:
                ediff_left = ediff
                bound_left = newbounds[1]
            prev_frac_error = frac_error
            iterations_remaining -= 1

        if frac_error < frac_error_orig:
            bounds[1] = newbounds[1]
            error[:] = newerror
            self._errors_up_to_date = True
            if bound_right - bound_left < self.resolution:
                return EpStatus.RESOLUTION_LIMIT_REACHED
            if not iterations_remaining:
                return EpStatus.MAX_ITERATIONS_REACHED
            return EpStatus.SUCCESS
        return EpStatus.NO_PROGRESS

    # -- equipartition_n (ref equipartition.cpp:336-566) -----------------
    def equipartition_n(self, bounds: np.ndarray, error: np.ndarray
                        ) -> EpStatus:
        """Repartition interior bounds in place so interval errors equalize."""
        ni = len(bounds) - 1
        if ni == 2:
            return self._equipartition_2(bounds, error)

        if self.verbose:
            logs.log(f"  Equipartitioning into {ni} intervals, "
                     f"partition tolerance {self.partition_tolerance}")

        istatus = EpStatus.SUCCESS
        n_shuffle_remaining = self.partition_max_iterations // 2

        if np.any(bounds[1:] <= bounds[:-1]):
            return EpStatus.INPUT_ERROR

        b = bounds.astype(np.float64).copy()
        iterations_remaining = self.partition_max_iterations

        while iterations_remaining > 0:
            if not self._errors_up_to_date:
                error[:] = self.calc_error_all(b)
                self._errors_up_to_date = True

            cost = self.cost_function(error)
            if self.verbose:
                logs.log(f"    {iterations_remaining} iterations remaining, "
                         f"cost function = {cost:.5g}")
            if cost < self.partition_tolerance:
                break

            cum_error = np.concatenate([[0.0], np.cumsum(error)])
            target_error = cum_error[ni] / ni

            newbounds = b.copy()
            iold = 0
            for inew in range(1, ni):
                target = target_error * inew
                while cum_error[iold + 1] < target:
                    iold += 1
                if self.cubic_interpolation:
                    u = ((target - cum_error[iold])
                         / (cum_error[iold + 1] - cum_error[iold]))
                    u2, u3 = u * u, u ** 3
                    grad = ((b[iold + 1] - b[iold])
                            / (cum_error[iold + 1] - cum_error[iold]))
                    if iold == 0:
                        grad0 = grad
                    else:
                        grad0 = ((b[iold + 1] - b[iold - 1])
                                 / (cum_error[iold + 1] - cum_error[iold - 1]))
                    if iold == ni - 1:
                        grad1 = grad
                    else:
                        grad1 = ((b[iold + 2] - b[iold])
                                 / (cum_error[iold + 2] - cum_error[iold]))
                    newbounds[inew] = ((2 * u3 - 3 * u2 + 1) * b[iold]
                                       + (u3 - 2 * u2 + u) * grad0
                                       + (-2 * u3 + 3 * u2) * b[iold + 1]
                                       + (u3 - u2) * grad1)
                else:
                    newbounds[inew] = (
                        ((cum_error[iold + 1] - target) * b[iold]
                         + (target - cum_error[iold]) * b[iold + 1])
                        / (cum_error[iold + 1] - cum_error[iold]))

            if self.resolution > 0.0:
                if not np.any(np.abs(newbounds[1:ni] - b[1:ni])
                              > self.resolution):
                    bounds[:] = b
                    return EpStatus.RESOLUTION_LIMIT_REACHED

            ls_status, b = self._line_search(b, newbounds, error)
            if ls_status != EpStatus.SUCCESS:
                istatus = EpStatus.FAILED_TO_CONVERGE
                nnoprogress = 0
                if ni > 2 and n_shuffle_remaining > 0:
                    if self.verbose:
                        logs.log(f"    Shuffle ({n_shuffle_remaining} "
                                 "shuffles remaining)")
                    if n_shuffle_remaining % 2:
                        order = list(range(ni - 1)) + list(range(ni - 3, -1, -1))
                    else:
                        order = (list(range(ni - 2, -1, -1))
                                 + list(range(1, ni - 1)))
                    for ii in order:
                        st = self._equipartition_2(b[ii:ii + 3],
                                                   error[ii:ii + 2])
                        if st == EpStatus.NO_PROGRESS:
                            nnoprogress += 1
                    n_shuffle_remaining -= 1

                    if self.cost_function(error) < self.partition_tolerance:
                        istatus = EpStatus.SUCCESS
                        break
                    elif nnoprogress >= ni * 2 - 3:
                        istatus = EpStatus.FAILED_TO_CONVERGE
                    else:
                        istatus = EpStatus.SUCCESS
                if istatus != EpStatus.SUCCESS:
                    break
            iterations_remaining -= 1

        bounds[:] = b
        if iterations_remaining == 0:
            istatus = EpStatus.MAX_ITERATIONS_REACHED
        self._errors_up_to_date = False
        return istatus

    # -- equipartition_e (ref equipartition.cpp:575-634) -----------------
    def equipartition_e(self, target_error: float, bound0: float,
                        boundn: float
                        ) -> Tuple[EpStatus, np.ndarray, np.ndarray]:
        """Find the number of intervals for a target per-interval error.

        Returns (status, bounds, error).
        """
        if boundn <= bound0:
            return EpStatus.INPUT_ERROR, np.array([bound0, boundn]), np.array([])

        if self.verbose:
            logs.log("  Working out how many intervals are needed for "
                     f"target error of {target_error}")

        upper_error = -1.0
        upper_bound, upper_error = self._next_bound_below(
            target_error, bound0, boundn, 0.05 * bound0 + 0.95 * boundn,
            upper_error)
        if upper_bound == bound0:
            bounds = np.array([bound0, boundn], dtype=np.float64)
            error = np.array([upper_error], dtype=np.float64)
            return EpStatus.SUCCESS, bounds, error

        bounds_l: List[float] = [bound0]
        error_l: List[float] = []
        iint = 0
        while bounds_l[iint] < upper_bound:
            err = -1.0
            nb, err = self._next_bound_above(
                target_error, bounds_l[iint], upper_bound,
                0.25 * bounds_l[iint] + 0.75 * upper_bound, err)
            error_l.append(err)
            bounds_l.append(nb)
            iint += 1
        error_l.append(upper_error)
        bounds_l.append(boundn)

        bounds = np.array(bounds_l, dtype=np.float64)
        error = np.array(error_l, dtype=np.float64)
        if self.verbose:
            logs.log(f"  {len(error)} intervals needed")

        self._errors_up_to_date = True
        status = self.equipartition_n(bounds, error)
        return status, bounds, error

    # -- secant bound searches (ref equipartition.cpp:637-805) -----------
    def _next_bound_below(self, target_error, bound0, bound2, bound1_test,
                          error_test_value):
        max_error = target_error
        min_error = target_error * (1.0 - self.next_bound_error_tolerance)
        bound1_low, bound1_high = bound0, bound2
        error_low, error_high = -1.0, 0.0
        iterations_remaining = self.next_bound_max_iterations

        if error_test_value < 0.0:
            error_test = self.calc_error(bound1_test, bound2)
        else:
            error_test = error_test_value

        while (iterations_remaining > 0
               and (error_test > max_error or error_test < min_error)):
            if error_test > target_error:
                bound1_low, error_low = bound1_test, error_test
            else:
                bound1_high, error_high = bound1_test, error_test
            if bound1_low == bound1_high:
                break
            if error_low > 0.0:
                bound1_test = (((target_error - error_high) * bound1_low
                                + (error_low - target_error) * bound1_high)
                               / (error_low - error_high))
                if error_high == 0.0:
                    bound1_test = 0.5 * (bound1_test + bound1_high)
                elif error_test < min_error and error_low > 2.0 * max_error:
                    bound1_test = 0.75 * bound1_test + 0.25 * bound1_low
            else:
                bound1_test = max(
                    bound1_low,
                    bound1_high - 0.5 * target_error * (bound2 - bound1_high)
                    / error_high)
            error_test = self.calc_error(bound1_test, bound2)
            iterations_remaining -= 1
        return bound1_test, error_test

    def _next_bound_above(self, target_error, bound1, boundn, bound2_test,
                          error_test_value):
        max_error = target_error
        min_error = target_error * (1.0 - self.next_bound_error_tolerance)
        bound2_low, bound2_high = bound1, boundn
        error_low, error_high = 0.0, -1.0
        iterations_remaining = self.next_bound_max_iterations

        if error_test_value < 0.0:
            error_test = self.calc_error(bound1, bound2_test)
        else:
            error_test = error_test_value

        while (iterations_remaining > 0
               and (error_test > max_error or error_test < min_error)):
            if error_test > target_error:
                bound2_high, error_high = bound2_test, error_test
            else:
                bound2_low, error_low = bound2_test, error_test
            if bound2_low == bound2_high:
                break
            if error_high > 0.0:
                bound2_test = (((target_error - error_low) * bound2_high
                                + (error_high - target_error) * bound2_low)
                               / (error_high - error_low))
                if error_low == 0.0:
                    bound2_test = 0.5 * (bound2_test + bound2_low)
                elif error_test < min_error and error_low > 2.0 * max_error:
                    bound2_test = 0.75 * bound2_test + 0.25 * bound2_high
            else:
                bound2_test = max(
                    bound2_high,
                    bound2_high - 0.5 * target_error * (bound2_low - bound1)
                    / error_low)
            error_test = self.calc_error(bound1, bound2_test)
            iterations_remaining -= 1
        return bound2_test, error_test
