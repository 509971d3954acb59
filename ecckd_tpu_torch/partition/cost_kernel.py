"""Batched candidate-interval cost kernels for the g-point search.

PyTorch counterpart of ``ecckd_tpu/partition/cost_kernel.py``
(ref CkdEquipartition::calc_error, find_g_points.cpp:206-426): one call
evaluates the heating-rate/flux cost of many non-overlapping candidate rank
intervals.  Per call the work is O(nwav x nlay) whatever the number of
intervals: kernel K3 reduces the fit operands and the truth rows over every
interval in one pass, and the sweep kernel (K1 for the longwave, K2 for the
shortwave) runs the flux recurrence once, each wavenumber carrying the
fitted od of its own interval, and sums the fluxes per interval.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..constants import HR_WEIGHT
from ..ops.average import (fit_parts_lw, fit_parts_sw, total_trans_fallback,
                           total_trans_fit_parts)
from ..ops.heating_rate import heating_rate
from ..ops.kernels.interval_stream import device_bounds
from ..ops.kernels.interval_sum import fused_interval_sum
from ..ops.kernels.sweep_lw import sweep_lw_intervals
from ..ops.kernels.sweep_sw import sweep_sw_intervals
from ..ops.segments import part_of
from .equipartition import Equipartition


def _pad_to_bucket(n: int) -> int:
    """Candidate count padded to a power of two (1, 2, 4, 8, ...), the
    JAX package's bucket sizes, so both packages reduce the same columns."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _cost_terms(layer_weight, flux_weight, hr_err, dn_err, up_err):
    """The two squared terms of the candidate cost per interval (ref
    calc_cost_function_lw.cpp:104-110): the layer-weighted squared
    heating-rate error (K/day), and the flux-weighted squared boundary-flux
    errors; the cost is the square root of their sum."""
    return (HR_WEIGHT * HR_WEIGHT
            * torch.sum(layer_weight[:, None] * hr_err * hr_err, dim=0),
            flux_weight * (dn_err * dn_err + up_err * up_err))


def _candidate_cost_from_fluxes(pressure_hl, layer_weight, flux_weight,
                                flux_dn, flux_up, hr_true,
                                fd_surf_true, fu_toa_true):
    """Scalar candidate cost per interval from broadband flux profiles."""
    hr_fit = heating_rate(pressure_hl, flux_dn, flux_up)
    hr2, flux2 = _cost_terms(layer_weight, flux_weight, hr_fit - hr_true,
                             flux_dn[-1] - fd_surf_true,
                             flux_up[0] - fu_toa_true)
    return torch.sqrt(hr2 + flux2)


def _truth_parts(hr, flux_dn_surf, flux_up_toa):
    return [part_of(hr), part_of(flux_dn_surf), part_of(flux_up_toa)]


def _as_bounds(i1, i2, device):
    return (torch.as_tensor(np.asarray(i1, np.int32), device=device),
            torch.as_tensor(np.asarray(i2, np.int32), device=device))


class _CandidateCostBase:
    """Binding checks, the partition map and the bucket contract shared by
    the LW and SW kernels; a subclass defines ``_kernel(i1, i2)`` and
    ``_truth_sets(i1, i2)``.

    Both kernels take two keywords besides their arrays: ``fit_limits``, a
    float dtype whose transmission clamp and range the interval fit takes
    in place of its own (:func:`~ecckd_tpu_torch.ops.average.fit_parts_lw`),
    and ``probe_log``, a list to which :meth:`costs` appends each call as
    (kernel, i1, i2, costs)."""

    def _bind(self, arrays, like):
        """Check that every array is a tensor of ``like``'s device and
        dtype and keep it as an attribute."""
        self.device = like.device
        self.dtype = like.dtype
        self.npoints = int(like.shape[-1])
        for name, a in arrays.items():
            if not isinstance(a, torch.Tensor):
                raise TypeError(f"{type(self).__name__}: {name} must be a "
                                "tensor")
            if a.device != self.device or a.dtype != self.dtype:
                raise ValueError(
                    f"{type(self).__name__}: {name} is {a.dtype} on "
                    f"{a.device}; all arrays must be {self.dtype} on "
                    f"{self.device}")
            setattr(self, name, a)
        self._ranks = torch.arange(self.npoints, dtype=torch.int32,
                                   device=self.device)

    def _device_seg_of_wav(self, i1):
        """Per-rank partition map from the sorted, front-padded lower
        bounds: the last interval with i1 <= rank carries each rank's
        fitted od (the device form of the JAX package's
        CkdEquipartition._seg_of_wav)."""
        seg = torch.searchsorted(i1, self._ranks, right=True,
                                 out_int32=True) - 1
        return torch.clamp(seg, min=0)

    def costs(self, i1: np.ndarray, i2: np.ndarray) -> np.ndarray:
        """Candidate costs (float64 numpy) for sorted, non-overlapping
        intervals.

        Bucket padding goes at the FRONT with [0, 0] intervals so the padded
        bounds stay sorted for the searchsorted partition map; padded
        columns are benign (single-point interval 0) and sliced off."""
        n = len(i1)
        nb = _pad_to_bucket(n)
        pad = nb - n
        i1p = np.zeros(nb, np.int32)
        i1p[pad:] = i1
        i2p = np.zeros(nb, np.int32)
        i2p[pad:] = i2
        out = self._kernel(*device_bounds(i1p, i2p, self.device))
        out = out.cpu().numpy()[pad:].astype(np.float64)
        if self.probe_log is not None:
            self.probe_log.append((self, np.array(i1), np.array(i2), out))
        return out

    def zero_fit_costs(self, i1: np.ndarray, i2: np.ndarray) -> np.ndarray:
        """Per interval, the cost (float64 numpy) of a fit whose fluxes
        are all zero: the scale of the fluxes whose differences make up
        :meth:`costs`, averaged over the same runs."""
        sets = self._truth_sets(*_as_bounds(i1, i2, self.device))
        cost = 0.0
        for hr, fd, fu in sets:
            cost = cost + torch.sqrt(sum(_cost_terms(
                self.layer_weight, self.flux_weight, hr, fd, fu))) / len(sets)
        return cost.cpu().numpy().astype(np.float64)


class CandidateCostLw(_CandidateCostBase):
    """LW candidate cost over a band of rank-ordered wavenumbers.

    The arrays are bound once, as tensors on one device and of one float
    dtype (:func:`ecckd_tpu_torch.convert.lw_band_state` builds them);
    :meth:`costs` evaluates a batch of intervals.  Mirrors
    CkdEquipartition::init_lw (find_g_points.cpp:209-238).
    """

    def __init__(self, averaging_method: str, flux_weight: float,
                 layer_weight, pressure_hl, surf_emissivity, surf_planck,
                 flux_dn_surf, flux_up_toa, planck_hl, bg_od, metric, hr,
                 fit_limits=None, probe_log=None):
        self.averaging_method = averaging_method
        self.flux_weight = float(flux_weight)
        self.probe_log = probe_log
        self._bind(dict(layer_weight=layer_weight, pressure_hl=pressure_hl,
                        surf_emissivity=surf_emissivity,
                        surf_planck=surf_planck, flux_dn_surf=flux_dn_surf,
                        flux_up_toa=flux_up_toa, planck_hl=planck_hl,
                        bg_od=bg_od, metric=metric, hr=hr), metric)
        self.nlay = hr.shape[0]
        # The fit operands never change between probes, so the parts are
        # built once; fit and truth rows share one K3 pass per call.
        parts, rows, finish = fit_parts_lw(averaging_method, planck_hl,
                                           metric, fit_limits)
        self._parts = parts + _truth_parts(hr, flux_dn_surf, flux_up_toa)
        self._fit_rows = rows
        self._fit_finish = finish

    def _truth_of(self, sums):
        """(hr (nlay, nseg), flux_dn_surf, flux_up_toa) of the truth
        rows in the sums of one K3 launch."""
        rows, nlay = self._fit_rows, self.nlay
        return (sums[rows:rows + nlay], sums[rows + nlay],
                sums[rows + nlay + 1])

    def _truth_sets(self, i1, i2):
        return [self._truth_of(fused_interval_sum(
            self._parts, self.npoints, i1, i2, dtype=self.dtype))]

    def _kernel(self, i1, i2):
        seg_of_wav = self._device_seg_of_wav(i1)
        sums = fused_interval_sum(self._parts, self.npoints, i1, i2,
                                  dtype=self.dtype)
        od_fit = self._fit_finish(sums[:self._fit_rows], i1, i2)
        flux_dn, flux_up = sweep_lw_intervals(
            self.planck_hl, self.bg_od, od_fit.contiguous(), seg_of_wav,
            self.surf_emissivity, self.surf_planck, i1, i2)
        return _candidate_cost_from_fluxes(
            self.pressure_hl, self.layer_weight, self.flux_weight,
            flux_dn, flux_up, *self._truth_of(sums))


class CandidateCostSw(_CandidateCostBase):
    """SW candidate cost over a band of rank-ordered wavenumbers (ref
    CkdEquipartition::init_sw and init_sw_extras,
    find_g_points.cpp:240-296).

    ``surf_albedo`` is a float (one band) or an (nwav,) tensor; the sweep
    runs the reflected beam only where some albedo is positive.  With the
    total-transmission method, ``extras`` holds the truth of the runs with
    the gas's od scaled by ``min_scaling`` and ``max_scaling`` (tensors
    ``hr_low``, ``flux_dn_surf_low``, ``flux_up_toa_low`` and the ``_high``
    three) and the two floats; the cost of an interval is the mean of the
    two scaled costs (find_g_points.cpp:340-394).
    :func:`ecckd_tpu_torch.convert.sw_band_state` builds the arguments.
    """

    def __init__(self, averaging_method: str, flux_weight: float,
                 layer_weight, cos_sza, pressure_hl, ssi, surf_albedo,
                 flux_dn_surf, flux_up_toa, bg_od, metric, hr, extras=None,
                 fit_limits=None, probe_log=None):
        self.averaging_method = averaging_method
        self.flux_weight = float(flux_weight)
        self.probe_log = probe_log
        self.cos_sza = float(cos_sza)
        arrays = dict(layer_weight=layer_weight, pressure_hl=pressure_hl,
                      ssi=ssi, flux_dn_surf=flux_dn_surf,
                      flux_up_toa=flux_up_toa, bg_od=bg_od, metric=metric,
                      hr=hr)
        if isinstance(surf_albedo, torch.Tensor) and surf_albedo.ndim > 0:
            arrays["surf_albedo"] = surf_albedo
        else:
            arrays["surf_albedo"] = torch.full_like(ssi, float(surf_albedo))
        total_trans = averaging_method == "total-transmission"
        if total_trans:
            if extras is None:
                raise ValueError("CandidateCostSw: total-transmission needs "
                                 "extras")
            self.min_scaling = float(extras["min_scaling"])
            self.max_scaling = float(extras["max_scaling"])
            arrays.update({f"{v}_{tag}": extras[f"{v}_{tag}"]
                           for tag in ("low", "high")
                           for v in ("hr", "flux_dn_surf", "flux_up_toa")})
        self._bind(arrays, metric)
        self.with_upwelling = bool(torch.any(self.surf_albedo > 0.0))
        self.nlay = hr.shape[0]
        # Fit and truth rows share one K3 pass per call; the truth is that
        # of the two scaled runs for total-transmission.
        if total_trans:
            parts, rows, finish = total_trans_fit_parts(ssi, bg_od, metric,
                                                        fit_limits)
            truth = [_truth_parts(self.hr_low, self.flux_dn_surf_low,
                                  self.flux_up_toa_low),
                     _truth_parts(self.hr_high, self.flux_dn_surf_high,
                                  self.flux_up_toa_high)]
        else:
            parts, rows, finish = fit_parts_sw(averaging_method, ssi, metric,
                                               fit_limits)
            truth = []
        self._fit_parts = parts
        self._truth = truth + [_truth_parts(hr, flux_dn_surf, flux_up_toa)]
        self._fit_rows = rows
        self._fit_finish = finish

    def _sums(self, i1, i2, ntruth):
        """Fitted od (nlay, nseg) and the first ``ntruth`` truth sets, each
        (hr (nlay, nseg), flux_dn_surf (nseg,), flux_up_toa (nseg,)), from
        one K3 launch."""
        nlay = self.nlay
        truth = self._truth[:ntruth]
        sums = fused_interval_sum(
            self._fit_parts + [p for t in truth for p in t], self.npoints,
            i1, i2, dtype=self.dtype)
        rows = self._fit_rows
        od_fit = self._fit_finish(sums[:rows], i1, i2)
        sets = []
        for k in range(len(truth)):
            t = sums[rows + k * (nlay + 2):rows + (k + 1) * (nlay + 2)]
            sets.append((t[:nlay], t[nlay], t[nlay + 1]))
        return od_fit, sets

    def _truth_sets(self, i1, i2):
        return self._sums(i1, i2, len(self._runs()))[1]

    def linear_fallback(self, i1: np.ndarray, i2: np.ndarray) -> np.ndarray:
        """Per interval, whether the total-transmission fit falls back to
        the linear fit (some level flux of the interval is not positive);
        False for every other method."""
        t1, t2 = _as_bounds(i1, i2, self.device)
        if self.averaging_method != "total-transmission":
            return np.zeros(len(t1), bool)
        sums = fused_interval_sum(self._fit_parts, self.npoints, t1, t2,
                                  dtype=self.dtype)
        return total_trans_fallback(sums, self.nlay).cpu().numpy()

    def _runs(self):
        """(tag, od scaling) of the runs whose costs make up a probe's."""
        if self.averaging_method == "total-transmission":
            return (("LOW", self.min_scaling), ("HIGH", self.max_scaling))
        return (("MID", 1.0),)

    def _cost_with(self, od_fit, seg_of_wav, i1, i2, truth,
                   want_components=False):
        hr_true, fd_surf_true, fu_toa_true = truth
        flux_dn, flux_up = sweep_sw_intervals(
            self.ssi, self.bg_od, od_fit.contiguous(), seg_of_wav, i1, i2,
            self.cos_sza, self.surf_albedo, self.with_upwelling)
        # The SW heating rate uses downwelling only
        # (calc_cost_function_sw.cpp:93)
        hr_fit = heating_rate(self.pressure_hl, flux_dn)
        cf_hr2, cf_flux2 = _cost_terms(
            self.layer_weight, self.flux_weight, hr_fit - hr_true,
            flux_dn[-1] - fd_surf_true, flux_up[0] - fu_toa_true)
        cost = torch.sqrt(cf_hr2 + cf_flux2)
        if not want_components:
            return cost
        # What calc_cost_function_sw.cpp:93-105 dumps under debug_partition
        return dict(flux_dn_surf_true=fd_surf_true,
                    flux_dn_surf_fit=flux_dn[-1], flux_up_toa_true=fu_toa_true,
                    flux_up_toa_fit=flux_up[0], hr_true=hr_true,
                    hr_fit=hr_fit, cf_hr=torch.sqrt(cf_hr2),
                    cf_flux=torch.sqrt(cf_flux2))

    def _kernel(self, i1, i2):
        seg_of_wav = self._device_seg_of_wav(i1)
        runs = self._runs()
        od_fit, truth = self._sums(i1, i2, len(runs))
        costs = [self._cost_with(od_fit * scale, seg_of_wav, i1, i2, t)
                 for (_, scale), t in zip(runs, truth)]
        if len(costs) == 1:
            return costs[0]
        return 0.5 * (costs[0] + costs[1])

    def components(self, i1: np.ndarray, i2: np.ndarray):
        """Per-interval cost components for ``debug_partition``, as
        ``{tag: {name: float64 numpy array}}``.

        The tag is MID for a plain method; total-transmission gives LOW
        and HIGH, the scaled runs whose costs are averaged, and MID, the
        unscaled fit against the main truth (find_g_points.cpp:346-375)."""
        i1, i2 = _as_bounds(i1, i2, self.device)
        seg_of_wav = self._device_seg_of_wav(i1)
        runs = self._runs()
        if len(runs) > 1:
            runs = runs + (("MID", 1.0),)
        od_fit, truth = self._sums(i1, i2, len(runs))
        out = {}
        for (tag, scale), t in zip(runs, truth):
            comps = self._cost_with(od_fit * scale, seg_of_wav, i1, i2, t,
                                    want_components=True)
            out[tag] = {k: v.cpu().numpy().astype(np.float64)
                        for k, v in comps.items()}
        return out


class CkdEquipartition(Equipartition):
    """Equipartition search bound to a candidate-cost kernel.

    Index mapping follows the reference exactly: a bound b in [0, 1] maps
    to lower index ceil(b*(n-1)) / upper index floor(b*(n-1))
    (find_g_points.cpp:282-287).
    """

    def __init__(self, kernel):
        super().__init__()
        self.kernel = kernel
        self.npoints = kernel.npoints
        self.total_comp_cost = 0.0
        self.set_resolution(1.0 / self.npoints)

    def lower_index(self, bound: float) -> int:
        return int(np.ceil(bound * (self.npoints - 1)))

    def upper_index(self, bound: float) -> int:
        return int(np.floor(bound * (self.npoints - 1)))

    def _indices(self, pairs: Sequence[Tuple[float, float]]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        i1 = np.empty(len(pairs), np.int32)
        i2 = np.empty(len(pairs), np.int32)
        for k, (b1, b2) in enumerate(pairs):
            if b2 < b1:
                raise ValueError(f"Bounds out of order: {b1}-{b2}")
            j1 = self.lower_index(b1)
            j2 = self.upper_index(b2)
            if j1 < 0 or j2 >= self.npoints:
                raise ValueError(
                    f"Bounds {b1}-{b2} -> indices {j1}-{j2} outside 0-"
                    f"{self.npoints - 1}")
            if j2 < j1:
                j2 = j1   # bounds extremely close (ref :312-315)
            i1[k], i2[k] = j1, j2
            self.total_comp_cost += b2 - b1
        return i1, i2

    def calc_error_many(self, bounds_pairs):
        i1, i2 = self._indices(bounds_pairs)
        order = np.argsort(i1, kind="stable")
        i1s, i2s = i1[order], i2[order]

        # Greedily split the sorted probes into non-overlapping groups; a
        # partition sweep (the hot path) is one group = one kernel call.
        group_of = np.empty(len(i1s), np.int64)
        group_end: list = []
        for k in range(len(i1s)):
            for g, end in enumerate(group_end):
                if i1s[k] > end:
                    group_of[k] = g
                    group_end[g] = i2s[k]
                    break
            else:
                group_of[k] = len(group_end)
                group_end.append(i2s[k])

        out = np.empty(len(i1s))
        for g in range(len(group_end)):
            sel = np.nonzero(group_of == g)[0]
            out[sel] = self.kernel.costs(i1s[sel], i2s[sel])

        inv = np.argsort(order, kind="stable")
        return out[inv]

    def calc_error(self, bound1: float, bound2: float) -> float:
        return float(self.calc_error_many([(bound1, bound2)])[0])
