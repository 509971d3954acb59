"""Batched candidate-interval cost kernels for the g-point search.

PyTorch counterpart of ``ecckd_tpu/partition/cost_kernel.py``
(ref CkdEquipartition::calc_error, find_g_points.cpp:206-426): one call
evaluates the heating-rate/flux cost of many non-overlapping candidate rank
intervals.  Per call the work is O(nwav x nlay) whatever the number of
intervals: kernel K3 reduces the fit operands and the truth rows over every
interval in one pass, and the sweep kernel (K1 for the longwave, K2 for the
shortwave) runs the flux recurrence once, each wavenumber carrying the
fitted od of its own interval, and sums the fluxes per interval.

With ``use_prefix`` the fit and truth rows' double-float prefix sums are
built once per kernel (:func:`~ecckd_tpu_torch.ops.segments.
build_prefix_sums`) and each probe's interval sums are gathers from them:
a probe then launches no K3, only its sweep.  Off by default.

With ``mesh`` (a :class:`~ecckd_tpu_torch.parallel.mesh.Mesh`) the band's
wavenumber axis is split over the mesh's spectral shards: every shard
launches K3 and the sweep on its own slice with rank-shifted bounds, and
only the (rows, nseg) interval sums and the (2 (nlay+1), nseg) flux
partials are reduced over the shards, two collectives a sweep
(``ecckd_tpu/partition/cost_kernel.py:189-276``, ``:378-430``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import logs
from ..constants import HR_WEIGHT
from ..ops.average import (fit_parts_lw, fit_parts_sw, total_trans_fallback,
                           total_trans_fit_parts)
from ..ops.heating_rate import heating_rate
from ..ops.kernels.interval_stream import device_bounds
from ..ops.kernels.interval_sum import fused_interval_sum
from ..ops.kernels.sweep_lw import sweep_lw_intervals
from ..ops.kernels.sweep_sw import sweep_sw_intervals
from ..ops.segments import (build_prefix_sums, interval_sum_from_prefix,
                             part_of)
from ..parallel.mesh import slice_wavenumbers, spectral_slices
from .equipartition import Equipartition


def _pad_to_bucket(n: int) -> int:
    """Candidate count padded to a power of two (1, 2, 4, 8, ...), the
    JAX package's bucket sizes, so both packages reduce the same columns."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _layer_sum(x):
    """Sum of (nlay, nseg) ``x`` over its layers, in layer order for each
    column: the same bits for an interval whatever else rides the batch.
    ``torch.sum`` over a leading axis sums in an order that depends on the
    number of columns on the CPU, and guarantees none on the card; a
    cumulative sum runs down each column in turn on both."""
    return torch.cumsum(x, dim=0)[-1]


def _cost_terms(layer_weight, flux_weight, hr_err, dn_err, up_err):
    """The two squared terms of the candidate cost per interval (ref
    calc_cost_function_lw.cpp:104-110): the layer-weighted squared
    heating-rate error (K/day), and the flux-weighted squared boundary-flux
    errors; the cost is the square root of their sum."""
    return (HR_WEIGHT * HR_WEIGHT
            * _layer_sum(layer_weight[:, None] * hr_err * hr_err),
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


class _Shard:
    """One spectral shard of a kernel in mesh mode: the slice of ranks
    ``[offset, offset + npoints)`` of the band (zero past its end, the JAX
    package's ``_pad_wav`` rule), its arrays on its device, and the parts
    built from them.  Its partition map searches global ranks."""

    def __init__(self, device, offset, npoints, dtype):
        self.device, self.offset = device, offset
        self.npoints, self.dtype = npoints, dtype
        self._ranks = (torch.arange(npoints, dtype=torch.int32, device=device)
                       + offset)

    def _device_seg_of_wav(self, i1):
        return _seg_of_wav(i1, self._ranks)


def _seg_of_wav(i1, ranks):
    """Per-rank partition map from the sorted, front-padded lower bounds:
    the last interval with i1 <= rank carries each rank's fitted od (the
    device form of the JAX package's CkdEquipartition._seg_of_wav)."""
    seg = torch.searchsorted(i1, ranks, right=True, out_int32=True) - 1
    return torch.clamp(seg, min=0)


class _Probe:
    """The bounds of one probe, uploaded with their host copy
    (:func:`device_bounds`), so that no launch reads them back: global on
    the kernel's device, and in mesh mode per shard both global (for its
    partition map) and shifted into its slice (for its launches).  The
    partition maps are kept for the probe's sweeps."""

    def __init__(self, kernel, i1, i2):
        i1 = np.asarray(i1, np.int64)
        i2 = np.asarray(i2, np.int64)
        self.i1, self.i2 = device_bounds(i1, i2, kernel.device)
        self.shards = None
        self._seg = {}
        if kernel._shards is not None:
            glob = {kernel.device: (self.i1, self.i2)}
            self.shards = []
            for sh in kernel._shards:
                if sh.device not in glob:
                    glob[sh.device] = device_bounds(i1, i2, sh.device)
                self.shards.append(glob[sh.device] + device_bounds(
                    i1 - sh.offset, i2 - sh.offset, sh.device))

    def seg_of_wav(self, holder, k=None):
        """The partition map of ``holder``, the kernel (``k`` None) or its
        shard ``k``."""
        if k not in self._seg:
            i1 = self.i1 if k is None else self.shards[k][0]
            self._seg[k] = holder._device_seg_of_wav(i1)
        return self._seg[k]


class _CandidateCostBase:
    """Binding checks, the partition map, the bucket contract and mesh mode
    shared by the LW and SW kernels; a subclass defines ``_kernel(probe)``
    and ``_truth_sets(probe)``.

    Both kernels take four keywords besides their arrays: ``fit_limits``,
    a float dtype whose transmission clamp and range the interval fit takes
    in place of its own (:func:`~ecckd_tpu_torch.ops.average.fit_parts_lw`),
    ``probe_log``, a list to which :meth:`costs` appends each call as
    (kernel, i1, i2, costs), ``use_prefix``, whether the rows that
    :meth:`costs` reduces are summed once into prefix sums at construction
    (``ecckd_tpu/partition/cost_kernel.py:135-158``; off by default), and
    ``mesh``, a :class:`~ecckd_tpu_torch.parallel.mesh.Mesh` over whose
    spectral shards the band's ranks are split.  The prefix holds the rows
    of a probe's K3 launch in the same order, so the sums of the first rows
    are a slice of it.

    Mesh mode (``ecckd_tpu/partition/cost_kernel.py:189-276``): each shard
    holds its slice of the wavenumber arrays on its device; per probe it
    launches K3 and the sweep (K1 or K2) on its slice with the bounds
    shifted into it (a shifted bound may lie outside the slice: the
    kernels' tables clamp it, the plain versions' membership excludes it),
    and its partition map of its global ranks.  The interval sums are
    reduced over the shards with the mesh's collective, then the fit and
    the cost use the global bounds (the logarithmic fit takes lengths from
    ``i2 - i1 + 1``), and each sweep's flux partials are reduced the same
    way: two collectives a sweep.  Across processes each process holds the
    whole band and computes its own shards' slices.  The prefix path is
    off in mesh mode, as in JAX."""

    _prefix = None
    _shards = None
    mesh = None
    # Arrays over layers or levels, copied whole to each shard
    _REPLICATED = ("layer_weight", "pressure_hl")

    def _build_prefix(self, parts):
        """Keep the prefix sums of ``parts`` and log their size."""
        hi, lo = build_prefix_sums(parts, self.npoints)
        self._prefix = (hi, lo)
        logs.log(f"    Prefix sums: {hi.shape[0]} rows x {hi.shape[1]} "
                 f"({2 * hi.numel() * hi.element_size() / 1e9:.3f} GB on "
                 f"{hi.device})")

    def _use_prefix(self, use_prefix):
        if use_prefix and self._shards is not None:
            logs.log("    Prefix sums are off in mesh mode")
        return bool(use_prefix) and self._shards is None

    def _holders(self):
        """Where the parts are built: the kernel, or each of its shards."""
        return [self] if self._shards is None else self._shards

    def interval_sums(self, i1: np.ndarray, i2: np.ndarray):
        """The sums over each interval of a probe's fit and truth rows,
        (rows, nseg) on the kernel's device, as :meth:`costs` reduces
        them: gathers from the prefix sums with ``use_prefix``, else K3
        (one launch, or one a shard and a reduction in mesh mode)."""
        return self._row_sums(lambda ns: ns._probe_parts, self._probe_rows,
                              _Probe(self, i1, i2))

    def _row_sums(self, parts_of, nrows, probe):
        """Sums over the probe's intervals of the first ``nrows`` rows of
        the probe stack, whose parts are ``parts_of(holder)``: gathers from
        the prefix sums where they hold those rows, else K3."""
        if self._shards is not None:
            return self.mesh.sum(
                [fused_interval_sum(parts_of(sh), sh.npoints, b[2], b[3],
                                    dtype=self.dtype)
                 for sh, b in zip(self._shards, probe.shards)],
                device=self.device)
        if self._prefix is not None and nrows <= self._prefix[0].shape[0]:
            hi, lo = self._prefix
            return interval_sum_from_prefix(hi[:nrows], lo[:nrows],
                                            probe.i1, probe.i2)
        return fused_interval_sum(parts_of(self), self.npoints, probe.i1,
                                  probe.i2, dtype=self.dtype)

    def _sweep(self, sweep, od_fit, probe):
        """(flux_dn, flux_up) of the probe's intervals from
        ``sweep(holder, od_fit, seg_of_wav, i1, i2)``: one launch, or in
        mesh mode one a shard, the partials reduced in one collective."""
        if self._shards is None:
            return sweep(self, od_fit.contiguous(), probe.seg_of_wav(self),
                         probe.i1, probe.i2)
        outs = []
        for k, (sh, b) in enumerate(zip(self._shards, probe.shards)):
            dn, up = sweep(sh, od_fit.to(sh.device).contiguous(),
                           probe.seg_of_wav(sh, k), b[2], b[3])
            outs.append(torch.cat([dn, up]))
        out = self.mesh.sum(outs, device=self.device)
        nlev = out.shape[0] // 2
        return out[:nlev], out[nlev:]

    def _bind(self, arrays, like, mesh=None):
        """Check that every array is a tensor of ``like``'s device and
        dtype and keep it as an attribute; with a ``mesh``, also cut the
        wavenumber arrays into its spectral shards."""
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
        if mesh is None:
            return
        self.mesh = mesh
        self._shards = []
        for dev, offset, nloc in spectral_slices(mesh, self.npoints):
            sh = _Shard(dev, offset, nloc, self.dtype)
            for name, a in arrays.items():
                setattr(sh, name, a.to(dev) if name in self._REPLICATED
                        else slice_wavenumbers(a, offset, nloc, dev))
            self._shards.append(sh)
        logs.log(f"    Candidate sweeps over {len(self._shards)} spectral "
                 f"shards of {self._shards[0].npoints} ranks "
                 f"({mesh.shape['spectral']} in the mesh)")

    def _device_seg_of_wav(self, i1):
        return _seg_of_wav(i1, self._ranks)

    def costs(self, i1: np.ndarray, i2: np.ndarray) -> np.ndarray:
        """Candidate costs (float64 numpy) for sorted, non-overlapping
        intervals.

        Bucket padding goes at the FRONT with [0, 0] intervals so the padded
        bounds stay sorted for the searchsorted partition map; padded
        columns are benign (single-point interval 0) and sliced off."""
        with logs.span("ecckd.partition.probe"):
            n = len(i1)
            nb = _pad_to_bucket(n)
            pad = nb - n
            i1p = np.zeros(nb, np.int32)
            i1p[pad:] = i1
            i2p = np.zeros(nb, np.int32)
            i2p[pad:] = i2
            out = self._kernel(_Probe(self, i1p, i2p))
            out = out.cpu().numpy()[pad:].astype(np.float64)
        if self.probe_log is not None:
            self.probe_log.append((self, np.array(i1), np.array(i2), out))
        return out

    def zero_fit_costs(self, i1: np.ndarray, i2: np.ndarray) -> np.ndarray:
        """Per interval, the cost (float64 numpy) of a fit whose fluxes
        are all zero: the scale of the fluxes whose differences make up
        :meth:`costs`, averaged over the same runs."""
        sets = self._truth_sets(_Probe(self, i1, i2))
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
                 fit_limits=None, probe_log=None, use_prefix=False,
                 mesh=None):
        self.averaging_method = averaging_method
        self.flux_weight = float(flux_weight)
        self.probe_log = probe_log
        self._bind(dict(layer_weight=layer_weight, pressure_hl=pressure_hl,
                        surf_emissivity=surf_emissivity,
                        surf_planck=surf_planck, flux_dn_surf=flux_dn_surf,
                        flux_up_toa=flux_up_toa, planck_hl=planck_hl,
                        bg_od=bg_od, metric=metric, hr=hr), metric, mesh)
        self.nlay = hr.shape[0]
        # The fit operands never change between probes, so the parts are
        # built once; fit and truth rows share one K3 pass per call.
        for ns in self._holders():
            parts, rows, finish = fit_parts_lw(averaging_method,
                                               ns.planck_hl, ns.metric,
                                               fit_limits)
            ns._parts = parts + _truth_parts(ns.hr, ns.flux_dn_surf,
                                             ns.flux_up_toa)
            ns._probe_parts = ns._parts
        self._fit_rows = rows
        self._fit_finish = finish
        self._probe_rows = rows + self.nlay + 2
        self.use_prefix = self._use_prefix(use_prefix)
        if self.use_prefix:
            self._build_prefix(self._parts)

    def _truth_of(self, sums):
        """(hr (nlay, nseg), flux_dn_surf, flux_up_toa) of the truth
        rows in the sums of one K3 launch."""
        rows, nlay = self._fit_rows, self.nlay
        return (sums[rows:rows + nlay], sums[rows + nlay],
                sums[rows + nlay + 1])

    def _truth_sets(self, probe):
        return [self._truth_of(self._row_sums(lambda ns: ns._parts,
                                              self._probe_rows, probe))]

    def _kernel(self, probe):
        sums = self._row_sums(lambda ns: ns._parts, self._probe_rows, probe)
        od_fit = self._fit_finish(sums[:self._fit_rows], probe.i1, probe.i2)
        flux_dn, flux_up = self._sweep(
            lambda ns, od, seg, i1, i2: sweep_lw_intervals(
                ns.planck_hl, ns.bg_od, od, seg, ns.surf_emissivity,
                ns.surf_planck, i1, i2), od_fit, probe)
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
                 fit_limits=None, probe_log=None, use_prefix=False,
                 mesh=None):
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
        self._bind(arrays, metric, mesh)
        self.with_upwelling = bool(torch.any(self.surf_albedo > 0.0))
        self.nlay = hr.shape[0]
        # The rows of a probe: the fit and the truth of its runs (for
        # total-transmission LOW and HIGH, not the unscaled MID that only
        # ``components`` reads)
        ntruth = len(self._runs())
        # Fit and truth rows share one K3 pass per call; the truth is that
        # of the two scaled runs for total-transmission.
        for ns in self._holders():
            if total_trans:
                parts, rows, finish = total_trans_fit_parts(
                    ns.ssi, ns.bg_od, ns.metric, fit_limits)
                truth = [_truth_parts(ns.hr_low, ns.flux_dn_surf_low,
                                      ns.flux_up_toa_low),
                         _truth_parts(ns.hr_high, ns.flux_dn_surf_high,
                                      ns.flux_up_toa_high)]
            else:
                parts, rows, finish = fit_parts_sw(averaging_method, ns.ssi,
                                                   ns.metric, fit_limits)
                truth = []
            ns._fit_parts = parts
            ns._truth = truth + [_truth_parts(ns.hr, ns.flux_dn_surf,
                                              ns.flux_up_toa)]
            ns._probe_parts = ns._fit_parts + [
                p for t in ns._truth[:ntruth] for p in t]
        self._fit_rows = rows
        self._fit_finish = finish
        self._probe_rows = rows + ntruth * (self.nlay + 2)
        self.use_prefix = self._use_prefix(use_prefix)
        if self.use_prefix:
            self._build_prefix(self._probe_parts)

    def _sums(self, probe, ntruth):
        """Fitted od (nlay, nseg) and the first ``ntruth`` truth sets, each
        (hr (nlay, nseg), flux_dn_surf (nseg,), flux_up_toa (nseg,)), from
        one K3 launch (one a shard in mesh mode) or the prefix sums."""
        nlay = self.nlay
        sums = self._row_sums(
            lambda ns: ns._fit_parts + [p for t in ns._truth[:ntruth]
                                        for p in t],
            self._fit_rows + ntruth * (nlay + 2), probe)
        rows = self._fit_rows
        od_fit = self._fit_finish(sums[:rows], probe.i1, probe.i2)
        sets = []
        for k in range(ntruth):
            t = sums[rows + k * (nlay + 2):rows + (k + 1) * (nlay + 2)]
            sets.append((t[:nlay], t[nlay], t[nlay + 1]))
        return od_fit, sets

    def _truth_sets(self, probe):
        return self._sums(probe, len(self._runs()))[1]

    def linear_fallback(self, i1: np.ndarray, i2: np.ndarray) -> np.ndarray:
        """Per interval, whether the total-transmission fit falls back to
        the linear fit (some level flux of the interval is not positive);
        False for every other method."""
        if self.averaging_method != "total-transmission":
            return np.zeros(len(i1), bool)
        sums = self._row_sums(lambda ns: ns._fit_parts, self._fit_rows,
                              _Probe(self, i1, i2))
        return total_trans_fallback(sums, self.nlay).cpu().numpy()

    def _runs(self):
        """(tag, od scaling) of the runs whose costs make up a probe's."""
        if self.averaging_method == "total-transmission":
            return (("LOW", self.min_scaling), ("HIGH", self.max_scaling))
        return (("MID", 1.0),)

    def _cost_with(self, od_fit, probe, truth, want_components=False):
        hr_true, fd_surf_true, fu_toa_true = truth
        flux_dn, flux_up = self._sweep(
            lambda ns, od, seg, i1, i2: sweep_sw_intervals(
                ns.ssi, ns.bg_od, od, seg, i1, i2, self.cos_sza,
                ns.surf_albedo, self.with_upwelling), od_fit, probe)
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

    def _kernel(self, probe):
        runs = self._runs()
        od_fit, truth = self._sums(probe, len(runs))
        costs = [self._cost_with(od_fit * scale, probe, t)
                 for (_, scale), t in zip(runs, truth)]
        if len(costs) == 1:
            return costs[0]
        return 0.5 * (costs[0] + costs[1])

    def components(self, i1: np.ndarray, i2: np.ndarray):
        """Per-interval cost components for ``debug_partition``, as
        ``{tag: {name: float64 numpy array}}``.

        The tag is MID for a plain method; total-transmission gives LOW
        and HIGH, the scaled runs whose costs are averaged, and MID, the
        unscaled fit against the main truth (find_g_points.cpp:346-375).
        MID's truth is not in the prefix sums, so total-transmission's
        components are reduced by K3 with ``use_prefix`` too, as the JAX
        package's are (``ecckd_tpu/partition/cost_kernel.py:639-695``)."""
        probe = _Probe(self, i1, i2)
        runs = self._runs()
        if len(runs) > 1:
            runs = runs + (("MID", 1.0),)
        od_fit, truth = self._sums(probe, len(runs))
        out = {}
        for (tag, scale), t in zip(runs, truth):
            comps = self._cost_with(od_fit * scale, probe, t,
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
