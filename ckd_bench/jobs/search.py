"""Job kind ``search``: one g-point search of a configuration, as a user
reruns it while tuning bands and tolerances.

A job is ``reorder_core`` for each gas of the configuration, then
``find_g_points_core`` over the gases, with each gas's per-band options
(``base_split``, ``min_g_points``) as the configuration states them, on
the temperature profile that the traffic's ``profile_offset_k`` names;
each gas after the first is searched over the background of the gases
before it.  Its answer is the order and the g-points of each gas, checked
by :mod:`ckd_bench.reference.search`, and the number of g-points in all,
held to the configuration's ``g_points``.
"""

from __future__ import annotations

import hashlib
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from .. import spectra
from ..reference.search import check_gas


class _ProbeLog(list):
    """The cost kernels' probe log, kept light: each probe as its launches
    saw it (bounds front-padded to a power of two with [0, 0] columns, as
    the kernels pad them, and the kernel's shapes), without the kernel,
    whose arrays would otherwise live as long as the log."""

    def __init__(self, sw_sweeps):
        super().__init__()
        self.sw_sweeps = sw_sweeps

    def append(self, entry):
        kernel, i1, i2, _ = entry
        n = len(i1)
        pad = (1 << (n - 1).bit_length()) - n if n > 1 else 0
        lw = not hasattr(kernel, "with_upwelling")
        super().append(SimpleNamespace(
            kind="lw" if lw else "sw", nlay=kernel.nlay, n=kernel.npoints,
            elem=kernel.dtype.itemsize,
            i1=np.r_[np.zeros(pad, np.int64), i1],
            i2=np.r_[np.zeros(pad, np.int64), i2],
            sweeps=1 if lw else self.sw_sweeps,
            upwelling=False if lw else bool(kernel.with_upwelling)))


class Job:
    tracing = False

    def __init__(self, cfg, traffic, seed, device, dtype=torch.float64,
                 spec=None):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.dtype = dtype
        self.offset = float(traffic.get("profile_offset_k", 0.0))
        self.spec = (spectra.make(cfg, seed, device, offsets=[self.offset])
                     if spec is None else spec)
        self.probe_log = _ProbeLog(
            2 if cfg["averaging_method"] == "total-transmission" else 1)
        self._backgrounds()

    def _backgrounds(self):
        """Each gas's profile and the od of the gases before it (None for
        the first)."""
        self.gases = []
        bg = None
        for gas in self.cfg["gases"]:
            sp = self.spec.profiles[gas["name"]][self.offset]
            self.gases.append((gas, sp, bg))
            bg = sp.optical_depth if bg is None else bg + sp.optical_depth

    def warm(self):
        self.run()

    def _order(self, sp):
        from ecckd_tpu_torch.tools.reorder_spectrum import reorder_core
        cfg = self.cfg
        bands = cfg.get("bands_wavenumber")
        band1 = band2 = None
        if bands is not None and len(bands) > 1:
            band1 = np.array([b[0] for b in bands], np.float64)
            band2 = np.array([b[1] for b in bands], np.float64)
        return reorder_core(sp.pressure_hl, sp.wavenumber, sp.d_wavenumber,
                            sp.optical_depth, band1, band2,
                            threshold_optical_depth=cfg["reorder_threshold"],
                            device=self.device, dtype=self.dtype,
                            do_sw=bool(cfg.get("shortwave")))

    def run(self):
        """One search: (orders, g-points)."""
        from ecckd_tpu_torch.tools.find_g_points import (GasInput,
                                                         find_g_points_core)
        cfg = self.cfg
        orders, inputs = [], []
        with record_function("ckd_bench.reorder"):
            for gas, sp, bg in self.gases:
                order = self._order(sp)
                orders.append(order)
                inputs.append(GasInput(
                    gas["name"], order["rank"], order["band_number"],
                    order["wavenumber1_band"], order["wavenumber2_band"],
                    order["sorting_variable"], sp.pressure_hl,
                    sp.temperature_hl, sp.wavenumber, sp.d_wavenumber,
                    sp.optical_depth, bg_optical_depth=bg,
                    base_split=gas.get("base_split"),
                    min_g_points=gas.get("min_g_points"),
                    min_scaling=cfg.get("min_scaling", 1.0),
                    max_scaling=cfg.get("max_scaling", 1.0)))
        options = None
        if self.tracing:
            if not self.probe_log:
                from ecckd_tpu_torch.ops.kernels import reset_launch_counts
                reset_launch_counts()
            options = {"probe_log": self.probe_log}
        with record_function("ckd_bench.find_g_points"):
            gp = find_g_points_core(
                inputs, cfg["tolerance"],
                tolerance_tolerance=cfg["partition_tolerance"],
                averaging_method=cfg["averaging_method"],
                flux_weight=cfg["flux_weight"],
                min_pressure=cfg["min_pressure_pa"], device=self.device,
                dtype=self.dtype, ssi=self.spec.ssi,
                max_no_rayleigh_wavenumber=cfg.get(
                    "max_no_rayleigh_wavenumber", 10000.0),
                cost_options=options)
        return orders, gp

    def digest(self, answer):
        orders, gp = answer
        h = hashlib.sha256()
        for order in orders:
            for key in ("rank", "sorting_variable"):
                h.update(np.ascontiguousarray(order[key]).tobytes())
        for g in gp.gases:
            for a in (g.rank1, g.rank2, g.error):
                h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    def launches(self):
        """The port's launch counts of each kernel since the traced window
        began."""
        from ecckd_tpu_torch.ops.kernels import KERNELS
        return {k.__name__: k.launches for k in KERNELS}

    def probes(self):
        """The traced window's probes, as their launches saw them."""
        return list(self.probe_log)

    def describe(self, answer):
        """What a job did, for the run's log: g-points in all and of each
        gas."""
        _, gp = answer
        return {"g_points": len(gp.band_number),
                "g_points_by_gas": [len(g.rank1) for g in gp.gases]}

    def end_to_end(self, durations, window_s):
        return {"search_s": window_s / len(durations)}

    def release(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, answers):
        """Every distinct answer of the window against the reference; the
        worst of each number over answers and gases."""
        names = ("sorting_variable_gap", "rank_disorder", "partition_faults",
                 "rank_faults", "gpoint_cost_gap", "partition_imbalance")
        worst = dict.fromkeys(names + ("g_point_count_gap",), 0.0)
        for orders, gp in answers:
            worst["g_point_count_gap"] = max(
                worst["g_point_count_gap"],
                abs(len(gp.band_number) - self.cfg["g_points"]))
            for (gas, sp, bg), order, g in zip(self.gases, orders, gp.gases):
                nums = check_gas(self.cfg, gas, self.spec, sp, bg, order, g,
                                 self.device)
                for name, v in zip(names, nums):
                    worst[name] = max(worst[name], v)
        limits = self.cfg["limits"]["search"]
        return {name: (worst[name], limits[name]) for name in worst}
