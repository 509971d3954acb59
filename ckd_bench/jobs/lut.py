"""Job kind ``lut``: one look-up table of a configuration.

Set-up makes the seed's spectra at every temperature column of the
configuration and runs one search (:mod:`ckd_bench.jobs.search`) on the
column that the traffic's ``profile_offset_k`` names, for the g-points.
A job is ``create_lut_core`` over every gas and column from those
g-points, each gas with the concentration dependence the configuration
states: each profile's od averaged to the g-points with Planck weights,
streamed in blocks from host memory as the program decides for a
CKDMIP-sized spectrum.  Its answer, the model, is
checked by :mod:`ckd_bench.reference.lut`.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch.profiler import record_function

from .. import spectra
from ..reference.lut import check_tables
from .search import Job as SearchJob


class Job:
    tracing = False

    def __init__(self, cfg, traffic, seed, device, dtype=torch.float64):
        from ecckd_tpu_torch.models import ConcDependence
        from ecckd_tpu_torch.tools.create_lut import LutGas
        self.cfg, self.device, self.dtype = cfg, device, dtype
        self.spec = spectra.make(cfg, seed, device)
        _, self.gp = SearchJob(cfg, traffic, seed, device,
                               spec=self.spec).run()
        offsets = cfg["temperature_offsets_k"]

        def source(gas):
            return lambda icol: (self.spec.profiles[gas["name"]][
                offsets[icol]], gas["vmr"])

        self.lut_gases = [
            LutGas(g["name"], ConcDependence[g["conc_dependence"].upper()],
                   [source(g)]) for g in cfg["gases"]]

    def warm(self):
        self.run()

    def run(self):
        from ecckd_tpu_torch.tools.create_lut import create_lut_core
        gp = self.gp
        with record_function("ckd_bench.create_lut"):
            return create_lut_core(
                gp.g_point, gp.wavenumber1_band, gp.wavenumber2_band,
                gp.band_number, self.lut_gases,
                averaging_method=self.cfg["averaging_method"],
                device=self.device, dtype=self.dtype)

    def digest(self, model):
        h = hashlib.sha256()
        for g in model.single_gas_data:
            for a in (g.molar_abs, g.min_molar_abs, g.max_molar_abs):
                h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    def describe(self, model):
        return {"g_points": len(model.band_number),
                "search_g_points": len(self.gp.band_number)}

    def end_to_end(self, durations, window_s):
        return {"lut_s": window_s / len(durations)}

    def release(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, answers):
        names = ("transmission_gap", "extremes_gap", "table_faults")
        worst = dict.fromkeys(names, 0.0)
        for model in answers:
            nums = check_tables(self.cfg, self.spec, self.gp.g_point, model,
                                self.device)
            for name, v in zip(names, nums):
                worst[name] = max(worst[name], v)
        limits = self.cfg["limits"]["lut"]
        return {name: (worst[name], limits[name]) for name in names}
