"""Job kind ``search_merged``: the g-point search of :mod:`.search`, with
its overlap of the gases checked too.

The same closed loop of whole searches, one at a time.  The answer's
digest also covers the merged per-wavenumber g-point map and the merged
g-points' bands.  Besides the search's numbers, the check holds the
overlap to :mod:`ckd_bench.reference.overlap`: each gas's per-wavenumber
g-point (``gas_map_faults``), the merged map and bands
(``merged_map_faults``) and the reported median sorting variables
(``median_sv_gap``).  Every limit is read from the configuration's
``limits.search_merged``.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..reference.overlap import check_overlap
from . import search


class Job(search.Job):

    def __init__(self, cfg, traffic, seed, device, **kw):
        # The search's own numbers are held to this job's limits too
        limits = cfg["limits"]["search_merged"]
        super().__init__(dict(cfg, limits={"search": limits,
                                           "search_merged": limits}),
                         traffic, seed, device, **kw)

    def digest(self, answer):
        _, gp = answer
        h = hashlib.sha256(super().digest(answer).encode())
        for a in (gp.g_point, gp.band_number):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    def check(self, answers):
        out = super().check(answers)
        names = ("gas_map_faults", "merged_map_faults", "median_sv_gap")
        worst = dict.fromkeys(names, 0.0)
        for orders, gp in answers:
            nums = check_overlap(self.cfg, self.spec, self.gases, orders, gp,
                                 self.device)
            for name, v in zip(names, nums):
                worst[name] = max(worst[name], v)
        limits = self.cfg["limits"]["search_merged"]
        out.update((name, (worst[name], limits[name])) for name in names)
        return out
