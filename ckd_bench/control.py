"""Readings that the limits of ``correct`` are set from.

    python3 ckd_bench/control.py --workload <name> --seeds <n> ... \
        [--dtype float64 float32] [--placed] [--fault <name>]

from the root of a checkout on a machine with an NVIDIA card.  For each
seed it makes the cell's inputs once, runs one job of the cell at its own
size in each dtype, and prints one JSON line with every number that the
check compares.  In float64, the precision the configurations state, the
program gives the lower readings; in float32, the program's own lower
precision path, it is the control, whose readings have to fail the
check.  With ``--placed`` the seed places the spectra's lines
(``lines_placed_by_seed``), so that each seed gives a spectrum of another
structure and another search; ``--fault`` plants one of :data:`FAULTS`
in the port, a search that decides wrongly, for the readings of a fault.
The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


# Faults of a search that decides wrongly with costs that are right for
# what it decided.  Each plants itself through ``patch`` (``setattr``, or
# a test's ``monkeypatch.setattr``).

def fewer_iterations(patch):
    """The equipartition cut to one iteration."""
    from ecckd_tpu_torch.partition.equipartition import Equipartition
    real = Equipartition.set_partition_max_iterations
    patch(Equipartition, "set_partition_max_iterations",
          lambda self, n: real(self, 1))


def bound_moved(patch):
    """The first inner bound of each band moved halfway to the next, and
    the costs of the intervals recomputed."""
    from ecckd_tpu_torch.tools import find_g_points
    real = find_g_points._search_band

    def moved(*a):
        status, bounds, error, ng, eq = real(*a)
        if ng >= 2:
            bounds = bounds.copy()
            bounds[1] = 0.5 * (bounds[1] + bounds[2])
            error = eq.calc_error_all(bounds)
        return status, bounds, error, ng, eq
    patch(find_g_points, "_search_band", moved)


def stops_early(patch):
    """Each band searched at 1.5 times the tolerance: fewer g-points."""
    from ecckd_tpu_torch.tools import find_g_points
    real = find_g_points._search_band
    patch(find_g_points, "_search_band",
          lambda kernel, tol, *a: real(kernel, 1.5 * tol, *a))


FAULTS = {f.__name__: f for f in (fewer_iterations, bound_moved,
                                  stops_early)}


def readings(cell, cfg, traffic, seeds, dtypes, device, fault=None):
    """Yield one dict of numbers per (seed, dtype)."""
    import torch
    from ckd_bench.harness import load_job
    Job = load_job(traffic)
    for seed in seeds:
        for name in dtypes:
            from ecckd_tpu_torch.ops.kernels import (fused_interval_sum,
                                                     reset_launch_counts)
            job = Job(cfg, traffic, seed, device,
                      dtype=getattr(torch, name))
            reset_launch_counts()
            t0 = time.perf_counter()
            answer = job.run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            probes = fused_interval_sum.launches
            job.release()
            nums = {k: v for k, (v, _) in job.check([answer]).items()}
            yield dict(workload=cell["name"], seed=seed, dtype=name,
                       placed=bool(cfg.get("lines_placed_by_seed")),
                       fault=fault,
                       job_seconds=seconds, probes=probes,
                       **job.describe(answer), **nums)
            del job, answer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dtype", nargs="+", default=["float64", "float32"])
    p.add_argument("--placed", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from ckd_bench.run import cache_env, load_cell
    cache_env(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    from ecckd_tpu_torch import logs
    from ecckd_tpu_torch.config import Config
    from ecckd_tpu_torch.ops.kernels import _build
    from ecckd_tpu_torch.tools.common import setup
    logs.set_log_level("warning")
    _build.prebuild((False,))
    cell, cfg, traffic, _ = load_cell(ROOT, args.workload)
    if args.placed:
        cfg["lines_placed_by_seed"] = True
    if args.fault:
        FAULTS[args.fault](setattr)
    setup(Config({"device": "cuda", "precision": cfg["precision"]}))
    for r in readings(cell, cfg, traffic, args.seeds, args.dtype, "cuda",
                      args.fault):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
