"""Find the search tolerance that gives a configuration its g-points.

    python3 ckd_bench/calibrate.py <config> [--seed 0] [--lo x] [--hi y] \
        [--edge-steps 3]

from the root of a checkout on a machine with an NVIDIA card.  Runs the
configuration's search (:mod:`ckd_bench.jobs.search`) on the seed's
spectra at tolerances bisected in log space until one gives the
configuration's ``g_points``, then bisects from it towards ``--lo`` and
``--hi`` for the window of tolerances that give that count, printing one
JSON line per search and last the window and its geometric middle.  A
configuration's ``tolerance`` is set to that middle once, on seed 0, and
then held for every seed: in the middle of the window, the small changes
from seed to seed move no g-point in or out.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lo", type=float, default=None)
    p.add_argument("--hi", type=float, default=None)
    p.add_argument("--steps", type=int, default=14)
    p.add_argument("--edge-steps", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from ckd_bench.run import cache_env
    cache_env(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    from ecckd_tpu_torch import logs
    from ecckd_tpu_torch.config import Config
    from ecckd_tpu_torch.ops.kernels import _build
    from ecckd_tpu_torch.tools.common import setup
    from ckd_bench.jobs.search import Job
    logs.set_log_level("warning")
    _build.prebuild((False,))
    cfg = json.loads((ROOT / "ckd_bench" / "configs"
                      / f"{args.config}.json").read_text())
    setup(Config({"device": "cuda", "precision": cfg["precision"]}))
    want = cfg["g_points"]
    job = Job(cfg, {}, args.seed, "cuda")

    def count(tol):
        job.cfg = dict(cfg, tolerance=tol)
        t0 = time.perf_counter()
        _, gp = job.run()
        torch.cuda.synchronize()
        ng = len(gp.band_number)
        print(json.dumps({"tolerance": tol, "g_points": ng,
                          "seconds": time.perf_counter() - t0}), flush=True)
        return ng

    lo = args.lo or cfg["documented_tolerance"] / 64.0
    hi = args.hi or cfg["documented_tolerance"] * 64.0
    best = None
    for _ in range(args.steps):
        mid = math.sqrt(lo * hi)
        ng = count(mid)
        if best is None or abs(ng - want) < abs(best[1] - want):
            best = (mid, ng)
        if ng == want:
            break
        if ng > want:
            lo = mid
        else:
            hi = mid
    window = [best[0], best[0]]
    if best[1] == want:
        # Where the count changes, below and above the hit
        for side, far in ((0, lo), (1, hi)):
            near = best[0]
            for _ in range(args.edge_steps):
                mid = math.sqrt(near * far)
                if count(mid) == want:
                    near = mid
                else:
                    far = mid
            window[side] = near
    middle = math.sqrt(window[0] * window[1])
    print(json.dumps({"config": args.config, "seed": args.seed,
                      "window": window, "tolerance": middle,
                      "g_points": count(middle)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
