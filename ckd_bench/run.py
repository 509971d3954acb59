"""Run one cell of the ecckd_tpu_torch benchmark once.

    python3 ckd_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card.  The cell
is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration file
(``ckd_bench/configs/``) and a traffic file (``ckd_bench/traffic/<name>
.json``), whose ``job`` names the job kind (``ckd_bench/jobs/<job>.py``)
and whose other keys are the job's parameters.
Set-up makes the inputs on the card from the seed, loads the port's
kernels (building them into the checkout's ``build/`` the first time) and
runs the cell's job once.  The window then runs whole jobs back to back
and ends at the first job end after ``--seconds``.  The jobs' answers are
then held to the plain reference (``ckd_bench/reference/``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read by
``ckd_bench/metrics/<name>.py`` from the traced window), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, also printed as the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ecckd_tpu")


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that the benchmark must not load:
    the JAX package and JAX itself, compared as whole names."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def load_cell(root: Path, workload: str):
    """(cell, configuration, traffic, benchmark) of a workload name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / config["file"]).read_text())
    traffic = json.loads((root / "ckd_bench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return cell, cfg, traffic, bench


def metrics_of(bench, cell, trace):
    """The BENCHMARK.json metric entries this cell reports."""
    name = cell["name"]
    if not trace:
        return [m for m in bench["end_to_end"]
                if name in m.get("workloads", [name])]
    e2e = {m["name"] for m in metrics_of(bench, cell, False)}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e
                             else [])]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache_env(ROOT)
    sys.path.insert(0, str(ROOT))
    cell, cfg, traffic, bench = load_cell(ROOT, args.workload)

    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"error: the cell needs {cell['chips']} CUDA card(s); "
              f"{cards} available", file=sys.stderr)
        return 2
    from ckd_bench.harness import run_cell
    result = run_cell(cell, cfg, traffic, metrics_of(bench, cell,
                                                     args.trace),
                      args.seed, args.seconds, bool(args.trace), "cuda",
                      T_START)
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad}, which the benchmark of the "
              "port must not load", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
