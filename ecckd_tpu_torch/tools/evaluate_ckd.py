"""evaluate_ckd: accuracy statistics of CKD flux files vs LBL benchmarks.

CLI equivalent of the reference's Matlab evaluation layer
(plot/evaluate_ckd_lw_fluxes.m, plot/calc_hr_error.m,
plot/plot_accuracy_efficiency.m) — the reference treats these offline
scripts as its acceptance tests (SURVEY.md §4); here they are a first-class
pipeline tool.

Usage:
  python -m ecckd_tpu_torch.tools.evaluate_ckd ref_fluxes=LBL.nc \\
      ckd_fluxes="modelA.nc modelB.nc" [band=lw] \\
      [ckd_definitions="a_ckd.nc b_ckd.nc"] [model_names="A B"] \\
      [output=stats.json] [config.cfg]

Prints one stats block per model (the text panel of
evaluate_ckd_lw_fluxes.m:247-256) and, with ``output=``, writes the full
accuracy-efficiency table as JSON.

The port's own copy of ``ecckd_tpu/tools/evaluate_ckd.py``: the port
imports nothing of the JAX package.  It computes on the host (numpy), so
it takes no ``device``.
"""

from __future__ import annotations

import json
import sys

from .. import logs
from ..config import Config
from ..evaluate import (accuracy_efficiency_table, evaluate_fluxes,
                        format_stats)
from .common import tool_prologue, find_file, read_string_list


def evaluate_ckd(cfg: Config, argv=()) -> list:
    ref_file = find_file(cfg.read_string("ref_fluxes"))
    ckd_files = [find_file(f) for f in read_string_list(cfg, "ckd_fluxes")]
    if not ckd_files:
        raise ValueError("ckd_fluxes not provided")
    band = cfg.read_string("band", default="lw")
    defs = [find_file(f)
            for f in read_string_list(cfg, "ckd_definitions")] or None
    if defs is not None and len(defs) != len(ckd_files):
        raise ValueError("ckd_definitions length must match ckd_fluxes")
    names = read_string_list(cfg, "model_names")

    rows = accuracy_efficiency_table(ref_file, ckd_files, band=band,
                                     ckd_definition_files=defs)
    for i, row in enumerate(rows):
        title = names[i] if i < len(names) else row["file"]
        row["model"] = title
        suffix = (f" ({row['n_g_points']} g-points)"
                  if "n_g_points" in row else "")
        logs.log(format_stats(row, title=title + suffix))

    output = cfg.read_string("output", default=None)
    if output:
        with open(output, "w") as f:
            json.dump({"ref_fluxes": ref_file, "band": band,
                       "models": rows}, f, indent=1)
        logs.log(f"Wrote {output}")
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: evaluate_ckd(tool_prologue(argv), argv=["evaluate_ckd"] + argv),
        name="evaluate_ckd")


if __name__ == "__main__":
    sys.exit(main())
