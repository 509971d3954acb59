"""plot_ckd: evaluation figures for CKD models and flux files.

CLI front-end to :mod:`ecckd_tpu_torch.evaluate.plots` — the reference's Matlab
``plot/`` layer (plot_gpoints.m, evaluate_ckd_lw_fluxes.m,
plot_accuracy_efficiency.m, compare_averaging_methods.m,
plot_present_day_fluxes.m) as one tool with a ``plot=`` selector.

Usage:
  python -m ecckd_tpu_torch.tools.plot_ckd plot=gpoints input=gpoints.h5 \\
      output=gpoints.png
  python -m ecckd_tpu_torch.tools.plot_ckd plot=evaluation ref_fluxes=LBL.nc \\
      ckd_fluxes=model.nc [band=lw] [title="ecCKD 64g"] output=eval.png
  python -m ecckd_tpu_torch.tools.plot_ckd plot=flux-profiles ref_fluxes=LBL.nc \\
      ckd_fluxes=model.nc output=profiles.png
  python -m ecckd_tpu_torch.tools.plot_ckd plot=accuracy-efficiency \\
      input="statsA.json statsB.json" [labels="narrow wide"] \\
      [metric=heating_rate_low_rmse] output=acc.png
  python -m ecckd_tpu_torch.tools.plot_ckd plot=averaging-methods \\
      ref_fluxes=LBL.nc ckd_fluxes="lin.nc trans.nc" \\
      methods="linear transmission" output=methods.png

The port's own copy of ``ecckd_tpu/tools/plot_ckd.py``: the port imports
nothing of the JAX package.  It needs matplotlib (imported inside
:func:`plot_ckd`).
"""

from __future__ import annotations

import json
import sys

from .. import logs
from ..config import Config
from .common import tool_prologue, find_file, read_string_list


def plot_ckd(cfg: Config, argv=()) -> str:
    from ..evaluate import plots
    from ..evaluate.metrics import evaluate_fluxes

    kind = cfg.read_string("plot")
    output = cfg.read_string("output")
    band = cfg.read_string("band", default="lw")

    if kind == "gpoints":
        out = plots.plot_gpoints(find_file(cfg.read_string("input")), output)
    elif kind == "evaluation":
        out = plots.plot_evaluation(
            find_file(cfg.read_string("ref_fluxes")),
            find_file(cfg.read_string("ckd_fluxes")), output, band=band,
            title=cfg.read_string("title", default="CKD model"))
    elif kind == "flux-profiles":
        out = plots.plot_flux_profiles(
            find_file(cfg.read_string("ref_fluxes")),
            find_file(cfg.read_string("ckd_fluxes")), output, band=band)
    elif kind == "accuracy-efficiency":
        stat_files = [find_file(f) for f in read_string_list(cfg, "input")]
        labels = read_string_list(cfg, "labels")
        tables = {}
        for i, path in enumerate(stat_files):
            with open(path) as f:
                data = json.load(f)
            label = labels[i] if i < len(labels) else path
            rows = data["models"] if isinstance(data, dict) else data
            missing = [r for r in rows if "n_g_points" not in r]
            if missing:
                raise ValueError(
                    f"{path}: rows lack n_g_points — rerun evaluate_ckd "
                    "with ckd_definitions=")
            tables[label] = rows
        out = plots.plot_accuracy_efficiency(
            tables, output,
            metric=cfg.read_string("metric",
                                   default="heating_rate_low_rmse"))
    elif kind == "averaging-methods":
        ref = find_file(cfg.read_string("ref_fluxes"))
        ckd_files = [find_file(f) for f in read_string_list(cfg,
                                                            "ckd_fluxes")]
        methods = read_string_list(cfg, "methods")
        if len(methods) != len(ckd_files):
            raise ValueError("methods length must match ckd_fluxes")
        stats = {m: evaluate_fluxes(ref, f, band)
                 for m, f in zip(methods, ckd_files)}
        out = plots.plot_averaging_methods(stats, output)
    else:
        raise ValueError(
            f"plot '{kind}' not understood; choose from gpoints, "
            "evaluation, flux-profiles, accuracy-efficiency, "
            "averaging-methods")
    logs.log(f"Wrote {out}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: plot_ckd(tool_prologue(argv), argv=["plot_ckd"] + argv),
        name="plot_ckd")


if __name__ == "__main__":
    sys.exit(main())
