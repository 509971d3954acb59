"""Pipeline orchestrator: the do_all_lw/do_all_sw workflow layer.

TPU-native equivalent of the reference's L4 bash layer (test/do_all_lw.sh,
test/do_all_sw.sh + step scripts): runs the CKD-generation step DAG

    [merge] -> reorder (per gas) -> find_g_points -> create_lut
            -> [scale_lut (SW)] -> optimize_lut (multi-pass) -> [run_ckd]

with the reference's artifact-existence resume semantics (each step skipped
when its output already exists, ref test/reorder_spectrum_lw.sh:46-73,
merge_well_mixed_lw.sh:20-35) and full provenance chaining through the
NetCDF history/config attributes.

Configuration uses the same readconfig language as the tools; per-gas
sections carry the per-step options.  See tests/test_pipeline.py for a
complete LW example.

The port's own copy of ``ecckd_tpu/pipeline/orchestrator.py``: the same
steps, output names (their ``.h5`` / ``.nc`` suffixes too), resume rule and
preset expansion, calling the port's tools.  ``device`` takes the place of
``jax_platform`` (the tools compute on the card unless ``device=cpu``), and
``netcdf_format`` (``netcdf4`` by default, ``classic`` where h5py is
missing) is handed to every step with the other execution keys.
``use_pallas`` has no counterpart and is not forwarded.  Run it as
``python -m ecckd_tpu_torch.pipeline.orchestrator workflow.cfg [key=value
...]``.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, List

from .. import logs
from ..config import Config
from ..tools.common import tool_prologue, read_string_list
from . import presets


class Step:
    def __init__(self, name: str, outputs: List[str],
                 run: Callable[[], None]):
        self.name = name
        self.outputs = outputs
        self.run = run

    def is_done(self) -> bool:
        return all(os.path.exists(o) for o in self.outputs)


class Pipeline:
    """Ordered steps with artifact-existence resume."""

    def __init__(self, force: bool = False):
        self.steps: List[Step] = []
        self.force = force

    def add(self, name: str, outputs: List[str], run: Callable[[], None]):
        self.steps.append(Step(name, outputs, run))

    def run(self):
        for step in self.steps:
            if not self.force and step.is_done():
                logs.log(f"[{step.name}] outputs exist, skipping "
                         f"({', '.join(step.outputs)})")
                continue
            logs.log(f"[{step.name}] running")
            step.run()
            missing = [o for o in step.outputs if not os.path.exists(o)]
            if missing:
                raise RuntimeError(
                    f"Step {step.name} did not produce: {missing}")
            logs.log(f"[{step.name}] done")


def build_pipeline(cfg: Config) -> Pipeline:
    """Construct the CKD-generation pipeline from a workflow config.

    Required keys: ``mode`` (lw|sw), ``work_dir``, ``application``,
    ``band_structure``, ``gases``; per-gas sections provide ``input`` (and
    optionally ``background_input``, per-gas find_g_points options);
    ``tolerance`` the heating-rate tolerance; optimize pass keys
    ``optimize_passes`` and per-pass sections ``pass1`` etc.
    """
    from ..tools.reorder_spectrum import reorder_spectrum
    from ..tools.find_g_points import find_g_points
    from ..tools.create_lut import create_lut
    from ..tools.optimize_lut import optimize_lut
    from ..tools.scale_lut import scale_lut
    from ..tools.run_ckd import run_ckd

    mode = cfg.read_string("mode", default="lw")
    is_sw = mode == "sw"
    work_dir = cfg.read_string("work_dir", default=".")
    app = cfg.read_string("application", default="default")
    band = cfg.read_string("band_structure", default="fsck")
    gases = read_string_list(cfg, "gases")
    tolerance = cfg.read_float("tolerance", default=0.04)
    force = cfg.read_bool("force", default=False)
    ssi = cfg.read_string("ssi", default=None)

    # ---- L4 presets: expand application/band-structure names into the
    # concrete settings the step scripts hardwire (test/config.h:138-168,
    # test/check_configuration.h:36-57, find_g_points_*.sh tweaks).
    # Explicit user keys always win; unknown application names (ad-hoc
    # experiments) skip preset expansion entirely.
    monochromatic = False
    if app in presets.APPLICATIONS:
        settings = presets.check_configuration(mode, app, band, tolerance)
        if not cfg.exist("min_pressure"):
            cfg.set("min_pressure", str(settings["min_pressure"]))
        wn1, wn2 = settings["wavenumber1"], settings["wavenumber2"]
        if wn1 and not cfg.exist("wavenumber1"):
            cfg.set("wavenumber1", " ".join(str(v) for v in wn1))
            cfg.set("wavenumber2", " ".join(str(v) for v in wn2))
        for gas, opts in settings["gas_options"].items():
            if gas in gases:
                for key, val in opts.items():
                    if not cfg.exist(f"{gas}.{key}"):
                        cfg.set(f"{gas}.{key}", val)
        for key, val in settings.get("defaults", {}).items():
            if not cfg.exist(key):
                cfg.set(key, val)
        monochromatic = bool(settings.get("monochromatic", False))
    else:
        band_table = (presets.LW_BAND_STRUCTURES if mode == "lw"
                      else presets.SW_BAND_STRUCTURES)
        if band in band_table and not cfg.exist("wavenumber1"):
            wn1, wn2 = presets.band_boundaries(mode, band)
            if wn1:
                cfg.set("wavenumber1", " ".join(str(v) for v in wn1))
                cfg.set("wavenumber2", " ".join(str(v) for v in wn2))

    os.makedirs(work_dir, exist_ok=True)

    def path(name: str) -> str:
        return os.path.join(work_dir, name)

    def inherit_globals(sub: Config):
        """Propagate execution-environment keys to every step."""
        for key in ("precision", "device", "log_level", "netcdf_format"):
            val = cfg.read_string(key, default=None)
            if val is not None and not sub.exist(key):
                sub.set(key, val)
        return sub

    model_code = f"{mode}_{app}_{band}"
    pipe = Pipeline(force=force)

    # ---- reorder per gas ----
    order_files: Dict[str, str] = {}
    for gas in gases:
        out = path(f"{mode}_order_{app}_{gas}.h5")
        order_files[gas] = out
        sub = Config({k: v for k, v in
                      [("input", cfg.read_string(f"{gas}.input")),
                       ("output", out)]})
        if ssi:
            sub.set("ssi", ssi)
        for key in ("iprofile", "threshold_optical_depth", "wavenumber1",
                    "wavenumber2", "precision", "device",
                    "streaming_block_wav"):
            val = cfg.read_string(key, default=None)
            if val is not None:
                sub.set(key, val)

        def run_reorder(sub=sub, gas=gas):
            reorder_spectrum(inherit_globals(sub),
                             argv=["reorder_spectrum", f"gas={gas}"])
        pipe.add(f"reorder_{gas}", [out], run_reorder)

    # ---- find_g_points ----
    gpoint_file = path(f"{mode}_gpoints_{model_code}.h5")

    def run_fgp():
        sub = Config()
        sub.set("output", gpoint_file)
        sub.set("gases", " ".join(gases))
        sub.set("heating_rate_tolerance",
                cfg.read_string("tolerance", default=str(tolerance)))
        for key in ("averaging_method", "tolerance_tolerance",
                    "max_iterations", "flux_weight", "min_pressure",
                    "iprofile", "cloud", "max_no_rayleigh_wavenumber",
                    "precision", "device", "debug_partition",
                    "sharded", "band_parallel", "streaming_block_wav"):
            val = cfg.read_string(key, default=None)
            if val is not None:
                sub.set(key, val)
        if ssi:
            sub.set("ssi", ssi)
        for gas in gases:
            for key in cfg.section(gas).keys():
                sub.set(f"{gas}.{key}", cfg.read_string(f"{gas}.{key}"))
            sub.set(f"{gas}.reordering_input", order_files[gas])
        find_g_points(inherit_globals(sub),
                      argv=["find_g_points", f"model={model_code}"])
    pipe.add("find_g_points", [gpoint_file], run_fgp)

    # ---- create_lut ----
    raw_lut = path(f"{mode}_raw-ckd-definition_{model_code}.nc")

    def run_lut():
        sub = Config()
        sub.set("input", gpoint_file)
        sub.set("output", raw_lut)
        sub.set("gases", " ".join(gases))
        for key in ("averaging_method", "temperature_stride",
                    "base_wavenumber_boundary", "precision",
                    "device", "streaming", "sharded",
                    "streaming_block_wav", "streaming_memory_mb"):
            val = cfg.read_string(key, default=None)
            if val is not None:
                sub.set(key, val)
        if ssi:
            sub.set("ssi", ssi)
        for gas in gases:
            for key in cfg.section(gas).keys():
                sub.set(f"{gas}.{key}", cfg.read_string(f"{gas}.{key}"))
            if not cfg.exist(f"{gas}.conc_dependence"):
                sub.set(f"{gas}.conc_dependence", "linear")
        create_lut(inherit_globals(sub),
                   argv=["create_lut", f"model={model_code}"])
    pipe.add("create_lut", [raw_lut], run_lut)

    current = raw_lut

    # ---- scale_lut (SW only) ----
    if is_sw and cfg.exist("scale_lblfile"):
        scaled = path(f"{mode}_raw2-ckd-definition_{model_code}.nc")

        def run_scale(current=current, scaled=scaled):
            sub = Config()
            sub.set("input", current)
            sub.set("output", scaled)
            sub.set("lblfile", cfg.read_string("scale_lblfile"))
            sub.set("gpointfile", gpoint_file)
            scale_lut(inherit_globals(sub), argv=["scale_lut"])
        pipe.add("scale_lut", [scaled], run_scale)
        current = scaled

    # ---- optimize passes ----
    # Monochromatic (radiance-channel) models need no optimization
    # (do_all_lw_radiance.sh:12-14): the final model is the raw LUT.
    n_passes = cfg.read_int("optimize_passes",
                            default=0 if monochromatic else 1)
    if n_passes == 0:
        final = path(f"{mode}_ckd-definition_{model_code}.nc")

        def run_finalize(inp=current, out=final):
            import shutil
            shutil.copyfile(inp, out)
        pipe.add("finalize", [final], run_finalize)
        current = final
    for ipass in range(1, n_passes + 1):
        section = f"pass{ipass}"
        if ipass == n_passes:
            out = path(f"{mode}_ckd-definition_{model_code}.nc")
        else:
            out = path(f"{mode}_raw{ipass + 2}-ckd-definition_"
                       f"{model_code}.nc")

        def run_opt(section=section, inp=current, out=out,
                    last=(ipass == n_passes)):
            sub = Config()
            sub.set("input", inp)
            sub.set("output", out)
            sub.set("model_id", model_code)
            for key in ("training_input", "gases", "max_iterations",
                        "flux_weight", "broadband_weight", "prior_error",
                        "relative_to", "band_mapping",
                        "convergence_criterion", "precision",
                        "device"):
                val = (cfg.read_string(f"{section}.{key}", default=None)
                       or cfg.read_string(f"optimize_{key}", default=None))
                if val is not None:
                    sub.set(key, val)
            for key in cfg.section(section).keys():
                sub.set(key, cfg.read_string(f"{section}.{key}"))
            if last and not sub.exist("remove_min_max"):
                sub.set("remove_min_max", "1")
            optimize_lut(inherit_globals(sub),
                         argv=["optimize_lut", f"pass={section}"])
        pipe.add(f"optimize_{section}", [out], run_opt)
        current = out

    # ---- evaluation (run_ckd on scenario files) ----
    for i, scen in enumerate(read_string_list(cfg, "evaluation_input")
                             if cfg.exist("evaluation_input") else []):
        out = path(f"{mode}_fluxes_{model_code}_{i}.nc")

        def run_eval(scen=scen, out=out, inp=current):
            sub = Config()
            sub.set("ckd_model", inp)
            sub.set("input", scen)
            sub.set("output", out)
            run_ckd(inherit_globals(sub), argv=["run_ckd", f"eval={scen}"])
        pipe.add(f"run_ckd_{i}", [out], run_eval)

        # ---- accuracy stats vs LBL benchmark fluxes (the reference's
        # offline Matlab acceptance tests, plot/evaluate_ckd_lw_fluxes.m,
        # as a pipeline stage) ----
        lbl_refs = (read_string_list(cfg, "lbl_evaluation_fluxes")
                    if cfg.exist("lbl_evaluation_fluxes") else [])
        if i < len(lbl_refs):
            stats_out = path(f"{mode}_stats_{model_code}_{i}.json")

            def run_stats(ref=lbl_refs[i], flux=out, sout=stats_out,
                          inp=current):
                from ..tools.evaluate_ckd import evaluate_ckd
                sub = Config()
                sub.set("ref_fluxes", ref)
                sub.set("ckd_fluxes", flux)
                sub.set("ckd_definitions", inp)
                sub.set("band", mode)
                sub.set("output", sout)
                evaluate_ckd(inherit_globals(sub))
            pipe.add(f"evaluate_{i}", [stats_out], run_stats)

            # ---- evaluation figures (the reference's Matlab plot/ layer
            # as a pipeline stage; enabled with plots=1) ----
            if cfg.read_bool("plots", default=False):
                fig_out = path(f"{mode}_evaluation_{model_code}_{i}.png")

                def run_plot(ref=lbl_refs[i], flux=out, fout=fig_out):
                    from ..tools.plot_ckd import plot_ckd
                    sub = Config()
                    sub.set("plot", "evaluation")
                    sub.set("ref_fluxes", ref)
                    sub.set("ckd_fluxes", flux)
                    sub.set("band", mode)
                    sub.set("title", model_code)
                    sub.set("output", fout)
                    plot_ckd(inherit_globals(sub))
                pipe.add(f"plot_{i}", [fig_out], run_plot)

    if cfg.read_bool("plots", default=False):
        gp_fig = path(f"{mode}_gpoints_{model_code}.png")

        def run_gp_plot():
            from ..tools.plot_ckd import plot_ckd
            sub = Config()
            sub.set("plot", "gpoints")
            sub.set("input", gpoint_file)
            sub.set("output", gp_fig)
            plot_ckd(inherit_globals(sub))
        pipe.add("plot_gpoints", [gp_fig], run_gp_plot)

    return pipe


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg = tool_prologue(argv)
    pipe = build_pipeline(cfg)
    pipe.run()
    logs.log("Pipeline complete")


if __name__ == "__main__":
    main()
