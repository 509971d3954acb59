"""The port's evaluation figures (``ecckd_tpu_torch/evaluate/plots.py``,
``tools/plot_ckd.py``): the cases of tests/test_plots.py, each drawn
from the port's files, NetCDF-4 and classic, and held to the JAX
package's figure of the same data byte for byte (both draw with the same
matplotlib)."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("matplotlib")

from ecckd_tpu.config import Config as JaxConfig  # noqa: E402
from ecckd_tpu.evaluate import plots as jax_plots  # noqa: E402
from ecckd_tpu.io.ncio import NcWriter as JaxNcWriter  # noqa: E402
from ecckd_tpu.pipeline.orchestrator import (  # noqa: E402
    build_pipeline as jax_build)
from ecckd_tpu.tools.plot_ckd import plot_ckd as jax_plot_ckd  # noqa: E402
from ecckd_tpu_torch.config import Config  # noqa: E402
from ecckd_tpu_torch.evaluate import plots  # noqa: E402
from ecckd_tpu_torch.io import NcFile  # noqa: E402
from ecckd_tpu_torch.io.ncio import NcWriter  # noqa: E402
from ecckd_tpu_torch.pipeline.orchestrator import (  # noqa: E402
    build_pipeline)
from ecckd_tpu_torch.tools.plot_ckd import main, plot_ckd  # noqa: E402
from synth import synth_spectrum_file  # noqa: E402

WRITERS = {"jax": JaxNcWriter,
           "netcdf4": NcWriter,
           "classic": lambda path: NcWriter(path, format="classic")}


def write_fluxes(writer, p_hl, up, dn):
    with writer as w:
        w.define_dimension("column", up.shape[0])
        w.define_dimension("half_level", up.shape[1])
        for name in ("pressure_hl", "flux_up_lw", "flux_dn_lw"):
            w.define_variable(name, "double", "column", "half_level")
        w.write(p_hl, "pressure_hl")
        w.write(up, "flux_up_lw")
        w.write(dn, "flux_dn_lw")


def write_gpoints(writer):
    """tests/test_plots.py's g-point file: two gases over two bands."""
    with writer as w:
        w.define_dimension("wavenumber", 100)
        w.define_dimension("band", 2)
        w.define_dimension("h2o_g_point", 4)
        w.define_dimension("o3_g_point", 3)
        w.define_variable("wavenumber", "double", "wavenumber")
        w.define_variable("wavenumber1_band", "double", "band")
        w.define_variable("wavenumber2_band", "double", "band")
        for gas in ("h2o", "o3"):
            w.define_variable(f"{gas}_n_g_points", "int", "band")
            for v in ("rank1", "rank2", "band_number"):
                w.define_variable(f"{gas}_{v}", "int", f"{gas}_g_point")
        w.write(np.linspace(1, 2000, 100), "wavenumber")
        w.write([0.0, 1000.0], "wavenumber1_band")
        w.write([1000.0, 2000.0], "wavenumber2_band")
        w.write([3, 1], "h2o_n_g_points")
        w.write([0, 20, 40, 0], "h2o_rank1")
        w.write([19, 39, 49, 49], "h2o_rank2")
        w.write([0, 0, 0, 1], "h2o_band_number")
        w.write([2, 1], "o3_n_g_points")
        w.write([0, 25, 0], "o3_rank1")
        w.write([24, 49, 49], "o3_rank2")
        w.write([0, 0, 1], "o3_band_number")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """tests/test_plots.py's LW flux files (an LBL truth and a perturbed
    CKD run) and g-point file, written by each writer."""
    d = tmp_path_factory.mktemp("torch_plots")
    rng = np.random.default_rng(7)
    ncol, nhl = 4, 12
    p_hl = np.tile(np.exp(np.linspace(np.log(100.0), np.log(1.013e5), nhl)),
                   (ncol, 1))
    flux_dn = np.cumsum(rng.uniform(2, 8, (ncol, nhl)), axis=1)
    flux_up = flux_dn + rng.uniform(20, 40, (ncol, 1))
    ckd_up = flux_up + rng.normal(0, 0.5, (ncol, nhl))
    ckd_dn = flux_dn + rng.normal(0, 0.5, (ncol, nhl))
    out = {}
    for tag, writer in WRITERS.items():
        out[tag] = dict(ref=str(d / f"lbl_{tag}.nc"),
                        ckd=str(d / f"ckd_{tag}.nc"),
                        gpoints=str(d / f"gpoints_{tag}.h5"))
        write_fluxes(writer(out[tag]["ref"]), p_hl, flux_up, flux_dn)
        write_fluxes(writer(out[tag]["ckd"]), p_hl, ckd_up, ckd_dn)
        write_gpoints(writer(out[tag]["gpoints"]))
    return out


def png(path):
    assert os.path.getsize(path) > 2000
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"\x89PNG"
    return data


def same_figure(draw, tmp_path, files, container):
    """``draw(module, files, output)`` by the port on its ``container``'s
    files and by the JAX package on its own: the same PNG bytes."""
    port = draw(plots, files[container], str(tmp_path / "port.png"))
    jax = draw(jax_plots, files["jax"], str(tmp_path / "jax.png"))
    assert png(port) == png(jax)


CONTAINERS = ["netcdf4", "classic"]


@pytest.mark.parametrize("container", CONTAINERS)
def test_plot_gpoints(files, tmp_path, container):
    same_figure(lambda m, f, out: m.plot_gpoints(f["gpoints"], out),
                tmp_path, files, container)


@pytest.mark.parametrize("container", CONTAINERS)
def test_discover_gases(files, container):
    with NcFile(files[container]["gpoints"]) as f:
        assert plots.discover_gases(f.names()) == ["h2o", "o3"]


@pytest.mark.parametrize("container", CONTAINERS)
def test_plot_evaluation(files, tmp_path, container):
    same_figure(lambda m, f, out: m.plot_evaluation(f["ref"], f["ckd"], out),
                tmp_path, files, container)


@pytest.mark.parametrize("container", CONTAINERS)
def test_plot_flux_profiles(files, tmp_path, container):
    same_figure(lambda m, f, out: m.plot_flux_profiles(f["ref"], f["ckd"],
                                                       out),
                tmp_path, files, container)


def test_plot_accuracy_efficiency(tmp_path):
    tables = {
        "narrow": [{"n_g_points": 16, "heating_rate_low_rmse": 0.2},
                   {"n_g_points": 64, "heating_rate_low_rmse": 0.05}],
        "wide": [{"n_g_points": 32, "heating_rate_low_rmse": 0.1}],
    }
    assert png(plots.plot_accuracy_efficiency(
        tables, str(tmp_path / "port.png"))) == png(
        jax_plots.plot_accuracy_efficiency(tables, str(tmp_path / "jax.png")))


def test_plot_averaging_methods(tmp_path):
    stats = {"linear": {"heating_rate_low_rmse": 0.3,
                        "heating_rate_high_rmse": 0.5},
             "transmission": {"heating_rate_low_rmse": 0.1,
                              "heating_rate_high_rmse": 0.2}}
    assert png(plots.plot_averaging_methods(
        stats, str(tmp_path / "port.png"))) == png(
        jax_plots.plot_averaging_methods(stats, str(tmp_path / "jax.png")))


def cli_case(kind, f, tmp_path):
    """plot_ckd's keys for the cases of tests/test_plots.py."""
    if kind == "evaluation":
        return {"ref_fluxes": f["ref"], "ckd_fluxes": f["ckd"]}
    if kind == "gpoints":
        return {"input": f["gpoints"]}
    if kind == "flux-profiles":
        return {"ref_fluxes": f["ref"], "ckd_fluxes": f["ckd"]}
    if kind == "averaging-methods":
        return {"ref_fluxes": f["ref"],
                "ckd_fluxes": f"{f['ckd']} {f['ckd']}",
                "methods": "linear transmission"}
    sfile = str(tmp_path / "s.json")
    with open(sfile, "w") as out:
        json.dump({"models": [
            {"n_g_points": 16, "heating_rate_low_rmse": 0.2},
            {"n_g_points": 64, "heating_rate_low_rmse": 0.05}]}, out)
    return {"input": sfile, "labels": "narrow"}


@pytest.mark.parametrize("kind", ["evaluation", "gpoints", "flux-profiles",
                                  "averaging-methods",
                                  "accuracy-efficiency"])
def test_cli(files, tmp_path, kind):
    port, jax = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    plot_ckd(Config({"plot": kind, "output": port,
                     **cli_case(kind, files["classic"], tmp_path)}))
    jax_plot_ckd(JaxConfig({"plot": kind, "output": jax,
                            **cli_case(kind, files["jax"], tmp_path)}))
    assert png(port) == png(jax)


def test_cli_main_and_refusals(files, tmp_path):
    out = str(tmp_path / "main.png")
    assert main(["plot=gpoints", f"input={files['classic']['gpoints']}",
                 f"output={out}"]) == 0
    png(out)
    with pytest.raises(ValueError, match="not understood"):
        plot_ckd(Config({"plot": "pie", "output": "x.png"}))
    sfile = str(tmp_path / "bad.json")
    with open(sfile, "w") as f:
        json.dump({"models": [{"heating_rate_low_rmse": 0.2}]}, f)
    with pytest.raises(ValueError, match="n_g_points"):
        plot_ckd(Config({"plot": "accuracy-efficiency", "input": sfile,
                         "output": str(tmp_path / "acc.png")}))


def test_orchestrator_plots_stage(tmp_path):
    """plots=1 adds the figure stages as in the JAX orchestrator, and the
    port's g-point figure is drawn from its own g-point file."""
    h2o = synth_spectrum_file(str(tmp_path / "h2o.h5"), molecule="h2o",
                              nwav=256, ncol=6, seed=3)
    keys = {"mode": "lw", "application": "test", "band_structure": "fsck",
            "tolerance": "0.3", "gases": "h2o", "plots": "1",
            "averaging_method": "transmission", "h2o.input": h2o,
            "h2o.conc_dependence": "linear", "evaluation_input": "s.nc",
            "lbl_evaluation_fluxes": "ref.nc"}
    names = {}
    for tag, cfg in (("jax", JaxConfig(dict(keys, work_dir=str(
            tmp_path / "jax")))), ("torch", Config(dict(
                keys, work_dir=str(tmp_path / "torch"), device="cpu",
                netcdf_format="classic")))):
        build = jax_build if tag == "jax" else build_pipeline
        pipe = build(cfg)
        names[tag] = [s.name for s in pipe.steps]
    assert names["torch"] == names["jax"]
    assert {"plot_0", "plot_gpoints"} <= set(names["torch"])
    pipe.steps = [s for s in pipe.steps if s.name in
                  ("reorder_h2o", "find_g_points", "plot_gpoints")]
    pipe.run()
    png(str(tmp_path / "torch" / "lw_gpoints_lw_test_fsck.png"))
