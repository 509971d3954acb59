"""The port's workflow orchestrator (``ecckd_tpu_torch/pipeline``) against
the JAX package's on the CPU in float64.

The workflow is that of tests/test_pipeline.py (h2o, 512 wavenumbers, 6
profiles; reorder -> find_g_points -> create_lut, then a training file
from the JAX g-points, one optimize pass, run_ckd on a scenario and
evaluate_ckd), through both orchestrators on the same inputs, with
transmission averaging as there and with linear averaging.  Held: the
same steps, outputs and steps run; identical order and g-point ranks; the
raw LUT to 1e-10 (linear) and 1e-2 (transmission: the conditioning of
ROADMAP §3); the final LUT to 1e-6 (where the transmission LUTs differ,
no more than the raw LUTs do); the run_ckd fluxes and the stats; resume
and the one-step rerun; the preset cases of tests/test_presets.py by
steps and expanded keys; and the port's pipeline in a process without
h5py, in the classic container, from ``.spbin`` shards, bit for bit
against its NetCDF-4 run from the NetCDF spectrum.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ecckd_tpu.config import Config as JaxConfig
from ecckd_tpu.io import NcFile as JaxNcFile
from ecckd_tpu.pipeline.orchestrator import build_pipeline as jax_build
from ecckd_tpu_torch.config import Config
from ecckd_tpu_torch.io import NcFile
from ecckd_tpu_torch.io.shards import convert_spectrum_file
from ecckd_tpu_torch.pipeline.orchestrator import build_pipeline
from synth import (synth_lbl_flux_file, synth_scenario_file,
                   synth_spectrum_file)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODE = "lw_test_fsck"
STAGE1 = ("reorder_h2o", "find_g_points", "create_lut")
PACKAGES = {"jax": (JaxConfig, jax_build, {}),
            "torch": (Config, build_pipeline, {"device": "cpu"})}


def workflow_config(work, h2o, scen, method):
    """tests/test_pipeline.py's workflow configuration."""
    return {
        "mode": "lw", "application": "test", "band_structure": "fsck",
        "work_dir": work, "gases": "h2o", "tolerance": "0.3",
        "averaging_method": method, "h2o.input": h2o,
        "h2o.conc_dependence": "linear", "optimize_passes": "1",
        "pass1.gases": "h2o", "pass1.max_iterations": "10",
        "pass1.prior_error": "4.0", "evaluation_input": scen,
        "lbl_evaluation_fluxes": os.path.join(work, f"lw_fluxes_{CODE}_0.nc"),
    }


def run_steps(pipe, keep=None):
    """Run a pipeline (only the steps named in ``keep``, if given); returns
    the names of the steps that ran."""
    if keep is not None:
        pipe.steps = [s for s in pipe.steps if s.name in keep]
    ran = []
    for step in pipe.steps:
        def run(real=step.run, name=step.name):
            ran.append(name)
            real()
        step.run = run
    pipe.run()
    return ran


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("orchestrator")
    return dict(d=d, h2o=synth_spectrum_file(
        str(d / "h2o.h5"), molecule="h2o", nwav=512, ncol=6, seed=3),
        scen=synth_scenario_file(str(d / "scen.nc")))


@pytest.fixture(scope="module", params=["transmission", "linear"])
def workflows(request, inputs):
    method = request.param
    d = inputs["d"]
    out = {"method": method}
    training = str(d / f"training_{method}.nc")
    for tag, (cfg_cls, build, extra) in PACKAGES.items():
        work = str(d / f"work_{method}_{tag}")
        cfg = cfg_cls(dict(workflow_config(work, inputs["h2o"],
                                           inputs["scen"], method), **extra))
        steps = [(s.name, [os.path.relpath(o, work) for o in s.outputs])
                 for s in build(cfg).steps]
        ran1 = run_steps(build(cfg), STAGE1)
        if tag == "jax":
            synth_lbl_flux_file(training, [inputs["h2o"]], os.path.join(
                work, f"lw_gpoints_{CODE}.h5"), ["h2o"], iprofiles=(0, 2))
        cfg.set("pass1.training_input", training)
        ran2 = run_steps(build(cfg))
        out[tag] = dict(work=work, cfg=cfg, build=build, steps=steps,
                        ran=(ran1, ran2))
    return out


def read(work, name, var, nc=NcFile):
    with nc(os.path.join(work, name)) as f:
        return np.asarray(f.read(var))


def test_same_steps_outputs_and_runs(workflows):
    jax, port = workflows["jax"], workflows["torch"]
    assert port["steps"] == jax["steps"]
    assert [n for n, _ in port["steps"]] == list(STAGE1) + [
        "optimize_pass1", "run_ckd_0", "evaluate_0"]
    assert port["ran"] == jax["ran"] == (
        list(STAGE1), ["optimize_pass1", "run_ckd_0", "evaluate_0"])
    for name, outputs in port["steps"]:
        for out in outputs:
            assert os.path.exists(os.path.join(port["work"], out)), out


def test_identical_ranks(workflows):
    jax, port = workflows["jax"]["work"], workflows["torch"]["work"]
    np.testing.assert_array_equal(
        read(port, "lw_order_test_h2o.h5", "rank"),
        read(jax, "lw_order_test_h2o.h5", "rank", JaxNcFile))
    for var in ("h2o_rank1", "h2o_rank2", "g_point", "h2o_g_point",
                "band_number"):
        np.testing.assert_array_equal(
            read(port, f"lw_gpoints_{CODE}.h5", var),
            read(jax, f"lw_gpoints_{CODE}.h5", var, JaxNcFile), err_msg=var)


K = "h2o_molar_absorption_coeff"


def test_raw_lut(workflows):
    name = f"lw_raw-ckd-definition_{CODE}.nc"
    got = read(workflows["torch"]["work"], name, K)
    want = read(workflows["jax"]["work"], name, K, JaxNcFile)
    rtol = 1e-10 if workflows["method"] == "linear" else 1e-2
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_final_lut(workflows):
    jax, port = workflows["jax"]["work"], workflows["torch"]["work"]
    name = f"lw_ckd-definition_{CODE}.nc"
    got, want = read(port, name, K), read(jax, name, K, JaxNcFile)
    raw = f"lw_raw-ckd-definition_{CODE}.nc"
    raw_rel = np.abs(read(port, raw, K) / read(jax, raw, K, JaxNcFile) - 1)
    agree = raw_rel <= 1e-10
    assert workflows["method"] == "transmission" or np.all(agree)
    np.testing.assert_allclose(got[agree], want[agree], rtol=1e-6)
    rel = np.abs(got / want - 1)[~agree]
    assert np.all(rel <= np.maximum(raw_rel[~agree], 1e-6) * (1 + 1e-3))
    with NcFile(os.path.join(port, name)) as f, \
            JaxNcFile(os.path.join(jax, name)) as g:
        assert sorted(f.names()) == sorted(g.names())
        history = f.attribute("history")
        assert all(s in history for s in ("find_g_points", "create_lut",
                                          "optimize_lut"))
        assert f.attribute("model_id") == g.attribute("model_id") == CODE
        assert not f.exist(K + "_min")


def test_fluxes_and_stats(workflows):
    jax, port = workflows["jax"]["work"], workflows["torch"]["work"]
    name = f"lw_fluxes_{CODE}_0.nc"
    for var in ("flux_up_lw", "flux_dn_lw", "spectral_flux_up_lw",
                "spectral_flux_dn_lw", "optical_depth", "planck_hl"):
        np.testing.assert_allclose(read(port, name, var),
                                   read(jax, name, var, JaxNcFile),
                                   rtol=1e-6, atol=1e-6, err_msg=var)
    stats = []
    for work in (port, jax):
        with open(os.path.join(work, f"lw_stats_{CODE}_0.json")) as f:
            stats.append(json.load(f)["models"][0])
    for key, value in stats[1].items():
        if isinstance(value, float):
            assert stats[0][key] == pytest.approx(value, abs=1e-12), key
    assert stats[0]["n_g_points"] == stats[1]["n_g_points"] >= 1


def test_resume_and_one_step_rerun(workflows):
    """Last of the tests of ``workflows``: it reruns find_g_points."""
    ranks = {}
    for tag in ("jax", "torch"):
        run = workflows[tag]
        assert run_steps(run["build"](run["cfg"])) == [], tag
        gpoints = os.path.join(run["work"], f"lw_gpoints_{CODE}.h5")
        os.remove(gpoints)
        assert run_steps(run["build"](run["cfg"])) == ["find_g_points"], tag
        nc = JaxNcFile if tag == "jax" else NcFile
        ranks[tag] = read(run["work"], f"lw_gpoints_{CODE}.h5", "g_point",
                          nc)
    np.testing.assert_array_equal(ranks["torch"], ranks["jax"])


PRESET_CASES = {
    "climate-narrow": {"application": "climate", "band_structure": "narrow",
                       "tolerance": "0.013", "gases": "h2o ch4"},
    "climate-fsck": {"application": "climate", "band_structure": "fsck",
                     "tolerance": "0.0161", "gases": "h2o ch4"},
    "explicit-keys-win": {"application": "limited-area-nwp",
                          "band_structure": "wide", "tolerance": "0.0083",
                          "gases": "h2o", "min_pressure": "100",
                          "wavenumber1": "0 1000",
                          "wavenumber2": "1000 3260"},
    "unknown-application": {"application": "test", "band_structure": "fsck",
                            "tolerance": "0.04", "gases": "h2o"},
    "nwp-microwave": {"application": "nwp-microwave",
                      "band_structure": "fsck", "tolerance": "0.5",
                      "gases": "h2o", "h2o.conc_dependence": "linear"},
    "sw-rgb-passes-plots": {
        "mode": "sw", "application": "global-nwp", "band_structure": "rgb",
        "tolerance": "0.05", "gases": "h2o o3", "optimize_passes": "2",
        "scale_lblfile": "lbl.nc", "evaluation_input": "a.nc b.nc",
        "lbl_evaluation_fluxes": "ref.nc", "plots": "1"},
}


@pytest.mark.parametrize("case", sorted(PRESET_CASES))
def test_presets_expand_as_jax(case, tmp_path):
    got = {}
    for tag, (cfg_cls, build, extra) in PACKAGES.items():
        work = str(tmp_path / tag)
        keys = {"mode": "lw", "work_dir": work, **PRESET_CASES[case]}
        for gas in keys["gases"].split():
            keys[f"{gas}.input"] = "dummy.h5"
        cfg = cfg_cls(dict(keys, **extra))
        steps = [(s.name, [os.path.relpath(o, work) for o in s.outputs])
                 for s in build(cfg).steps]
        expanded = {k: cfg.read_string(k) for k in cfg.keys()
                    if k not in ("work_dir", "device")}
        got[tag] = (steps, expanded)
    assert got["torch"] == got["jax"]


def test_monochromatic_pipeline_runs(inputs, tmp_path):
    """tests/test_presets.py's nwp-microwave workflow on the port: no
    optimize step, the final model a copy of the raw LUT."""
    work = str(tmp_path / "w")
    cfg = Config({"mode": "lw", "application": "nwp-microwave",
                  "band_structure": "fsck", "work_dir": work,
                  "gases": "h2o", "tolerance": "0.5", "device": "cpu",
                  "h2o.input": inputs["h2o"],
                  "h2o.conc_dependence": "linear"})
    assert run_steps(build_pipeline(cfg)) == list(STAGE1) + ["finalize"]
    assert cfg.read_string("flux_weight") == "0.0"
    with open(os.path.join(work, "lw_ckd-definition_lw_nwp-microwave_fsck"
                           ".nc"), "rb") as a, \
            open(os.path.join(work, "lw_raw-ckd-definition_lw_nwp-microwave"
                              "_fsck.nc"), "rb") as b:
        assert a.read() == b.read()


_CLASSIC_FROM_SHARDS = r"""
import sys
sys.modules["h5py"] = None
from ecckd_tpu_torch.config import Config
from ecckd_tpu_torch.pipeline.orchestrator import build_pipeline
work, shard = sys.argv[1], sys.argv[2]
pipe = build_pipeline(Config({
    "mode": "lw", "application": "test", "band_structure": "fsck",
    "work_dir": work, "gases": "h2o", "tolerance": "0.3",
    "averaging_method": "transmission", "h2o.input": shard,
    "h2o.conc_dependence": "linear", "device": "cpu",
    "netcdf_format": "classic"}))
pipe.steps = [s for s in pipe.steps
              if s.name in ("reorder_h2o", "find_g_points", "create_lut")]
pipe.run()
assert sys.modules["h5py"] is None
print("ok")
"""


def test_classic_pipeline_without_h5py_from_shards(inputs, tmp_path):
    netcdf4 = str(tmp_path / "netcdf4")
    run_steps(build_pipeline(Config(dict(
        workflow_config(netcdf4, inputs["h2o"], inputs["scen"],
                        "transmission"), device="cpu"))), STAGE1)
    shard = convert_spectrum_file(inputs["h2o"], str(tmp_path / "h2o"))[0]
    classic = str(tmp_path / "classic")
    proc = subprocess.run(
        [sys.executable, "-c", _CLASSIC_FROM_SHARDS, classic, shard],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"
    for name, variables in (
            ("lw_order_test_h2o.h5", ("rank", "sorting_variable")),
            (f"lw_gpoints_{CODE}.h5", ("h2o_rank1", "h2o_rank2", "g_point",
                                       "h2o_error")),
            (f"lw_raw-ckd-definition_{CODE}.nc", (K, "planck_function",
                                                  "gpoint_fraction"))):
        with open(os.path.join(classic, name), "rb") as f:
            assert f.read(4) == b"CDF\x02", name
        for var in variables:
            a, b = read(classic, name, var), read(netcdf4, name, var)
            assert a.dtype == b.dtype, var
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                          err_msg=var)
