"""The port's evaluation tools (``ecckd_tpu_torch/evaluate/metrics.py``,
``tools/evaluate_ckd.py``) against the JAX package's on the same files:
the heating rates, the weighted heating-rate errors, the six flux
statistics, the accuracy-efficiency table and evaluate_ckd's JSON, to
1e-12, with the files in either NetCDF container for the port."""

import json

import numpy as np
import pytest

from ecckd_tpu.config import Config as JaxConfig
from ecckd_tpu.evaluate import metrics as jax_metrics
from ecckd_tpu.io.ncio import NcWriter as JaxNcWriter
from ecckd_tpu.tools.evaluate_ckd import evaluate_ckd as jax_evaluate_ckd
from ecckd_tpu_torch.config import Config
from ecckd_tpu_torch.evaluate import metrics
from ecckd_tpu_torch.io.ncio import NcWriter
from ecckd_tpu_torch.tools import evaluate_ckd as evaluate_tool

NCOL, NHL = 4, 16
rng = np.random.default_rng(23)
P_HL = np.tile(np.exp(np.linspace(np.log(2.0), np.log(1.013e5), NHL)),
               (NCOL, 1))
FLUX_DN = np.cumsum(rng.uniform(2, 8, (NCOL, NHL)), axis=1)
FLUX_UP = FLUX_DN[:, ::-1] + rng.uniform(20, 40, (NCOL, 1))


def write_fluxes(writer, up, dn, names=("flux_up_lw", "flux_dn_lw")):
    with writer as w:
        w.define_dimension("column", NCOL)
        w.define_dimension("half_level", NHL)
        for name in ("pressure_hl",) + names:
            w.define_variable(name, "double", "column", "half_level")
        w.write(P_HL, "pressure_hl")
        for name, flux in zip(names, (up, dn)):
            w.write(flux, name)
    return writer.path


def write_definition(writer, ng):
    with writer as w:
        w.define_dimension("g_point", ng)
        w.define_dimension("wavenumber", 5)
        w.define_variable("gpoint_fraction", "float", "g_point",
                          "wavenumber")
        w.write(np.full((ng, 5), 1.0 / ng), "gpoint_fraction")
    return writer.path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("evaluate")
    out = {"ref": write_fluxes(JaxNcWriter(str(d / "lbl.nc")), FLUX_UP,
                               FLUX_DN)}
    for i, scale in enumerate((0.3, 1.1)):
        up = FLUX_UP + rng.normal(0, scale, (NCOL, NHL))
        dn = FLUX_DN + rng.normal(0, scale, (NCOL, NHL))
        out[f"ckd{i}"] = write_fluxes(JaxNcWriter(str(d / f"ckd{i}.nc")),
                                      up, dn)
        out[f"ckd{i}_classic"] = write_fluxes(
            NcWriter(str(d / f"ckd{i}_classic.nc"), format="classic"), up,
            dn)
        out[f"def{i}"] = write_definition(
            JaxNcWriter(str(d / f"def{i}.nc")), 16 * (i + 1))
    out["ref_classic"] = write_fluxes(
        NcWriter(str(d / "lbl_classic.nc"), format="classic"), FLUX_UP,
        FLUX_DN)
    out["sw_direct"] = write_fluxes(JaxNcWriter(str(d / "sw.nc")), FLUX_DN,
                                    FLUX_DN, ("flux_dn_direct_sw",))
    return out


def close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12)
    else:
        assert got == want


def test_heating_rates_equal_jax():
    hr = metrics.calc_hr(FLUX_DN, FLUX_UP, P_HL)
    np.testing.assert_allclose(hr, jax_metrics.calc_hr(FLUX_DN, FLUX_UP,
                                                       P_HL),
                               rtol=1e-12, atol=0)
    hr_ref = hr * (1.0 + 0.01 * rng.normal(size=hr.shape))
    for prange in ((0.0, np.inf), metrics.HIGH_PRESSURE_RANGE,
                   metrics.LOW_PRESSURE_RANGE, (1e6, 2e6)):
        close(metrics.calc_hr_error(0.01 * P_HL, hr, hr_ref, prange),
              jax_metrics.calc_hr_error(0.01 * P_HL, hr, hr_ref, prange))


def test_flux_stats_equal_jax():
    ckd = {"pressure_hl": P_HL, "flux_up_lw": FLUX_UP + 0.5,
           "flux_dn_lw": FLUX_DN - 0.25 * rng.random((NCOL, NHL))}
    ref = {"pressure_hl": P_HL, "flux_up_lw": FLUX_UP,
           "flux_dn_lw": FLUX_DN}
    got = metrics.flux_stats(ref, ckd)
    close(got, jax_metrics.flux_stats(ref, ckd))
    assert metrics.format_stats(got, "m") == jax_metrics.format_stats(got,
                                                                      "m")


@pytest.mark.parametrize("container", ["netcdf4", "classic"])
def test_accuracy_table_equals_jax(files, container):
    tag = "" if container == "netcdf4" else "_classic"
    got = metrics.accuracy_efficiency_table(
        files["ref" + tag], [files["ckd0" + tag], files["ckd1" + tag]],
        ckd_definition_files=[files["def0"], files["def1"]])
    want = jax_metrics.accuracy_efficiency_table(
        files["ref"], [files["ckd0"], files["ckd1"]],
        ckd_definition_files=[files["def0"], files["def1"]])
    for row in got + want:
        row.pop("file")
    close(got, want)
    assert [r["n_g_points"] for r in got] == [16, 32]


@pytest.mark.parametrize("container", ["netcdf4", "classic"])
def test_evaluate_ckd_json_equals_jax(files, tmp_path, container):
    tag = "" if container == "netcdf4" else "_classic"
    keys = dict(ckd_definitions=f"{files['def0']} {files['def1']}",
                model_names="narrow wide")
    jax_evaluate_ckd(JaxConfig(dict(
        ref_fluxes=files["ref"], output=str(tmp_path / "jax.json"),
        ckd_fluxes=f"{files['ckd0']} {files['ckd1']}", **keys)))
    argv = [f"ref_fluxes={files['ref' + tag]}",
            f"ckd_fluxes={files['ckd0' + tag]} {files['ckd1' + tag]}",
            f"output={tmp_path / 'port.json'}"] + [
        f"{k}={v}" for k, v in keys.items()]
    assert evaluate_tool.main(argv) == 0
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    for table in (got, want):
        table.pop("ref_fluxes")
        for row in table["models"]:
            row.pop("file")
    close(got, want)
    assert [r["model"] for r in got["models"]] == ["narrow", "wide"]


def test_self_comparison_is_exactly_zero(files):
    stats = metrics.evaluate_fluxes(files["ref"], files["ref_classic"])
    assert all(v == 0.0 for v in stats.values())


def test_refusals_equal_jax(files):
    """A flux file without the band's up and down fluxes (run_ckd's SW
    output has only the direct beam) is refused alike; so are a missing
    ckd_fluxes key and mismatched lists."""
    for mod in (metrics, jax_metrics):
        with pytest.raises(KeyError, match="not a SW flux file"):
            mod.evaluate_fluxes(files["ref"], files["sw_direct"], "sw")
    for cfg in ({"ref_fluxes": files["ref"]},
                {"ref_fluxes": files["ref"], "ckd_fluxes": files["ckd0"],
                 "ckd_definitions": f"{files['def0']} {files['def1']}"}):
        with pytest.raises(ValueError) as port:
            evaluate_tool.evaluate_ckd(Config(dict(cfg)))
        with pytest.raises(ValueError) as jax:
            jax_evaluate_ckd(JaxConfig(dict(cfg)))
        assert str(port.value) == str(jax.value)
