"""The port's small tools against the JAX package's, on the CPU.

merge_spectra, convert_spectra, summarize_g_points, export_ckdmip and
test_equipartition, each run beside its JAX original on the same inputs:
the same files (merge_spectra within 1e-10, which for its float32 optical
depth means the same values; convert_spectra byte for byte), the same
lines printed and the same files exported.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from ecckd_tpu.config import Config as JConfig
from ecckd_tpu.io import NcFile
from ecckd_tpu_torch.config import Config
from synth import synth_spectrum_file
from test_torch_pipeline import _assert_same_schema


@pytest.fixture(scope="module")
def spectra(tmp_path_factory):
    d = tmp_path_factory.mktemp("small_tools")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o",
                              nwav=512, ncol=3, seed=3)
    o3 = synth_spectrum_file(str(d / "o3.h5"), molecule="o3",
                             nwav=512, ncol=3, seed=7, vmr_value=1e-6)
    return dict(d=d, h2o=h2o, o3=o3)


@pytest.mark.parametrize("keys", [{}, {"scaling": "0.5 1.0"},
                                  {"conc": "0.02 2e-6"}])
def test_merge_spectra(spectra, tmp_path, keys):
    from ecckd_tpu.tools.merge_spectra import merge_spectra as jmerge
    from ecckd_tpu_torch.tools.merge_spectra import merge_spectra
    inputs = f"{spectra['h2o']} {spectra['o3']}"
    a, b = str(tmp_path / "jax.h5"), str(tmp_path / "torch.h5")
    jmerge(JConfig({"output": a, "input": inputs, **keys}), argv=["m"])
    merge_spectra(Config({"output": b, "input": inputs, **keys}),
                  argv=["m"])
    with NcFile(a) as fa, NcFile(b) as fb:
        assert sorted(fa.names()) == sorted(fb.names())
        for name in ("pressure_hl", "temperature_hl", "wavenumber",
                     "optical_depth"):
            va, vb = fa.read(name), fb.read(name)
            np.testing.assert_allclose(vb, va, rtol=1e-10, err_msg=name)
        assert fb.read("optical_depth").shape[0] == 3
        for attr in ("title", "molecule"):
            assert fb.attribute(attr) == fa.attribute(attr)
    _assert_same_schema(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_convert_spectra(spectra, tmp_path, dtype):
    """The port's convert_spectra writes the JAX tool's shards byte for
    byte."""
    from ecckd_tpu.tools.convert_spectra import convert_spectra as jconvert
    from ecckd_tpu_torch.tools.convert_spectra import convert_spectra
    keys = {"input": spectra["h2o"], "iprofiles": "0 2", "dtype": dtype}
    ja = jconvert(JConfig({**keys, "out_prefix": str(tmp_path / "jax")}))
    tb = convert_spectra(Config({**keys,
                                 "out_prefix": str(tmp_path / "torch")}))
    assert [os.path.basename(p) for p in tb] == ["torch_000.spbin",
                                                 "torch_002.spbin"]
    for a, b in zip(ja, tb):
        assert Path(a).read_bytes() == Path(b).read_bytes()


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """tests/test_aux_tools.py's export artifacts: a g-point file and a
    LUT of the JAX chain."""
    from ecckd_tpu.tools.create_lut import create_lut
    from ecckd_tpu.tools.find_g_points import find_g_points
    from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum
    d = tmp_path_factory.mktemp("export")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), nwav=512, ncol=3)
    order = str(d / "o.h5")
    reorder_spectrum(JConfig({"input": h2o, "output": order}), argv=["r"])
    gp = str(d / "g.h5")
    find_g_points(JConfig({
        "output": gp, "gases": "h2o", "heating_rate_tolerance": "0.4",
        "averaging_method": "transmission", "h2o.reordering_input": order,
        "h2o.input": h2o}), argv=["f"])
    lut = str(d / "lw_ckd-definition_climate_fsck-tol0.4.nc")
    create_lut(JConfig({
        "input": gp, "output": lut, "gases": "h2o",
        "averaging_method": "transmission", "h2o.conc_dependence": "linear",
        "h2o.input": h2o}), argv=["c"])
    return dict(d=d, gp=gp, lut=lut, spectrum=h2o)


def test_summarize_g_points(artifacts, capsys):
    from ecckd_tpu.tools import summarize_g_points as jsum
    from ecckd_tpu_torch.tools import summarize_g_points as tsum
    files = [artifacts["gp"], artifacts["lut"], artifacts["spectrum"]]
    lines = tsum.summarize_g_points(files)
    assert lines == jsum.summarize_g_points(files)
    assert "h2o =" in lines[0] and "g_point =" in lines[1]
    assert lines[2].startswith("no g-point metadata")
    capsys.readouterr()
    assert tsum.main(files[:1]) == jsum.main(files[:1]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == lines[0]
    assert tsum.main([]) == 1


@pytest.mark.parametrize("companions", [False, True])
def test_export_ckdmip(artifacts, tmp_path, companions):
    import shutil
    from ecckd_tpu.tools.export_ckdmip import export_ckdmip as jexport
    from ecckd_tpu_torch.tools.export_ckdmip import export_ckdmip
    keys = {"input": artifacts["lut"], "mode": "lw",
            "application": "climate", "band_structure": "fsck",
            "tolerance": "0.4", "ng_suffix": "b"}
    if companions:
        comp_dir = tmp_path / "fluxes"
        comp_dir.mkdir()
        for name in ("ecckd_evaluation1_lw_climate_fsck-tol0.4_"
                     "fluxes-4angle_present.nc",
                     "ecckd_lw_climate_fsck-tol0.4_od.nc",
                     "unrelated.nc"):
            shutil.copyfile(artifacts["lut"], comp_dir / name)
        keys["companions"] = str(comp_dir)
    written = {}
    for tag, tool, cfg in (("jax", jexport, JConfig), ("torch",
                                                      export_ckdmip,
                                                      Config)):
        root = tmp_path / tag
        written[tag] = [os.path.relpath(p, root) for p in tool(
            cfg({**keys, "results_dir": str(root)}), argv=["e"])]
        for rel in written[tag]:
            assert (root / rel).read_bytes() == Path(
                artifacts["lut"]).read_bytes()
    assert written["torch"] == written["jax"]
    assert len(written["torch"]) == (3 if companions else 1)


def test_test_equipartition(capsys):
    """The ramp partition of src/ecckd/test_equipartition.cpp: the same
    status, bounds, errors and statistics printed, and the same exit
    code."""
    from ecckd_tpu.tools.test_equipartition import test_equipartition as j
    from ecckd_tpu_torch.tools.test_equipartition import \
        test_equipartition as t
    keys = {"npoints": "20000", "n_intervals": "8",
            "partition_tolerance": "0.01"}
    rc_j = j(JConfig(keys))
    out_j = capsys.readouterr().out
    rc_t = t(Config(keys))
    out_t = capsys.readouterr().out
    assert rc_t == rc_j == 0
    assert out_t == out_j
    assert "***STATUS***" in out_t and "frac range" in out_t


def test_equipartition_exports():
    """EpStatus and ep_stats come from the port's partition package, as
    test_equipartition imports them."""
    from ecckd_tpu.partition import ep_stats as jstats
    from ecckd_tpu_torch.partition import EpStatus, ep_stats
    err = np.array([1.0, 2.0, 1.5, 0.5])
    assert ep_stats(err) == jstats(err)
    assert EpStatus.SUCCESS.describe()
