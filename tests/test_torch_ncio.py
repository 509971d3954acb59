"""The port's NetCDF layer (``ecckd_tpu_torch/io/ncio.py``) in both
containers: NetCDF-4 through h5py, as the JAX package writes it, and the
classic CDF-2 container through ``scipy.io.netcdf_file``, for a machine
without h5py.

Held: one schema written by the JAX writer (NetCDF-4) and by the port's
writer in each container reads back with equal arrays, shapes, attributes
and history; a classic file is written and read with h5py blocked, and
NetCDF-4 then raises; the classic container's limits (no string type, one
unlimited dimension that leads, 4 GiB a variable) raise; its unlimited
dimension grows; arrays outlive ``close``; and the port's reorder,
find_g_points and create_lut write the same numbers in both containers.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

from ecckd_tpu.config import Config
from ecckd_tpu.io.ncio import NcWriter as JaxNcWriter
from ecckd_tpu_torch.io import ncio
from ecckd_tpu_torch.io.ncio import NcFile, NcWriter
from ecckd_tpu_torch.tools.create_lut import create_lut
from ecckd_tpu_torch.tools.find_g_points import find_g_points
from ecckd_tpu_torch.tools.reorder_spectrum import reorder_spectrum
from synth import synth_spectrum_file

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
rng = np.random.default_rng(17)
DATA = {
    "a": rng.normal(size=(3, 4)),
    "t": rng.normal(size=(2, 4)).astype(np.float32),
    "n": np.arange(4, dtype=np.int32),
    "s": np.array([-3, 0, 7, 2], np.int16),
    "b": np.array([-1, 2, 3, 4], np.int8),
}
ATTRS = {"title": "A schema", "empty": "", "config": "x=1\ny=é",
         "dbl": 1.25, "count": 3}


def write_schema(writer):
    """The schema of the tools: fixed and unlimited dimensions, every
    numeric type, a variable that shares a dimension's name without being
    its coordinate, a scalar, text, empty, numeric and history
    attributes."""
    with writer as w:
        w.define_dimension("column", None)
        w.define_dimension("wavenumber", 4)
        w.define_dimension("temperature", 2)
        w.define_variable("a", "double", "column", "wavenumber")
        w.define_variable("temperature", "float", "temperature",
                          "wavenumber")
        w.define_variable("wavenumber", "int", "wavenumber")
        w.define_variable("s", "short", "wavenumber", deflate=2)
        w.define_variable("b", "byte", "wavenumber")
        w.define_variable("n_gases", "int")
        for i in range(3):
            w.write(DATA["a"][i], "a", index=i)
        w.write(DATA["t"], "temperature")
        w.write(DATA["n"], "wavenumber")
        w.write(DATA["s"], "s")
        w.write(DATA["b"], "b")
        w.write(5, "n_gases")
        w.write_units("K", "temperature")
        w.write_long_name("Temperature", "temperature")
        for name, value in ATTRS.items():
            w.write_attribute(value, name)
        w.append_history(["tool", "key=1"])
    return w.path


VAR_ATTRS = ("units", "long_name", "comment", "definition")


def read_all(path):
    """({variable: (data, shape)}, global attributes, {variable: its
    netCDF attributes})."""
    with NcFile(path) as f:
        names = sorted(f.names())
        names = [n.replace("_nc4_non_coord_", "") for n in names]
        names = [n for n in names if f.exist(n)]
        out = {n: (f.read(n), f.size(n)) for n in names}
        attrs = f.global_attributes()
        var_attrs = {n: {a: f.attribute(a, n) for a in VAR_ATTRS}
                     for n in names}
    return out, attrs, var_attrs


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ncio")
    return {
        "jax": write_schema(JaxNcWriter(str(d / "jax.nc"))),
        "netcdf4": write_schema(NcWriter(str(d / "nc4.nc"))),
        "classic": write_schema(NcWriter(str(d / "classic.nc"),
                                         format="classic")),
    }


@pytest.mark.parametrize("kind", ["netcdf4", "classic"])
def test_schema_reads_back_as_the_jax_file(files, kind):
    want, want_attrs, want_var_attrs = read_all(files["jax"])
    got, got_attrs, got_var_attrs = read_all(files[kind])
    assert sorted(got) == sorted(want)
    for name, (data, shape) in want.items():
        assert got[name][1] == shape, name
        np.testing.assert_array_equal(got[name][0], data)
        assert np.asarray(got[name][0]).dtype == np.asarray(data).dtype
    np.testing.assert_array_equal(got["a"][0], DATA["a"])
    assert got["n_gases"][0] == 5 and type(got["n_gases"][0]) is int
    assert got_var_attrs == want_var_attrs
    assert got_var_attrs["temperature"]["units"] == "K"
    assert got_var_attrs["temperature"]["long_name"] == "Temperature"
    assert {k: v for k, v in got_attrs.items() if k != "history"} == {
        k: v for k, v in want_attrs.items() if k != "history"} == ATTRS
    assert got_attrs["history"].endswith(": tool key=1")
    assert want_attrs["history"].endswith(": tool key=1")


def test_container_is_told_by_its_first_bytes(files):
    magic = {k: open(p, "rb").read(4) for k, p in files.items()}
    assert magic == {"jax": b"\x89HDF", "netcdf4": b"\x89HDF",
                     "classic": b"CDF\x02"}
    assert type(NcFile(files["classic"])) is ncio._ClassicFile
    assert type(NcFile(files["netcdf4"])) is NcFile
    with pytest.raises(FileNotFoundError):
        NcFile(files["classic"] + ".missing")


def test_arrays_outlive_close(files):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        f = NcFile(files["classic"])
        a, part = f.read("a"), f.read_slice("a", 1, 1, 3)
        row, t = f.read("a", 2), f.read("temperature")
        f.close()
    np.testing.assert_array_equal(a, DATA["a"])
    a[...] = 0.0        # an array of its own, writable
    np.testing.assert_array_equal(part, DATA["a"][1, 1:3])
    np.testing.assert_array_equal(row, DATA["a"][2])
    np.testing.assert_array_equal(t, DATA["t"])
    assert a.dtype.isnative and t.dtype.isnative


def test_classic_unlimited_dimension_grows(tmp_path):
    path = str(tmp_path / "grow.nc")
    with NcWriter(path, format="classic") as w:
        w.define_dimension("column", None)
        w.define_dimension("x", 3)
        w.define_variable("v", "double", "column", "x")
        w.define_variable("c", "int", "column")
        w.write([1.0, 2.0, 3.0], "v", index=0)
        w.write([4.0, 5.0, 6.0], "v", index=2)   # record 1 skipped
        w.write([7, 8, 9], "c")
    with NcFile(path) as f:
        np.testing.assert_array_equal(
            f.read("v"), [[1, 2, 3], [0, 0, 0], [4, 5, 6]])
        np.testing.assert_array_equal(f.read("c"), [7, 8, 9])
        assert f.size("v") == (3, 3)


def test_classic_limits_raise(tmp_path):
    w = NcWriter(str(tmp_path / "limits.nc"), format="classic")
    w.define_dimension("record", None)
    w.define_dimension("x", 2)
    w.define_dimension("big", 2 ** 29)
    with pytest.raises(ValueError, match="no string type"):
        w.define_variable("name", "string", "x")
    with pytest.raises(ValueError, match="no string type"):
        w.write("text", "name")
    with pytest.raises(ValueError, match="one unlimited dimension"):
        w.define_dimension("other", None)
    with pytest.raises(ValueError, match="must be the first"):
        w.define_variable("v", "float", "x", "record")
    with pytest.raises(ValueError, match="4 GiB"):
        w.define_variable("huge", "double", "big")
    w.define_variable("ok", "float", "record", "big")   # 2 GiB a record
    w.close()
    with pytest.raises(ValueError, match="not understood"):
        NcWriter(str(tmp_path / "x.nc"), format="netcdf3")


def test_classic_deflate_is_noted_once(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ncio, "_deflate_noted", False)
    for i in range(2):
        write_schema(NcWriter(str(tmp_path / f"d{i}.nc"), format="classic"))
    assert capsys.readouterr().out.count("no compression") == 1


def test_netcdf4_without_h5py_raises(tmp_path, files, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="netcdf_format=classic"):
        NcWriter(str(tmp_path / "x.nc"))
    with pytest.raises(ImportError, match="netcdf_format=classic"):
        NcFile(files["netcdf4"])
    write_schema(NcWriter(str(tmp_path / "c.nc"), format="classic"))
    with NcFile(str(tmp_path / "c.nc")) as f:
        np.testing.assert_array_equal(f.read("b"), DATA["b"])


_NO_H5PY = r"""
import sys
sys.modules["h5py"] = None
import numpy as np
from ecckd_tpu_torch.io.ncio import NcFile, NcWriter
path = sys.argv[1]
with NcWriter(path, format="classic") as w:
    w.define_dimension("x", 3)
    w.define_variable("v", "double", "x")
    w.write([1.0, 2.0, 3.0], "v")
    w.write_attribute("", "empty")
    w.append_history(["tool"])
with NcFile(path) as f:
    assert f.read("v").tolist() == [1.0, 2.0, 3.0]
    assert f.attribute("empty") == "" and f.attribute("history")
with NcFile(sys.argv[2]) as f:
    assert f.read("b").tolist() == [-1, 2, 3, 4]
try:
    NcWriter(path + ".nc4")
except ImportError as err:
    assert "netcdf_format=classic" in str(err)
else:
    raise AssertionError("NetCDF-4 written without h5py")
assert sys.modules["h5py"] is None
print("ok")
"""


def test_classic_without_h5py_in_a_fresh_process(tmp_path, files):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_H5PY, str(tmp_path / "c.nc"),
         files["classic"]], cwd=str(tmp_path), env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_common_reads_the_format():
    from ecckd_tpu_torch.tools.common import netcdf_format
    assert netcdf_format(None) == "netcdf4"
    assert netcdf_format(Config({})) == "netcdf4"
    assert netcdf_format(Config({"netcdf_format": "classic"})) == "classic"
    with pytest.raises(ValueError, match="netcdf_format"):
        netcdf_format(Config({"netcdf_format": "cdf5"}))


@pytest.fixture(scope="module")
def tool_files(tmp_path_factory):
    """reorder -> find_g_points -> create_lut of the port, each in both
    containers, on the LW rig of tests/test_torch_pipeline.py."""
    d = tmp_path_factory.mktemp("ncio_tools")
    spec = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o", nwav=1024,
                               seed=3)
    out = {}
    for fmt in ("netcdf4", "classic"):
        common = {"device": "cpu", "netcdf_format": fmt}
        order = str(d / f"order_{fmt}.h5")
        reorder_spectrum(Config({"input": spec, "output": order, **common}),
                         argv=["reorder_spectrum"])
        gpoints = str(d / f"gpoints_{fmt}.h5")
        find_g_points(Config({
            "output": gpoints, "gases": "h2o", "heating_rate_tolerance": "0.4",
            "averaging_method": "transmission", "h2o.input": spec,
            "h2o.reordering_input": order, **common}),
            argv=["find_g_points"])
        lut = str(d / f"lut_{fmt}.nc")
        create_lut(Config({"input": gpoints, "output": lut, "gases": "h2o",
                           "h2o.input": spec,
                           "h2o.conc_dependence": "linear", **common}),
                   argv=["create_lut"])
        out[fmt] = dict(order=order, gpoints=gpoints, lut=lut)
    return out


@pytest.mark.parametrize("kind", ["order", "gpoints", "lut"])
def test_tools_write_the_same_numbers_in_both_containers(tool_files, kind):
    a, b = tool_files["netcdf4"][kind], tool_files["classic"][kind]
    assert open(a, "rb").read(4) == b"\x89HDF"
    assert open(b, "rb").read(4) == b"CDF\x02"
    want, want_attrs, want_var_attrs = read_all(a)
    got, got_attrs, got_var_attrs = read_all(b)
    assert sorted(got) == sorted(want)
    for name, (data, shape) in want.items():
        assert got[name][1] == shape, name
        np.testing.assert_array_equal(got[name][0], data, err_msg=name)
    assert got_var_attrs == want_var_attrs
    assert sorted(got_attrs) == sorted(want_attrs)
    for key in set(want_attrs) - {"history", "config"}:
        assert got_attrs[key] == want_attrs[key], key
