"""The three-tool LW chain (reorder_spectrum -> find_g_points -> create_lut)
of ecckd_tpu_torch against the JAX tools, through files, on the CPU in
float64.

The rig is that of tests/test_find_g_points.py (h2o and o3, 1024
wavenumbers, 15 layers, 5 profiles).  Held: identical order ranks;
identical g-point ranks, per-gas and merged g-point maps; the
ckd-definition LUT to rtol 1e-10; identical variable names, shapes, types
and attributes.  The global ``history`` and ``config`` attributes name the
run's own files and command, so only their presence is compared.

The per-g-point errors agree only to 1e-3 of the largest.  They are costs
of the search's last iterate, and the transmission fit of an optically
thick interval is ill-conditioned: its mean transmission sits within an ulp
of the 0.9999999999999999 clamp, where -log1p(-mean) amplifies a one-ulp
difference of the interval sums (which agree to 2e-16) into an od that
differs in the second digit.  Such a probe costs 0.3% differently in the
two packages, so the searches may take different steps to the same
ranks.
"""

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from ecckd_tpu.config import Config
from ecckd_tpu.io import NcFile
from ecckd_tpu.tools.create_lut import create_lut as jcreate_lut
from ecckd_tpu.tools.find_g_points import find_g_points as jfind_g_points
from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum as jreorder
from ecckd_tpu_torch.tools.create_lut import create_lut
from ecckd_tpu_torch.tools.find_g_points import find_g_points
from ecckd_tpu_torch.tools.reorder_spectrum import reorder_spectrum
from synth import synth_spectrum_file

CPU = {"device": "cpu"}
BANDS = {"wavenumber1": "1 900", "wavenumber2": "900 2000"}


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_chain")
    out = dict(d=d)
    out["h2o_2x"] = synth_spectrum_file(str(d / "h2o_2x.h5"),
                                        molecule="h2o", nwav=1024, seed=3,
                                        vmr_value=0.02)
    for gas, seed, vmr in (("h2o", 3, None), ("o3", 7, 1e-6)):
        spec = synth_spectrum_file(str(d / f"{gas}.h5"), molecule=gas,
                                   nwav=1024, seed=seed, vmr_value=vmr)
        out[gas] = spec
        for tag, tool, extra in (("jax", jreorder, {}),
                                 ("torch", reorder_spectrum, CPU)):
            for order, bands in (("order", {}), ("bands", BANDS)):
                path = str(d / f"{gas}_{order}_{tag}.h5")
                tool(Config({"input": spec, "output": path, **bands,
                             **extra}), argv=["reorder_spectrum"])
                out[f"{gas}_{order}_{tag}"] = path
    return out


def _fgp_config(rig, tag, output, gases, extra, order):
    cfg = {"output": output, "gases": " ".join(gases),
           "heating_rate_tolerance": "0.4", "tolerance_tolerance": "0.02",
           "max_iterations": "30", "averaging_method": "transmission",
           "flux_weight": "0.02", **extra}
    others = {"h2o": "o3", "o3": "h2o"}
    for g in gases:
        cfg[f"{g}.reordering_input"] = rig[f"{g}_{order}_{tag}"]
        cfg[f"{g}.input"] = rig[g]
        if len(gases) > 1:
            cfg[f"{g}.background_input"] = rig[others[g]]
    return Config(cfg)


def _run_chain(rig, name, gases, extra, lut_methods=(), order="order"):
    out = {}
    for tag, fgp, lut, dev in (("jax", jfind_g_points, jcreate_lut, {}),
                               ("torch", find_g_points, create_lut, CPU)):
        gp = str(rig["d"] / f"{name}_gpoints_{tag}.h5")
        fgp(_fgp_config(rig, tag, gp, gases, {**extra, **dev}, order),
            argv=["find_g_points"])
        out[tag] = gp
        for method in lut_methods:
            path = str(rig["d"] / f"{name}_lut_{method}_{tag}.nc")
            lut(Config({"input": gp, "output": path, "gases": "h2o",
                        "averaging_method": method,
                        "h2o.conc_dependence": "linear",
                        "h2o.input": rig["h2o"], **dev}),
                argv=["create_lut"])
            out[f"lut_{method}_{tag}"] = path
    return out


@pytest.fixture(scope="module")
def two_gas(rig):
    return _run_chain(rig, "two_gas", ("h2o", "o3"), {})


@pytest.fixture(scope="module")
def h2o_lut(rig):
    return _run_chain(rig, "h2o", ("h2o",), {},
                      lut_methods=("linear", "transmission"))


def _schema(path):
    """{name: (shape, dtype, attributes)} of every dataset, plus the
    global attribute names; dimension-list references are compared by
    presence only."""
    def attrs(obj):
        out = {}
        for k, v in obj.attrs.items():
            if k in ("DIMENSION_LIST", "REFERENCE_LIST"):
                out[k] = None
            elif isinstance(v, np.ndarray):
                out[k] = v.tolist()
            else:
                out[k] = v
        return out

    with h5py.File(path, "r") as f:
        data = {k: (ds.shape, ds.dtype.str, attrs(ds))
                for k, ds in f.items() if isinstance(ds, h5py.Dataset)}
        glob = {k: (None if k in ("history", "config") else v)
                for k, v in attrs(f).items()}
    return data, glob


def _assert_same_schema(a, b):
    assert _schema(a) == _schema(b)


@pytest.mark.parametrize("order", ["order", "bands"])
@pytest.mark.parametrize("gas", ["h2o", "o3"])
def test_order_ranks_identical(rig, gas, order):
    a = NcFile(rig[f"{gas}_{order}_jax"])
    b = NcFile(rig[f"{gas}_{order}_torch"])
    np.testing.assert_array_equal(a.read("rank"), b.read("rank"))
    np.testing.assert_array_equal(a.read("band_number"),
                                  b.read("band_number"))
    np.testing.assert_allclose(b.read("sorting_variable"),
                               a.read("sorting_variable"), rtol=1e-6)
    a.close()
    b.close()
    _assert_same_schema(rig[f"{gas}_{order}_jax"],
                        rig[f"{gas}_{order}_torch"])


def _assert_same_g_points(out, gases):
    a, b = NcFile(out["jax"]), NcFile(out["torch"])
    for name in ["band_number", "g_point", "wavenumber1_band",
                 "wavenumber2_band"] + [
            f"{g}_{v}" for g in gases
            for v in ("n_g_points", "band_number", "rank1", "rank2",
                      "g_min", "g_max", "g_point", "sorting_variable")]:
        np.testing.assert_array_equal(b.read(name), a.read(name), name)
    for g in gases:
        ea, eb = a.read(f"{g}_error"), b.read(f"{g}_error")
        assert np.abs(eb - ea).max() <= 1e-3 * np.abs(ea).max()
    a.close()
    b.close()
    _assert_same_schema(out["jax"], out["torch"])


def test_two_gases_with_backgrounds(two_gas):
    _assert_same_g_points(two_gas, ("h2o", "o3"))


@pytest.mark.parametrize("name,extra", [
    ("min_g_points", {"heating_rate_tolerance": "1000.0",
                      "h2o.min_g_points": "5"}),
    ("base_split", {"h2o.base_split": "3"}),
])
def test_overrides(rig, name, extra):
    _assert_same_g_points(_run_chain(rig, name, ("h2o",), extra), ("h2o",))


def test_two_bands(rig):
    """One candidate-cost kernel per band, on its slice of the ranks."""
    _assert_same_g_points(_run_chain(rig, "bands", ("h2o", "o3"), {},
                                     order="bands"), ("h2o", "o3"))


# The LUT is written in float32, so rtol 1e-10 means the same float32
# values.  The transmission average of a g-point whose mean transmission
# lies within ~20 ulp of 1 (optically thick layers) has the conditioning of
# the interval fit above: there 1e-2 is the bar.
@pytest.mark.parametrize("method,rtol", [("linear", 1e-10),
                                         ("transmission", 1e-2)])
def test_ckd_definition_file(h2o_lut, method, rtol):
    _assert_same_g_points(h2o_lut, ("h2o",))
    _assert_same_lut(*(h2o_lut[f"lut_{method}_{t}"] for t in ("jax",
                                                              "torch")),
                     rtol=rtol)


def _assert_same_lut(ja, jb, rtol):
    a, b = NcFile(ja), NcFile(jb)
    assert sorted(a.names()) == sorted(b.names())
    for name in a.names():
        va, vb = np.asarray(a.read(name)), np.asarray(b.read(name))
        if va.dtype.kind == "f":
            np.testing.assert_allclose(vb, va, rtol=rtol, err_msg=name)
        else:
            np.testing.assert_array_equal(vb, va, name)
    a.close()
    b.close()
    _assert_same_schema(ja, jb)


@pytest.mark.parametrize("cd", ["none", "relative-linear", "lut"])
def test_create_lut_conc_dependence(rig, h2o_lut, cd):
    """The other concentration dependences, from the same g-point file;
    linear averaging, so the float32 LUT values are identical."""
    keys = {
        "none": {"gases": "composite", "composite.conc_dependence": "none",
                 "composite.input": f"{rig['h2o']} {rig['o3']}"},
        "relative-linear": {"gases": "h2o",
                            "h2o.conc_dependence": "relative-linear",
                            "h2o.reference_conc": "0.005",
                            "h2o.input": rig["h2o"]},
        "lut": {"gases": "h2o", "h2o.conc_dependence": "lut",
                "h2o.input": f"{rig['h2o']} {rig['h2o_2x']}"},
    }[cd]
    paths = []
    for tag, tool, dev in (("jax", jcreate_lut, {}),
                           ("torch", create_lut, CPU)):
        path = str(rig["d"] / f"lut_{cd}_{tag}.nc")
        tool(Config({"input": h2o_lut["jax"], "output": path,
                     "averaging_method": "linear", **keys, **dev}),
             argv=["create_lut"])
        paths.append(path)
    _assert_same_lut(*paths, rtol=1e-10)


def test_cli_entry_point(rig, tmp_path):
    """``python -m ecckd_tpu_torch.tools.reorder_spectrum key=value ...``
    runs through ``main`` and exits 0 with the JAX tool's ranks."""
    from ecckd_tpu_torch.tools.reorder_spectrum import main
    out = str(tmp_path / "order.h5")
    assert main([f"input={rig['h2o']}", f"output={out}", "device=cpu"]) == 0
    with NcFile(out) as a, NcFile(rig["h2o_order_jax"]) as b:
        np.testing.assert_array_equal(a.read("rank"), b.read("rank"))


@pytest.mark.parametrize("tool", ["reorder_spectrum", "find_g_points",
                                  "create_lut"])
def test_profile_dir_writes_the_spans_of_every_thread(rig, h2o_lut, tmp_path,
                                                      tool):
    """With ``profile_dir`` each tool writes a profile holding the port's
    spans: find_g_points' band searches on their threads
    (``band_parallel=parallel`` over two bands), create_lut's block reads
    on the prefetch thread (``streaming=1``)."""
    from ecckd_tpu_torch.config import Config as TConfig
    trace = tmp_path / "trace.json"
    keys = {"profile_dir": str(tmp_path), **CPU}
    if tool == "reorder_spectrum":
        reorder_spectrum(TConfig({"input": rig["h2o"], "output": str(
            tmp_path / "order.h5"), **keys}), argv=[tool])
        want, threaded = "ecckd.reorder.sort", None
    elif tool == "find_g_points":
        cfg = _fgp_config(rig, "torch", str(tmp_path / "gp.h5"), ("h2o",),
                          {"band_parallel": "parallel", **keys}, "bands")
        find_g_points(cfg, argv=[tool])
        want, threaded = "ecckd.find_g_points.store", \
            "ecckd.find_g_points.search"
    else:
        create_lut(TConfig({"input": h2o_lut["torch"], "output": str(
            tmp_path / "lut.nc"), "gases": "h2o", "h2o.input": rig["h2o"],
            "h2o.conc_dependence": "linear", "streaming": "1",
            "streaming_block_wav": "256", **keys}), argv=[tool])
        want, threaded = "ecckd.create_lut.finish", "ecckd.io.read_block"
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "ecckd_span"]
    names = {e["name"] for e in events}
    assert want in names
    if threaded is not None:
        main = {e["tid"] for e in events if e["name"].endswith(".core")}
        assert len(main) == 1
        assert {e["tid"] for e in events if e["name"] == threaded} - main


def test_port_never_imports_jax(tmp_path):
    """Importing the port and running its array-level chain leaves jax out
    of the process."""
    code = """
import sys
import numpy as np
import torch
from ecckd_tpu_torch.tools.reorder_spectrum import reorder_core
from ecckd_tpu_torch.tools.find_g_points import GasInput, find_g_points_core
from ecckd_tpu_torch.tools.create_lut import LutGas, create_lut_core
from ecckd_tpu_torch.models import ConcDependence
from types import SimpleNamespace
nlay, nwav = 6, 256
p = np.exp(np.linspace(np.log(100.0), np.log(1.013e5), nlay + 1))
t = np.linspace(210.0, 284.0, nlay + 1)
wav = np.linspace(1.0, 2000.0, nwav)
dwav = np.gradient(wav)
k = 1e-4 + 50.0 / (1.0 + ((wav - 700.0) / 40.0) ** 2)
od = np.diff(p)[:, None] * 1e-5 * k[None, :]
o = reorder_core(p, wav, dwav, od, device="cpu")
g = find_g_points_core([GasInput("h2o", o["rank"], o["band_number"],
    o["wavenumber1_band"], o["wavenumber2_band"], o["sorting_variable"],
    p, t, wav, dwav, od)], 1.0, averaging_method="transmission",
    device="cpu")
sp = SimpleNamespace(pressure_hl=p, temperature_hl=t, wavenumber=wav,
                     d_wavenumber=dwav, optical_depth=od, ncol=1)
m = create_lut_core(g.g_point, g.wavenumber1_band, g.wavenumber2_band,
                       g.band_number, [LutGas("h2o", ConcDependence.LINEAR,
                                              [lambda i: (sp, 0.01)])],
                       device="cpu")
assert np.all(np.isfinite(m.single_gas_data[0].molar_abs))
print("jax" in sys.modules)
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"
