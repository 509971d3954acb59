"""The three-tool SW chain (reorder_spectrum -> find_g_points ->
create_lut) of ecckd_tpu_torch against the JAX tools, through files, on
the CPU in float64.

The rig is that of tests/test_sw_pipeline.py: h2o over 250-50000 cm-1,
1024 wavenumbers, 15 layers, 6 profiles, the synthetic solar spectrum; one
band, and two bands split at 10000 cm-1 (the lower band reflects the
direct beam in the cost, the upper does not).  Held: identical order
ranks (sorting variable to rtol 1e-6); identical per-gas and merged
g-point ranks and maps, identical ``solar_irradiance`` and schema, for
total-transmission over one and two bands, with the cloud pseudo-gas, and
for transmission; g-point errors to 1e-3 of the largest
(tests/test_torch_pipeline.py says why); the same ``debug_partition``
lines on stderr; the ckd-definition file's linear LUT, Rayleigh
coefficients and solar irradiances to rtol 1e-10 and its transmission LUT
to 1e-2 (the clamp conditioning of ROADMAP.md, faults).

Two properties of the JAX package on the CPU shape the rig (ROADMAP.md,
faults).  XLA flushes subnormal floats to zero, and the total-transmission
fit falls back to the linear fit where a broadband flux is zero, so the
port runs here with ``torch.set_flush_denormal(True)``; without it, a flux
that is subnormal is not zero and the fit differs (the reference's C++ and
the card keep subnormals).  And the equipartition search compares costs
that are equal in exact arithmetic, which the two packages' f64 sums break
in different directions: at heating_rate_tolerance 0.8, the JAX rig's own,
the one-band search ends one rank apart.  The tolerances below give
searches without such ties; :func:`test_tie_case` pins the one that has
one.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ecckd_tpu.config import Config
from ecckd_tpu.constants import ACCEL_GRAVITY, MOLAR_MASS_DRY_AIR
from ecckd_tpu.io import NcFile, NcWriter, read_spectrum
from ecckd_tpu.tools.create_lut import create_lut as jcreate_lut
from ecckd_tpu.tools.find_g_points import find_g_points as jfind_g_points
from ecckd_tpu.tools.reorder_cloud_spectrum import reorder_cloud_spectrum
from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum as jreorder
from ecckd_tpu_torch.tools.create_lut import create_lut
from ecckd_tpu_torch.tools.find_g_points import find_g_points
from ecckd_tpu_torch.tools.reorder_spectrum import reorder_spectrum
from synth import synth_spectrum_file, synth_ssi_file
from test_torch_pipeline import _assert_same_lut, _assert_same_schema

CPU = {"device": "cpu"}
BANDS = {"wavenumber1": "250 10000", "wavenumber2": "10000 50000"}
TOOLS = {"jax": (jreorder, jfind_g_points, jcreate_lut, {}),
         "torch": (reorder_spectrum, find_g_points, create_lut, CPU)}


def _cloud_order(d, h2o):
    """A cloud order file as tests/test_aux_tools.py builds one, on the SW
    grid."""
    mie = str(d / "mie.nc")
    cw = np.linspace(200.0, 50500.0, 50)
    with NcWriter(mie) as w:
        w.define_dimension("size", 2)
        w.define_dimension("wavenumber", len(cw))
        w.define_variable("wavenumber", "double", "wavenumber")
        w.define_variable("single_scattering_albedo", "double", "size",
                          "wavenumber")
        w.define_variable("asymmetry_factor", "double", "size",
                          "wavenumber")
        w.write(cw, "wavenumber")
        ssa = 0.5 + 0.45 * np.sin(cw / 4000.0) ** 2
        w.write(np.vstack([ssa, ssa * 0.9]), "single_scattering_albedo")
        w.write(np.full((2, len(cw)), 0.85), "asymmetry_factor")
    out = str(d / "cloud_order.h5")
    reorder_cloud_spectrum(Config({"input": mie, "isize": "0",
                                   "wavenumber_input": h2o, "output": out}),
                           argv=["reorder_cloud_spectrum"])
    return out


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sw_chain")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o", nwav=1024,
                              ncol=6, seed=11, is_sw=True)
    ssi, _ = synth_ssi_file(str(d / "ssi.h5"),
                            read_spectrum(h2o, 0).wavenumber)
    out = dict(d=d, h2o=h2o, ssi=ssi, cloud=_cloud_order(d, h2o))
    for tag, (reorder, _, _, dev) in TOOLS.items():
        for order, bands in (("order", {}), ("bands", BANDS)):
            path = str(d / f"{order}_{tag}.h5")
            reorder(Config({"input": h2o, "output": path, "ssi": ssi,
                            "threshold_optical_depth": "0.25", **bands,
                            **dev}), argv=["reorder_spectrum"])
            out[f"{order}_{tag}"] = path
    return out


@contextlib.contextmanager
def _flush_subnormals():
    """The floating-point environment of XLA on the CPU."""
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _find_g_points(rig, name, method, tol, order="order", cloud=False):
    """Both packages' g-point files, with debug_partition on; the stderr
    lines of each run are kept beside its file."""
    out = {}
    for tag, (_, fgp, _, dev) in TOOLS.items():
        path = str(rig["d"] / f"{name}_gpoints_{tag}.h5")
        cfg = {"output": path, "gases": "h2o", "ssi": rig["ssi"],
               "heating_rate_tolerance": str(tol),
               "averaging_method": method,
               "debug_partition": "1",
               "h2o.reordering_input": rig[f"{order}_{tag}"],
               "h2o.input": rig["h2o"], "h2o.min_scaling": "0.5",
               "h2o.max_scaling": "2.0", **dev}
        if cloud:
            cfg.update({"cloud": "cloud", "cloud.reordering_input":
                        rig["cloud"]})
        err = io.StringIO()
        with contextlib.redirect_stderr(err), _flush_subnormals():
            fgp(Config(cfg), argv=["find_g_points"])
        out[tag] = path
        out[f"stderr_{tag}"] = err.getvalue()
    return out


@pytest.fixture(scope="module")
def total_trans(rig):
    out = _find_g_points(rig, "tt", "total-transmission", 1.0)
    for tag, (_, _, lut, dev) in TOOLS.items():
        for method in ("linear", "transmission"):
            path = str(rig["d"] / f"lut_{method}_{tag}.nc")
            with _flush_subnormals():
                lut(Config({"input": out[tag], "output": path,
                            "gases": "h2o", "ssi": rig["ssi"],
                            "averaging_method": method,
                            "h2o.conc_dependence": "linear",
                            "h2o.input": rig["h2o"], **dev}),
                    argv=["create_lut"])
            out[f"lut_{method}_{tag}"] = path
    return out


@pytest.fixture(scope="module")
def transmission(rig):
    return _find_g_points(rig, "trans", "transmission", 3.0)


@pytest.mark.parametrize("order", ["order", "bands"])
def test_order_ranks_identical(rig, order):
    with NcFile(rig[f"{order}_jax"]) as a, NcFile(rig[f"{order}_torch"]) as b:
        np.testing.assert_array_equal(a.read("rank"), b.read("rank"))
        np.testing.assert_array_equal(a.read("band_number"),
                                      b.read("band_number"))
        np.testing.assert_allclose(b.read("sorting_variable"),
                                   a.read("sorting_variable"), rtol=1e-6)
    _assert_same_schema(rig[f"{order}_jax"], rig[f"{order}_torch"])


def _assert_same_g_points(out, gases=("h2o",)):
    with NcFile(out["jax"]) as a, NcFile(out["torch"]) as b:
        for name in ["band_number", "g_point", "wavenumber1_band",
                     "wavenumber2_band", "solar_irradiance"] + [
                f"{g}_{v}" for g in gases
                for v in ("n_g_points", "band_number", "rank1", "rank2",
                          "g_min", "g_max", "g_point", "sorting_variable")]:
            np.testing.assert_array_equal(b.read(name), a.read(name), name)
        for g in gases:
            ea, eb = a.read(f"{g}_error"), b.read(f"{g}_error")
            assert np.abs(eb - ea).max() <= 1e-3 * np.abs(ea).max()
        si = a.read("solar_irradiance")
        assert np.all(si > 0)
        np.testing.assert_allclose(si.sum(), 1361.0, rtol=1e-6)
    _assert_same_schema(out["jax"], out["torch"])


def test_total_transmission_one_band(total_trans):
    _assert_same_g_points(total_trans)


def test_total_transmission_two_bands(rig):
    out = _find_g_points(rig, "tt_bands", "total-transmission", 0.5,
                         "bands")
    _assert_same_g_points(out)
    with NcFile(out["torch"]) as f:
        assert set(f.read("h2o_band_number")) == {0, 1}


def test_transmission(transmission):
    _assert_same_g_points(transmission)


def test_cloud_pseudo_gas(rig):
    out = _find_g_points(rig, "cloud", "total-transmission", 1.0,
                         cloud=True)
    _assert_same_g_points(out, gases=("cloud", "h2o"))


def test_tie_case(rig):
    """At the JAX rig's tolerance the one-band search meets a tie that the
    two packages' sums break differently: the same number of g-points,
    bounds at most one rank apart, errors within the tolerance's 20%."""
    out = _find_g_points(rig, "tie", "total-transmission", 0.8)
    with NcFile(out["jax"]) as a, NcFile(out["torch"]) as b:
        r1a, r1b = a.read("h2o_rank1"), b.read("h2o_rank1")
        assert len(r1a) == len(r1b)
        assert np.abs(r1a.astype(int) - r1b).max() <= 1
        assert np.abs(a.read("h2o_error") - b.read("h2o_error")).max() \
            <= 0.2 * 0.8
    _assert_same_schema(out["jax"], out["torch"])


def _debug_values(text):
    """{(band, tag, key, n): values} of the debug_partition lines; ``n``
    counts the g-points.  The JAX tool prints the total-transmission tags
    sorted (HIGH, LOW, MID; its pytree map sorts them), the port in the
    reference's order (LOW, HIGH, MID)."""
    out = {}
    band = tag = None
    for line in text.splitlines():
        key, _, values = line.strip().partition(" = ")
        if not key.startswith("debug_partition"):
            continue
        if key.endswith("_band"):
            band = int(values)
        elif key.startswith("debug_partition_"):
            tag = key[len("debug_partition_"):]
        else:
            n = sum(k[:3] == (band, tag, key) for k in out)
            out[(band, tag, key, n)] = np.array(values.strip("[]").split(),
                                                float)
    return out


@pytest.mark.parametrize("run", ["total_trans", "transmission"])
def test_debug_partition(request, run):
    """The per-g-point cost components on stderr: the JAX tool's lines,
    LOW/HIGH/MID sections for total-transmission only, values to 1e-3 of
    the largest value of their key (the errors' bar; a component of a
    near-exact fit is a difference of nearly equal fluxes)."""
    out = request.getfixturevalue(run)
    got = _debug_values(out["stderr_torch"])
    want = _debug_values(out["stderr_jax"])
    assert sorted(got) == sorted(want)
    assert "debug_partition_H2O_band = 0" in out["stderr_torch"]
    tags = {k[1] for k in got}
    assert tags == ({"LOW", "HIGH", "MID"} if run == "total_trans"
                    else {None})
    assert {k[2] for k in got} == {
        f"debug_partition.{key}" for key in (
            "flux_dn_surf_true", "flux_dn_surf_fit", "flux_up_toa_true",
            "flux_up_toa_fit", "hr_true", "hr_fit", "cf_hr", "cf_flux")}
    scale = {}
    for k, w in want.items():
        scale[k[2]] = max(scale.get(k[2], 0.0), np.abs(w).max())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-3 * scale[k[2]], err_msg=str(k))


def test_ckd_definition_file(rig, total_trans):
    """The linear LUT, Rayleigh coefficients and solar irradiances to rtol
    1e-10 (the file is float32, so: the same float32 values).  In the
    transmission LUT a g-point's od is -log(1 - mean transmission)/1.66;
    where the mean lies within exp(-1.66 od) of 1, a few ulp of it move the
    od by ulp * exp(1.66 od) / 1.66 (ROADMAP.md, faults: 21.71 against
    22.13 at the clamp).  Each entry is held to 8 such ulp plus one float32
    ulp, which is 1e-7 at od 10 and 3% at od 20."""
    _assert_same_lut(*(total_trans[f"lut_linear_{t}"] for t in ("jax",
                                                               "torch")),
                     rtol=1e-10)
    ja, jb = (total_trans[f"lut_transmission_{t}"] for t in ("jax", "torch"))
    _assert_same_schema(ja, jb)
    sp = read_spectrum(rig["h2o"], 0)
    # od of each (profile, layer, g-point) entry per unit molar coefficient
    od_per_k = (0.01 * np.diff(sp.pressure_hl)
                / (ACCEL_GRAVITY * 0.001 * MOLAR_MASS_DRY_AIR))
    with NcFile(ja) as a, NcFile(jb) as b:
        assert sorted(a.names()) == sorted(b.names())
        for name in a.names():
            va, vb = np.asarray(a.read(name)), np.asarray(b.read(name))
            if name != "h2o_molar_absorption_coeff":
                np.testing.assert_allclose(vb, va, rtol=1e-10, err_msg=name)
                continue
            x = 1.66 * va * od_per_k[None, :, None]
            bound = 1.2e-7 + 8 * np.finfo(float).eps * np.exp(x) / x
            assert np.all(np.abs(vb - va) <= bound * np.abs(va))
        assert np.all(b.read("rayleigh_molar_scattering_coeff") >= 0)
        np.testing.assert_allclose(b.read("solar_irradiance").sum(), 1361.0,
                                   rtol=1e-6)


def test_sw_cores_never_import_jax(tmp_path):
    """The SW array cores (reorder, total-transmission search over two
    bands, SW create_lut) run with jax out of the process."""
    code = """
import sys
import numpy as np
from types import SimpleNamespace
from ecckd_tpu_torch.models import ConcDependence
from ecckd_tpu_torch.tools.create_lut import (LutGas, SolarSpectrum,
                                              create_lut_core)
from ecckd_tpu_torch.tools.find_g_points import GasInput, find_g_points_core
from ecckd_tpu_torch.tools.reorder_spectrum import reorder_core
nlay, nwav = 6, 256
p = np.exp(np.linspace(np.log(100.0), np.log(1.013e5), nlay + 1))
t = np.linspace(210.0, 284.0, nlay + 1)
wav = np.linspace(250.0, 50000.0, nwav)
dwav = np.gradient(wav)
k = 1e-4 + 50.0 / (1.0 + ((wav - 7000.0) / 900.0) ** 2)
od = np.diff(p)[:, None] * 1e-5 * k[None, :]
ssi = np.exp(-((wav - 20000.0) / 15000.0) ** 2)
ssi *= 1361.0 / ssi.sum()
o = reorder_core(p, wav, dwav, od, [250.0, 10000.0], [10000.0, 50000.0],
                 do_sw=True, device="cpu")
g = find_g_points_core([GasInput("h2o", o["rank"], o["band_number"],
    o["wavenumber1_band"], o["wavenumber2_band"], o["sorting_variable"],
    p, t, wav, dwav, od)], 0.5, averaging_method="total-transmission",
    ssi=ssi, device="cpu")
sp = SimpleNamespace(pressure_hl=p, temperature_hl=t, wavenumber=wav,
                     d_wavenumber=dwav, optical_depth=od, ncol=1)
m = create_lut_core(g.g_point, g.wavenumber1_band, g.wavenumber2_band,
                    g.band_number, [LutGas("h2o", ConcDependence.LINEAR,
                                           [lambda i: (sp, 0.01)])],
                    solar=SolarSpectrum(ssi, 1361.0, wav),
                    solar_irradiance=g.solar_irradiance, device="cpu")
assert m.is_sw() and np.all(np.isfinite(m.rayleigh_molar_scat))
assert np.all(np.isfinite(m.single_gas_data[0].molar_abs))
print("jax" in sys.modules)
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"
