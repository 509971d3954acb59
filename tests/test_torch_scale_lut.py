"""scale_lut and reorder_cloud_spectrum of ecckd_tpu_torch against the JAX
tools, through files, on the CPU in float64.

scale_lut runs tests/test_aux_tools.py's TestScaleLut rig (a synthetic SW
model, an LBL file of direct fluxes through a random od at mu0 0.5):
both tools read the model file the JAX package writes; the scaled
``molar_abs`` agree to 1e-10, and each tool's file is read by the other
package's ``CkdModel.read``.  reorder_cloud_spectrum: the same ranks, band
numbers and sorting variable as the JAX tool (bit for bit: the same host
arithmetic), in one band and in two, and the port's order file gives the
port's find_g_points the same cloud pseudo-gas as the JAX tool's.
"""

import numpy as np
import pytest

from ecckd_tpu.config import Config
from ecckd_tpu.io import NcWriter, read_order as jread_order
from ecckd_tpu.models import CkdModel as JCkdModel
from ecckd_tpu.tools.reorder_cloud_spectrum import \
    reorder_cloud_spectrum as jreorder_cloud
from ecckd_tpu.tools.scale_lut import scale_lut as jscale_lut
from ecckd_tpu_torch.config import Config as TConfig
from ecckd_tpu_torch.models import CkdModel
from ecckd_tpu_torch.tools import find_g_points as tfgp
from ecckd_tpu_torch.tools.reorder_cloud_spectrum import (
    reorder_cloud_core, reorder_cloud_spectrum)
from ecckd_tpu_torch.tools.scale_lut import scale_lut, scale_lut_core
from synth import synth_spectrum_file, synth_sw_ckd_model

NLAY = 12
MU0 = 0.5
VMR = 5e-3


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """TestScaleLut's model and LBL file, and both tools' scaled files."""
    d = tmp_path_factory.mktemp("torch_scale_lut")
    model = synth_sw_ckd_model()
    ng = model.ng
    nwav = 400
    g_point = np.minimum((np.arange(nwav) * ng) // nwav, ng - 1)
    model.wavenumber_hr = np.linspace(300.0, 49000.0, nwav)
    model.g_point = g_point.astype(np.int32)
    model_path = str(d / "sw.nc")
    model.write(model_path, argv=["t"], config_str="")

    pressure_hl = np.exp(np.linspace(np.log(100.0), np.log(1e5), NLAY + 1))
    temperature_hl = np.linspace(220.0, 290.0, NLAY + 1)
    od_true = np.random.default_rng(5).gamma(0.5, 0.3, (NLAY, nwav))
    flux = np.empty((NLAY + 1, nwav))
    flux[0] = 1.0
    for i in range(NLAY):
        flux[i + 1] = flux[i] * np.exp(-od_true[i] / MU0)
    lbl_path = str(d / "lbl.nc")
    with NcWriter(lbl_path) as w:
        w.define_dimension("column", 1)
        w.define_dimension("mu0", 1)
        w.define_dimension("half_level", NLAY + 1)
        w.define_dimension("level", NLAY)
        w.define_dimension("gas", 1)
        w.define_dimension("wavenumber", nwav)
        w.define_variable("mu0", "double", "mu0")
        w.define_variable("pressure_hl", "double", "column", "half_level")
        w.define_variable("temperature_hl", "double", "column", "half_level")
        w.define_variable("mole_fraction_fl", "double", "column", "gas",
                          "level")
        w.define_variable("spectral_flux_dn_direct_sw", "double", "column",
                          "half_level", "wavenumber")
        w.write(np.array([MU0]), "mu0")
        w.write(pressure_hl[None], "pressure_hl")
        w.write(temperature_hl[None], "temperature_hl")
        w.write(np.full((1, 1, NLAY), VMR), "mole_fraction_fl")
        w.write(flux[None], "spectral_flux_dn_direct_sw")
        w.write_attribute("h2o", "constituent_id")
    out = {}
    for tag, tool, cfg_cls, dev in (("jax", jscale_lut, Config, {}),
                                    ("torch", scale_lut, TConfig,
                                     {"device": "cpu"})):
        out[tag] = str(d / f"sw_scaled_{tag}.nc")
        tool(cfg_cls({"input": model_path, "output": out[tag],
                      "lblfile": lbl_path, **dev}), argv=["scale_lut"])
    return dict(out, model=model_path, g_point=g_point, flux=flux,
                pressure_hl=pressure_hl, temperature_hl=temperature_hl)


def _molar_abs(model):
    return {g.molecule: np.asarray(g.molar_abs) for g in model.single_gas_data}


@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_scaled_lut_matches_jax(rig, reader):
    """The port's file against the JAX tool's, each read by ``reader``'s
    CkdModel."""
    read = JCkdModel.read if reader == "jax" else CkdModel.read
    want, got = (_molar_abs(read(rig[tag])) for tag in ("jax", "torch"))
    original = _molar_abs(read(rig["model"]))
    assert sorted(got) == sorted(want)
    for m in want:
        np.testing.assert_allclose(got[m], want[m], rtol=1e-10, atol=0)
        assert not np.array_equal(got[m], original[m])


def test_scaled_model_direct_flux(rig):
    """The JAX test's check on the core's result: where od_best is
    positive, the scaled model's od over od_best has a median near 1."""
    model = CkdModel.read(rig["model"])
    res = scale_lut_core(model, rig["g_point"], MU0, rig["pressure_hl"],
                         rig["temperature_hl"], np.full((1, NLAY), VMR),
                         ["h2o"], rig["flux"], device="cpu")
    assert res.model is not model
    np.testing.assert_array_equal(_molar_abs(model)["h2o"],
                                  _molar_abs(CkdModel.read(rig["model"]))
                                  ["h2o"])
    p, t = rig["pressure_hl"], rig["temperature_hl"]
    t_fl = 0.5 * (t[:-1] + t[1:])
    od = np.zeros_like(res.od_best)
    for gas in ("composite", "h2o"):
        idx = res.model.get_gas_index(gas)
        if idx >= 0:
            vmr = np.full((1, NLAY), VMR) if gas == "h2o" else None
            od += np.asarray(res.model.calc_optical_depth(
                idx, p[None], t_fl[None], vmr))[0]
    good = res.od_best > 1e-6
    assert abs(np.median(od[good] / res.od_best[good]) - 1.0) < 0.5
    onehot = (rig["g_point"][:, None] == np.arange(model.ng)).astype(float)
    flux_g = rig["flux"] @ onehot
    np.testing.assert_allclose(res.od_best,
                               -MU0 * np.log(flux_g[1:] / flux_g[:-1]),
                               rtol=1e-12)


def test_scale_lut_core_raises_without_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale_lut_core(None, [0], MU0, np.ones(2), np.ones(2),
                       np.ones((1, 1)), ["h2o"], np.ones((2, 1)))


# ------------------------------------------------------ reorder_cloud_spectrum

@pytest.fixture(scope="module")
def mie(tmp_path_factory):
    """tests/test_aux_tools.py's Mie file over the LW grid, and a gas
    spectrum whose grid the order takes."""
    d = tmp_path_factory.mktemp("torch_cloud")
    path = str(d / "mie.nc")
    cw = np.linspace(100.0, 2500.0, 50)
    with NcWriter(path) as w:
        w.define_dimension("size", 2)
        w.define_dimension("wavenumber", len(cw))
        w.define_variable("wavenumber", "double", "wavenumber")
        w.define_variable("single_scattering_albedo", "double", "size",
                          "wavenumber")
        w.define_variable("asymmetry_factor", "double", "size", "wavenumber")
        w.write(cw, "wavenumber")
        ssa = 0.5 + 0.45 * np.sin(cw / 400.0) ** 2
        w.write(np.vstack([ssa, ssa * 0.9]), "single_scattering_albedo")
        w.write(np.full((2, len(cw)), 0.85), "asymmetry_factor")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o", nwav=1024,
                              seed=3)
    return dict(d=d, mie=path, h2o=h2o)


def _cloud_orders(mie, tag, isize, bands):
    out = {}
    for package, tool, cfg_cls in (("jax", jreorder_cloud, Config),
                                   ("torch", reorder_cloud_spectrum,
                                    TConfig)):
        out[package] = str(mie["d"] / f"cloud_{tag}_{package}.h5")
        tool(cfg_cls({"input": mie["mie"], "isize": str(isize),
                      "wavenumber_input": mie["h2o"],
                      "output": out[package], **bands}),
             argv=["reorder_cloud_spectrum"])
    return out


@pytest.mark.parametrize("tag,isize,bands", [
    ("one", 0, {}), ("two", 1, {"wavenumber1": "0 900",
                                "wavenumber2": "900 2001"})])
def test_reorder_cloud_matches_jax(mie, tag, isize, bands):
    files = _cloud_orders(mie, tag, isize, bands)
    want, got = (jread_order(files[p]) for p in ("jax", "torch"))
    assert got.molecule == "cloud"
    for k in ("rank", "band_number", "sorting_variable", "wavenumber",
              "d_wavenumber", "wavenumber1_band", "wavenumber2_band"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    assert sorted(got.rank.tolist()) == list(range(len(got.rank)))


def test_reorder_cloud_core_ranks_within_bands():
    wav = np.linspace(1.0, 100.0, 64)
    cw = np.linspace(0.0, 120.0, 9)
    ssa = np.linspace(0.3, 0.99, 9)
    order = reorder_cloud_core(wav, np.gradient(wav), cw, ssa,
                               np.full(9, 0.8), [0.0, 50.0], [50.0, 101.0])
    band, rank, sv = (order[k] for k in ("band_number", "rank",
                                         "sorting_variable"))
    for j in range(2):
        idx = np.nonzero(band == j)[0]
        assert np.array_equal(np.sort(rank[idx]), idx)
        assert np.all(np.diff(sv[idx][np.argsort(rank[idx])]) >= 0)


def test_cloud_order_feeds_the_port(mie):
    """The port's order file and the JAX tool's give the port's
    find_g_points the same cloud pseudo-gas."""
    files = _cloud_orders(mie, "fgp", 0, {})
    ssi = np.random.default_rng(1).uniform(0.5, 1.5,
                                           len(jread_order(files["jax"]).rank))
    gases = {}
    for package, path in files.items():
        cloud = tfgp._read_cloud(TConfig({"cloud.reordering_input": path}),
                                 "cloud")
        gases[package] = tfgp._cloud_pseudo_gas(cloud, ssi)
    want, got = gases["jax"], gases["torch"]
    for k in ("n_g_points", "rank1", "rank2", "error", "sorting_variable",
              "g_point"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
