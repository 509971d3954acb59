"""The port's optimisation and evaluation of a CKD model against the JAX
package, on the CPU in float64.

The same inputs, made from a seed, go through both packages:
* ``LblFluxes`` reads (LW and SW, band mapping, boundary fluxes, the
  erythemal spectrum), ``subtract``, ``mask_rayleigh_up`` and
  ``calc_ckd_fluxes``;
* ``cost_ckd_lw`` / ``cost_ckd_sw``, value and gradient, over the weight
  cases of tests/test_cost_functions.py, per profile and over a column
  axis (normwise 1e-10);
* the full training cost (``make_cost_fn`` + ``make_prior_fn``), value and
  gradient, on an LW and an SW scene with relative-to fluxes, exact-zero
  coefficients and, in SW, Rayleigh active (1e-10);
* ``optimize_lut`` (file tool, scipy) on tests/test_optimize.py's rig: 20
  iterations in both, the same iteration count, the cost within 1e-8 and
  the LUT within 1e-6; then the improvement and bounds checks of
  tests/test_optimize.py on the port, checkpoints (the port's own and
  JAX's), and the port's float32 against its float64 (PARITY.md's 1e-3);
* ``run_ckd`` (file tool) LW and SW, with a gas scaling and
  ``write_od_only``: every output variable (1e-12).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecckd_tpu.config import Config as JConfig
from ecckd_tpu.io import NcFile, NcWriter
from ecckd_tpu.io.lbl_fluxes import LblFluxes as JLblFluxes
from ecckd_tpu.models import CkdModel as JCkdModel
from ecckd_tpu.ops import cost as jcost
from ecckd_tpu.optimize import cost_fn as jcost_fn
from ecckd_tpu.optimize import solver as jsolver
from ecckd_tpu.tools import optimize_lut as joptimize
from ecckd_tpu.tools.create_lut import create_lut as jcreate_lut
from ecckd_tpu.tools.find_g_points import find_g_points as jfind_g_points
from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum as jreorder
from ecckd_tpu.tools.run_ckd import run_ckd as jrun_ckd
from ecckd_tpu_torch.config import Config
from ecckd_tpu_torch.io.lbl_fluxes import LblFluxes
from ecckd_tpu_torch.models import CkdModel
from ecckd_tpu_torch.ops import cost as tcost
from ecckd_tpu_torch.optimize import solver as tsolver
from ecckd_tpu_torch.optimize.solver import TrainingCost, ravel_tree
from ecckd_tpu_torch.scripts.train_step import precision_levels
from ecckd_tpu_torch.tools import optimize_lut as toptimize
from ecckd_tpu_torch.tools.run_ckd import run_ckd
from synth import (synth_lbl_flux_file, synth_lw_ckd_model,
                   synth_scenario_file, synth_spectrum_file,
                   synth_sw_ckd_model, synth_sw_lbl_flux_file)

CPU = {"device": "cpu"}


def _normwise(got, want):
    got, want = np.ravel(np.asarray(got)), np.ravel(np.asarray(want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------- rigs

@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """tests/test_optimize.py's pipeline rig through the JAX tools: h2o,
    1024 wavenumbers, 6 profiles; training fluxes of profiles 0, 2, 4."""
    d = tmp_path_factory.mktemp("torch_opt")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o",
                              nwav=1024, ncol=6, seed=3)
    order = str(d / "order.h5")
    jreorder(JConfig({"input": h2o, "output": order}), argv=["r"])
    gpoints = str(d / "gpoints.h5")
    jfind_g_points(JConfig({
        "output": gpoints, "gases": "h2o",
        "heating_rate_tolerance": "0.2",
        "averaging_method": "transmission",
        "h2o.reordering_input": order, "h2o.input": h2o,
    }), argv=["find_g_points"])
    lut = str(d / "lut_raw.nc")
    jcreate_lut(JConfig({
        "input": gpoints, "output": lut, "gases": "h2o",
        "averaging_method": "transmission",
        "h2o.conc_dependence": "linear", "h2o.input": h2o,
    }), argv=["create_lut"])
    training = str(d / "training.nc")
    synth_lbl_flux_file(training, [h2o], gpoints, ["h2o"],
                        iprofiles=(0, 2, 4))
    return dict(d=d, h2o=h2o, gpoints=gpoints, lut=lut, training=training)


def _write_gpoint_map(path, nwav, ng):
    g_point = (np.arange(nwav) * ng) // nwav
    with NcWriter(path) as w:
        w.define_dimension("wavenumber", nwav)
        w.define_variable("g_point", "short", "wavenumber")
        w.write(g_point, "g_point")
    return g_point


def _flux_file(path, kind, seed=0):
    """A CKDMIP-style flux file with band fluxes over 4 narrow bands and
    boundary fluxes on a 64-wavenumber grid (what tests/synth.py's files
    lack): LW, or SW with 5 zenith angles."""
    rng = np.random.default_rng(seed)
    ncol, nlay, nband, nwav = 2, 7, 4, 64
    p_hl = np.tile(np.exp(np.linspace(np.log(100.0), np.log(1e5), nlay + 1)),
                   (ncol, 1))
    t_hl = np.tile(np.linspace(220.0, 290.0, nlay + 1), (ncol, 1))
    sw = kind == "sw"
    lead = (ncol, 5) if sw else (ncol,)
    up = np.abs(rng.normal(5, 1, lead + (nlay + 1, nband)))
    dn = np.abs(rng.normal(5, 1, lead + (nlay + 1, nband)))
    wav = (np.linspace(3000.0, 49000.0, nwav) if sw
           else np.linspace(10.0, 2000.0, nwav))
    edges = np.linspace(wav[0], wav[-1], nband + 1)
    with NcWriter(path) as w:
        w.define_dimension("column", ncol)
        if sw:
            w.define_dimension("mu0", 5)
            w.define_variable("mu0", "double", "mu0")
            w.write(np.array([0.9, 0.7, 0.5, 0.3, 0.1]), "mu0")
        w.define_dimension("half_level", nlay + 1)
        w.define_dimension("level", nlay)
        w.define_dimension("gas", 2)
        w.define_dimension("band", nband)
        w.define_dimension("wavenumber", nwav)
        dims = ("column", "mu0") if sw else ("column",)
        for name, data in (("pressure_hl", p_hl), ("temperature_hl", t_hl)):
            w.define_variable(name, "double", "column", "half_level")
            w.write(data, name)
        w.define_variable("mole_fraction_fl", "double", "column", "gas",
                          "level")
        w.write(np.full((ncol, 2, nlay), 1e-3), "mole_fraction_fl")
        x = "sw" if sw else "lw"
        dn_name = "flux_dn_direct_sw" if sw else "flux_dn_lw"
        w.define_variable(f"flux_up_{x}", "double", *dims, "half_level")
        w.define_variable(dn_name, "double", *dims, "half_level")
        w.write(up.sum(-1), f"flux_up_{x}")
        w.write(dn.sum(-1), dn_name)
        band_dn = "band_flux_dn_direct_sw" if sw else "band_flux_dn_lw"
        w.define_variable(f"band_flux_up_{x}", "double", *dims,
                          "half_level", "band")
        w.define_variable(band_dn, "double", *dims, "half_level", "band")
        w.write(up, f"band_flux_up_{x}")
        w.write(dn, band_dn)
        w.define_variable(f"band_wavenumber1_{x}", "double", "band")
        w.define_variable(f"band_wavenumber2_{x}", "double", "band")
        w.write(edges[:-1], f"band_wavenumber1_{x}")
        w.write(edges[1:], f"band_wavenumber2_{x}")
        w.define_variable("wavenumber", "double", "wavenumber")
        w.write(wav, "wavenumber")
        surf = "spectral_flux_dn_direct_surf_sw" if sw \
            else "spectral_flux_dn_surf_lw"
        w.define_variable(surf, "double", *dims, "wavenumber")
        w.define_variable(f"spectral_flux_up_toa_{x}", "double", *dims,
                          "wavenumber")
        w.write(np.abs(rng.normal(1, 0.2, lead + (nwav,))), surf)
        w.write(np.abs(rng.normal(1, 0.2, lead + (nwav,))),
                f"spectral_flux_up_toa_{x}")
        w.write_attribute("h2o co2-x", "constituent_id")
    return path


_LBL_FIELDS = ("pressure_hl", "temperature_hl", "vmr_fl", "flux_up",
               "flux_dn", "spectral_flux_up", "spectral_flux_dn",
               "spectral_flux_dn_surf", "spectral_flux_up_toa",
               "heating_rate", "spectral_heating_rate", "mu0",
               "effective_spectral_albedo", "surf_emissivity",
               "erythemal_spectrum", "band_wavenumber1", "band_wavenumber2",
               "gas_mapping")


def _assert_same_lbl(t, j):
    """Identical fields, but the erythemal spectrum: it is weighted by each
    package's own Planck function, which agree to rounding (1e-12)."""
    for name in _LBL_FIELDS:
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if name == "erythemal_spectrum" and a is not None:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=name)
        elif a is not None:
            np.testing.assert_array_equal(a, b, name)
    for name in ("molecules", "tsi", "is_sw", "have_spectral_fluxes",
                 "have_band_fluxes"):
        assert getattr(t, name) == getattr(j, name), name


# ------------------------------------------------------------ LblFluxes

def test_lbl_fluxes_lw_read(rig):
    """synth_lbl_flux_file read by both packages, with the g-point map."""
    with NcFile(rig["gpoints"]) as f:
        g_point = np.asarray(f.read("g_point"), np.int64)
    t = LblFluxes.read(rig["training"], g_point=g_point)
    j = JLblFluxes.read(rig["training"], g_point=g_point)
    _assert_same_lbl(t, j)
    assert t.ncol == 3 and not t.is_sw
    np.testing.assert_allclose(t.spectral_heating_rate.sum(-1),
                               t.heating_rate, rtol=1e-6)
    for m in (t, j):
        m.make_gas_mapping(["co2", "h2o", "o3"])
    _assert_same_lbl(t, j)


def test_lbl_fluxes_sw_read(tmp_path):
    """synth_sw_lbl_flux_file: the three zenith angles {0, 2, 4} become
    pseudo-columns, the effective albedo and tsi follow."""
    h2o = synth_spectrum_file(str(tmp_path / "h2o.h5"), nwav=256, ncol=3,
                              nlay=8, seed=5, is_sw=True)
    gp = str(tmp_path / "gp.h5")
    _write_gpoint_map(gp, 256, 6)
    ssi = np.linspace(1.0, 9.0, 256)
    path = synth_sw_lbl_flux_file(str(tmp_path / "sw.nc"), [h2o], gp,
                                  ["h2o"], ssi, iprofiles=(0, 2))
    t, j = LblFluxes.read(path), JLblFluxes.read(path)
    _assert_same_lbl(t, j)
    assert t.ncol == 6
    np.testing.assert_allclose(t.mu0[:3], [0.9, 0.5, 0.1])


@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_lbl_fluxes_bands_and_boundaries(tmp_path, kind):
    """Band fluxes mapped from 4 narrow to 2 wide bands, boundary fluxes
    mapped to g-points, the erythemal spectrum (SW), renamed molecules;
    then subtract and mask_rayleigh_up."""
    path = _flux_file(str(tmp_path / f"{kind}.nc"), kind)
    gp = str(tmp_path / "gp.h5")
    g_point = _write_gpoint_map(gp, 64, 5)
    band_mapping = np.array([0, 0, 1, 1])
    t = LblFluxes.read(path, band_mapping, g_point)
    j = JLblFluxes.read(path, band_mapping, g_point)
    _assert_same_lbl(t, j)
    assert t.nspec() == 2 and t.molecules == ["h2o", "co2"]
    assert t.spectral_flux_dn_surf.shape == (t.ncol, 5)
    if kind == "sw":
        assert t.ncol == 6 and np.all(t.erythemal_spectrum >= 0)
    src_t = LblFluxes.read(path, band_mapping, g_point)
    src_j = JLblFluxes.read(path, band_mapping, g_point)
    for m, src in ((t, src_t), (j, src_j)):
        src.heating_rate = src.heating_rate * 0.5
        m.subtract(src)
        m.mask_rayleigh_up(20000.0)
    _assert_same_lbl(t, j)


@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_calc_ckd_fluxes(kind):
    rng = np.random.default_rng(7)
    ncol, nlay, ng = 4, 9, 6
    od = rng.gamma(0.5, 0.3, (ncol, nlay, ng))
    pair = []
    for cls in (JLblFluxes, LblFluxes):
        m = cls()
        m.is_sw = kind == "sw"
        m.pressure_hl = np.zeros((ncol, nlay + 1))
        r = np.random.default_rng(8)
        if m.is_sw:
            m.tsi, m.mu0 = 1361.0, r.uniform(0.1, 1.0, ncol)
            m.solar_irradiance = r.uniform(10.0, 200.0, ng)
            m.effective_spectral_albedo = r.uniform(0.0, 0.3, 3)
            m.iband_per_g = np.array([0, 0, 1, 1, 2, 2])
        else:
            m.planck_hl = np.abs(r.normal(5, 1, (ncol, nlay + 1, ng)))
            m.surf_planck = np.abs(r.normal(8, 1, (ncol, ng)))
            m.surf_emissivity = r.uniform(0.9, 1.0, (ncol, ng))
            m.spectral_flux_up = np.zeros((ncol, nlay + 1, ng))
        pair.append(m)
    want = pair[0].calc_ckd_fluxes(od)
    got = pair[1].calc_ckd_fluxes(od, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (ncol, nlay + 1, ng)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-13, atol=1e-300)


@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_chip_smoke_training_fluxes(tmp_path, kind):
    """chip_smoke.py's training fluxes, which it computes on the card from
    a main path's profiles, are the fluxes tests/synth.py writes for the
    same spectrum, as the JAX package's LblFluxes reads them (1e-12 of
    each field's largest value: heating rates are differences of fluxes)."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from ecckd_tpu_torch.io import read_spectrum
    sw = kind == "sw"
    h2o = synth_spectrum_file(str(tmp_path / "h2o.h5"), nwav=512, ncol=3,
                              nlay=8, seed=5, is_sw=sw)
    gp = str(tmp_path / "gp.h5")
    g_point = _write_gpoint_map(gp, 512, 6)
    ssi = np.linspace(1.0, 9.0, 512) if sw else None
    path = str(tmp_path / f"{kind}.nc")
    if sw:
        synth_sw_lbl_flux_file(path, [h2o], gp, ["h2o"], ssi, (0, 1, 2))
    else:
        synth_lbl_flux_file(path, [h2o], gp, ["h2o"], (0, 1, 2))
    want = JLblFluxes.read(path)
    got = chip_smoke.training_fluxes([read_spectrum(h2o, i) for i in range(3)],
                                     g_point, 6, torch.device("cpu"), ssi=ssi)
    assert got.ncol == want.ncol == (9 if sw else 3)
    for name in ("pressure_hl", "temperature_hl", "vmr_fl", "flux_dn",
                 "flux_up", "spectral_flux_dn", "spectral_flux_up",
                 "heating_rate", "spectral_heating_rate", "mu0",
                 "effective_spectral_albedo"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=1e-12,
                                       atol=1e-12 * np.abs(b).max(),
                                       err_msg=name)
    assert got.molecules == want.molecules and got.is_sw == want.is_sw
    assert abs(got.tsi - want.tsi) <= 1e-12 * abs(want.tsi)


# -------------------------------------------------------- cost functions

WEIGHTS = [(0.02, 0.0, 0.5, 0.0), (0.1, 0.05, 0.0, 0.0),
           (0.02, 0.0, 1.0, 0.0), (0.02, 0.01, 0.5, 0.3)]


def _cost_inputs(ncol, sw, seed=0):
    """tests/test_cost_functions.py's LW inputs, per column."""
    rng = np.random.default_rng(seed)
    nlay, ng, nband = 10, 12, 3
    p = np.linspace(100.0, 1e5, nlay + 1)[None, :] * rng.uniform(
        0.95, 1.05, (ncol, 1))
    lw = np.sqrt(np.diff(p, axis=1))
    d = dict(
        pressure_hl=p,
        planck_hl=np.abs(rng.normal(5, 1, (ncol, nlay + 1, ng))),
        od=rng.gamma(0.5, 0.5, (ncol, nlay, ng)),
        emis_g=np.full((ncol, ng), 0.98),
        surf_planck=np.abs(rng.normal(8, 1, (ncol, ng))),
        fd=np.abs(rng.normal(10, 2, (ncol, nlay + 1, nband))),
        fu=np.abs(rng.normal(10, 2, (ncol, nlay + 1, nband))),
        hr=rng.normal(0, 1e-5, (ncol, nlay, nband)),
        layer_weight=lw / lw.sum(1, keepdims=True),
        sdn=np.abs(rng.normal(3, 1, (ncol, ng))),
        sup=np.abs(rng.normal(3, 1, (ncol, ng))),
        rdn=np.abs(rng.normal(1, 0.2, (ncol, nlay + 1, ng))),
        rup=np.abs(rng.normal(1, 0.2, (ncol, nlay + 1, ng))),
        mu0=rng.uniform(0.2, 1.0, ncol),
        ssi_g=np.abs(rng.normal(2, 0.5, ng)),
        albedo_g=np.full(ng, 0.2),
        sbw=rng.uniform(0.0, 0.5, ng))
    band_mapping = np.repeat(np.arange(nband), ng // nband)
    d["onehot"] = (band_mapping[:, None] == np.arange(nband)).astype(float)
    if sw:
        d["od"] = 0.1 * d["od"]
    return d


def _both_costs(kind, d, weights, relative, with_upwelling=True):
    """(JAX value and od-gradient vmapped over columns, the port's)."""
    wj = jcost.CostWeights(*weights)
    wt = tcost.CostWeights(*weights)
    sbw = weights[3] > 0

    def jax_one(od, i):
        a = {k: jnp.asarray(v[i]) if np.ndim(v) and k not in (
            "onehot", "ssi_g", "albedo_g", "sbw") else jnp.asarray(v)
            for k, v in d.items()}
        rel = dict(relative_flux_dn=a["rdn"], relative_flux_up=a["rup"]) \
            if relative else {}
        if kind == "lw":
            return jcost.cost_ckd_lw(
                a["pressure_hl"], a["planck_hl"], a["emis_g"],
                a["surf_planck"], od, a["fd"], a["fu"], a["hr"],
                a["layer_weight"], a["onehot"], wj,
                spectral_flux_dn_surf=a["sdn"] if sbw else None,
                spectral_flux_up_toa=a["sup"] if sbw else None, **rel)
        return jcost.cost_ckd_sw(
            a["mu0"], a["pressure_hl"], a["ssi_g"], a["albedo_g"], od,
            a["fd"], a["fu"], a["hr"], a["layer_weight"], a["onehot"], wj,
            with_upwelling=with_upwelling,
            spectral_boundary_weights=a["sbw"] if sbw else None,
            spectral_flux_dn_surf=a["sdn"] if sbw else None, **rel)

    ncol = d["od"].shape[0]
    want = [jax.value_and_grad(jax_one)(jnp.asarray(d["od"][i]), i)
            for i in range(ncol)]
    want_v = np.array([float(v) for v, _ in want])
    want_g = np.stack([np.asarray(g) for _, g in want])

    t = {k: torch.as_tensor(v) for k, v in d.items()}
    od = t["od"].clone().requires_grad_(True)
    rel = dict(relative_flux_dn=t["rdn"], relative_flux_up=t["rup"]) \
        if relative else {}
    if kind == "lw":
        got = tcost.cost_ckd_lw(
            t["pressure_hl"], t["planck_hl"], t["emis_g"], t["surf_planck"],
            od, t["fd"], t["fu"], t["hr"], t["layer_weight"], t["onehot"],
            wt, spectral_flux_dn_surf=t["sdn"] if sbw else None,
            spectral_flux_up_toa=t["sup"] if sbw else None, **rel)
    else:
        got = tcost.cost_ckd_sw(
            t["mu0"], t["pressure_hl"], t["ssi_g"], t["albedo_g"], od,
            t["fd"], t["fu"], t["hr"], t["layer_weight"], t["onehot"], wt,
            with_upwelling=with_upwelling,
            spectral_boundary_weights=t["sbw"] if sbw else None,
            spectral_flux_dn_surf=t["sdn"] if sbw else None, **rel)
    (grad,) = torch.autograd.grad(got.sum(), od)
    return (want_v, want_g), (got.detach().numpy(), grad.numpy())


@pytest.mark.parametrize("relative", [False, True])
@pytest.mark.parametrize("weights", WEIGHTS)
def test_cost_ckd_lw(weights, relative):
    (wv, wg), (gv, gg) = _both_costs("lw", _cost_inputs(3, False), weights,
                                     relative)
    assert gv.shape == (3,)
    assert _normwise(gv, wv) <= 1e-10 and _normwise(gg, wg) <= 1e-10


@pytest.mark.parametrize("with_upwelling", [True, False])
@pytest.mark.parametrize("weights", WEIGHTS)
def test_cost_ckd_sw(weights, with_upwelling):
    (wv, wg), (gv, gg) = _both_costs("sw", _cost_inputs(3, True), weights,
                                     relative=with_upwelling,
                                     with_upwelling=with_upwelling)
    assert _normwise(gv, wv) <= 1e-10 and _normwise(gg, wg) <= 1e-10


def test_cost_ckd_one_profile():
    """Without a column axis the port's cost is JAX's one-profile cost."""
    d = _cost_inputs(1, False)
    one = {k: (v[0] if k not in ("onehot", "ssi_g", "albedo_g", "sbw")
               else v) for k, v in d.items()}
    w = WEIGHTS[3]
    want = float(jcost.cost_ckd_lw(
        one["pressure_hl"], one["planck_hl"], one["emis_g"],
        one["surf_planck"], one["od"], one["fd"], one["fu"], one["hr"],
        one["layer_weight"], one["onehot"], jcost.CostWeights(*w),
        spectral_flux_dn_surf=one["sdn"], spectral_flux_up_toa=one["sup"]))
    t = {k: torch.as_tensor(v) for k, v in one.items()}
    got = tcost.cost_ckd_lw(
        t["pressure_hl"], t["planck_hl"], t["emis_g"], t["surf_planck"],
        t["od"], t["fd"], t["fu"], t["hr"], t["layer_weight"], t["onehot"],
        tcost.CostWeights(*w), spectral_flux_dn_surf=t["sdn"],
        spectral_flux_up_toa=t["sup"])
    assert got.shape == () and abs(float(got) - want) <= 1e-12 * abs(want)


# ------------------------------------------------------ full training cost

def _scene_arrays(kind, ng, ncol=4, nlay=12, seed=3):
    """Truth fluxes, atmosphere and relative-to fluxes of one scene."""
    rng = np.random.default_rng(seed)
    p = np.tile(np.exp(np.linspace(np.log(120.0), np.log(1.0e5), nlay + 1)),
                (ncol, 1))
    t = (np.linspace(215.0, 288.0, nlay + 1)[None, :]
         + rng.normal(0, 5, (ncol, 1)))
    h2o = 4e-6 + 8e-3 * (p[:, 1:] / 1.0e5) ** 3
    co2 = 4.15e-4 * rng.uniform(1.0, 1.5, (ncol, nlay))
    a = dict(pressure_hl=p, temperature_hl=t,
             vmr_fl=np.stack([h2o, co2], axis=1),
             spectral_flux_dn=np.abs(rng.normal(5.0, 1.0,
                                                (ncol, nlay + 1, ng))),
             spectral_flux_up=np.abs(rng.normal(5.0, 1.0,
                                                (ncol, nlay + 1, ng))),
             spectral_flux_dn_surf=np.abs(rng.normal(3.0, 1.0, (ncol, ng))),
             spectral_flux_up_toa=np.abs(rng.normal(3.0, 1.0, (ncol, ng))),
             rel=(np.abs(rng.normal(0.5, 0.1, (ncol, nlay + 1, ng))),
                  np.abs(rng.normal(0.5, 0.1, (ncol, nlay + 1, ng)))))
    if kind == "sw":
        a.update(mu0=rng.uniform(0.2, 1.0, ncol), tsi=1361.0,
                 effective_spectral_albedo=np.where(
                     np.arange(ng) % 3 == 0, 0.0, 0.2),
                 erythemal_spectrum=rng.uniform(0.0, 1.0, ng))
    return a


def _lbl(cls, a, kind, model):
    m = cls()
    m.is_sw = kind == "sw"
    for k, v in a.items():
        if k != "rel":
            setattr(m, k, v)
    m.molecules = ["h2o", "co2"]
    m.flux_dn = m.spectral_flux_dn.sum(-1)
    m.flux_up = m.spectral_flux_up.sum(-1)
    conv = -(9.80665 / 1004.0) / np.diff(m.pressure_hl, axis=1)
    hr_up = 0.0 if m.is_sw else np.diff(m.spectral_flux_up, axis=1)
    m.spectral_heating_rate = conv[:, :, None] * (
        np.diff(m.spectral_flux_dn, axis=1) - hr_up)
    m.heating_rate = m.spectral_heating_rate.sum(-1)
    m.surf_emissivity = np.ones((m.ncol, model.ng))
    m.have_spectral_fluxes = True
    return m


@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_training_cost(tmp_path, kind):
    """make_cost_fn + make_prior_fn, value and gradient of the flat state,
    against jax.value_and_grad: relative-to fluxes, boundary (LW) or
    erythemal (SW) terms, exact zeros in the LUT (MIN_X sentinels), and in
    SW Rayleigh active with its prior."""
    jm = synth_lw_ckd_model() if kind == "lw" else synth_sw_ckd_model()
    jm.gas("h2o").molar_abs[0, :2, 1] = 0.0
    path = str(tmp_path / "m.nc")
    jm.write(path, argv=["t"], config_str="")
    active = ["h2o", "co2"] + (["rayleigh"] if kind == "sw" else [])
    j = JCkdModel.read(path, active_gas_list=active)
    t = CkdModel.read(path, active_gas_list=active)
    for m in (j, t):
        m.create_error_covariances(prior_error=2.0,
                                   rayleigh_prior_error=0.5)
    a = _scene_arrays(kind, jm.ng)
    jl, tl = _lbl(JLblFluxes, a, kind, j), _lbl(LblFluxes, a, kind, t)
    joptimize._prepare_lbl(jl, j, 1e4)
    toptimize.prepare_lbl(tl, t, 1e4)
    opts = dict(erythemal_weight=0.7 if kind == "sw" else 0.0)
    weights = (0.02, 0.01, 0.5, 0.3 if kind == "lw" else 0.0)

    scene, meta = jcost_fn.build_scene(j, jl, relative_fluxes=a["rel"],
                                       **opts)
    cost = jcost_fn.make_cost_fn(j, [(scene, meta)],
                                 jcost.CostWeights(*weights))
    prior = jcost_fn.make_prior_fn(j)
    x0 = jsolver.log_state_tree(j)
    rng = np.random.default_rng(9)
    x = {k: np.where(v > jcost_fn.MIN_X,
                     v + rng.normal(0.0, 0.3, v.shape), v)
         for k, v in x0.items()}
    val, grad = jax.value_and_grad(lambda s: cost(s) + prior(s, x0))(
        {k: jnp.asarray(v) for k, v in x.items()})

    tc = TrainingCost(t, [tl], tcost.CostWeights(*weights),
                      relative_fluxes=[a["rel"]], device="cpu", **opts)
    got_v, got_g = tc(ravel_tree(x))
    want_g = ravel_tree({k: np.asarray(v) for k, v in grad.items()})
    assert set(tc.state.keys) == set(x) and len(got_g) == len(want_g)
    assert abs(got_v - float(val)) <= 1e-10 * abs(float(val))
    assert np.all(np.isfinite(got_g))
    assert _normwise(got_g, want_g) <= 1e-10
    # repeat: bit-identical
    again_v, again_g = tc(ravel_tree(x))
    assert again_v == got_v and np.array_equal(again_g, got_g)


def _to_jax(tm, tl):
    """The JAX package's CkdModel and LblFluxes holding the port's
    arrays."""
    import dataclasses
    from ecckd_tpu.models import GasData as JGasData
    gases = [JGasData(**{f.name: getattr(g, f.name)
                         for f in dataclasses.fields(JGasData)})
             for g in tm.single_gas_data]
    jm = JCkdModel(gases, np.exp(tm.log_pressure), tm.temperature,
                   tm.wavenumber1, tm.wavenumber2, tm.gpoint_fraction,
                   tm.wavenumber1_band, tm.wavenumber2_band, tm.band_number,
                   temperature_planck=tm.temperature_planck,
                   planck_function=tm.planck_function)
    jl = JLblFluxes(**{f.name: getattr(tl, f.name)
                       for f in dataclasses.fields(JLblFluxes)})
    return jm, jl


@pytest.mark.parametrize("lut_gas", [False, True])
def test_train_step_against_jax(lut_gas):
    """scripts/train_step.py's production step at a small size against the
    JAX package, value and gradient (1e-10): without the LUT gas it is
    bench.build_train_step itself; with it, the same model and fluxes go
    through JAX's build_scene and make_cost_fn."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    from ecckd_tpu_torch.scripts import train_step
    size = dict(ng=8, nt=4, npress=10, ncol=4, nlay=12)
    if lut_gas:
        tm = train_step.synthetic_model(8, 4, 10, lut_gas=True)
        tl = train_step.training_fluxes(tm, ncol=4, nlay=12)
        jm, jl = _to_jax(tm, tl)
        scene = jcost_fn.build_scene(jm, jl)
        cost = jcost_fn.make_cost_fn(jm, [scene], jcost.CostWeights())
        x0 = jsolver.log_state_tree(jm)
        val, grad = jax.value_and_grad(cost)(
            {k: jnp.asarray(v) for k, v in x0.items()})
    else:
        step, x0 = bench.build_train_step(dtype=np.float64, **size)
        val, grad = step(x0)
    tc, x = train_step.training_cost(lut_gas=lut_gas, device="cpu", **size)
    assert tc.state.keys == sorted(x0)
    assert tc.state.keys == (["h2o", "o3"] if lut_gas else ["h2o"])
    got_v, got_g = tc(x.numpy())
    want_g = ravel_tree({k: np.asarray(v) for k, v in grad.items()})
    assert abs(got_v - float(val)) <= 1e-10 * abs(float(val))
    assert _normwise(got_g, want_g) <= 1e-10


# ----------------------------------------------------------- optimize_lut

def _opt_cfg(rig, out, **extra):
    cfg = {"input": rig["lut"], "output": out, "gases": "h2o",
           "training_input": rig["training"], "prior_error": "4.0",
           "flux_weight": "0.02", "broadband_weight": "0.5"}
    cfg.update({k: str(v) for k, v in extra.items()})
    return cfg


def _recorded(monkeypatch, module):
    """Record the SolveResult of each ``solve`` the tool module calls."""
    results = []
    real = module.solve

    def solve(*args, **kwargs):
        results.append(real(*args, **kwargs))
        return results[-1]
    monkeypatch.setattr(module, "solve", solve)
    return results


def test_optimize_lut_matches_jax(rig, tmp_path, monkeypatch):
    """20 scipy iterations from the same raw LUT in both packages: the
    same iteration and evaluation counts, the final cost within 1e-8 and
    the optimised LUT (written in float32) within 1e-6."""
    jres = _recorded(monkeypatch, joptimize)
    tres = _recorded(monkeypatch, toptimize)
    outs = {}
    for tag, tool, cfg_cls, extra in (
            ("jax", joptimize.optimize_lut, JConfig, {}),
            ("torch", toptimize.optimize_lut, Config, CPU)):
        outs[tag] = str(tmp_path / f"opt_{tag}.nc")
        rc = tool(cfg_cls(_opt_cfg(rig, outs[tag], max_iterations=20,
                                   convergence_criterion="1e-12", **extra)),
                  argv=["optimize_lut"])
        assert rc == 0
    (j,), (t,) = jres, tres
    assert t.n_iterations == j.n_iterations == 20
    assert t.n_evaluations == j.n_evaluations
    assert t.status.name == j.status.name == "MAX_ITERATIONS_REACHED"
    assert abs(t.cost - j.cost) <= 1e-8 * abs(j.cost)
    with NcFile(outs["jax"]) as a, NcFile(outs["torch"]) as b:
        ka = a.read("h2o_molar_absorption_coeff")
        kb = b.read("h2o_molar_absorption_coeff")
        np.testing.assert_allclose(kb, ka, rtol=1e-6)
        assert sorted(a.names()) == sorted(b.names())
        assert "optimize_lut" in b.attribute("history")
        assert "create_lut" in b.attribute("history")


def _flux_errors(model_path, training):
    """tests/test_optimize.py's ckd_flux_errors on the port: RMS errors of
    the broadband downwelling and upwelling fluxes over all half levels and
    of the heating rate (K/day) of a CKD model against the LBL truth."""
    from ecckd_tpu_torch import constants as c
    model = CkdModel.read(model_path, active_gas_list=["h2o"])
    lbl = LblFluxes.read(training)
    toptimize.prepare_lbl(lbl, model, 1e4)
    od = toptimize.reference_od(model, lbl, device="cpu")
    fd, fu = lbl.calc_ckd_fluxes(od, device="cpu")
    err_dn = np.sqrt(np.mean((fd.sum(-1) - lbl.flux_dn) ** 2))
    err_up = np.sqrt(np.mean((fu.sum(-1) - lbl.flux_up) ** 2))
    conv = (-(c.ACCEL_GRAVITY / c.SPECIFIC_HEAT_AIR)
            / np.diff(lbl.pressure_hl, axis=1)) * c.HR_WEIGHT
    hr_ckd = conv * (np.diff(fd.sum(-1), axis=1)
                     - np.diff(fu.sum(-1), axis=1))
    err_hr = np.sqrt(np.mean((hr_ckd - lbl.heating_rate * c.HR_WEIGHT) ** 2))
    return err_dn, err_up, err_hr


def test_optimization_improves_fluxes(rig, tmp_path):
    """tests/test_optimize.py's improvement check, on the port."""
    out = str(tmp_path / "lut_opt.nc")
    rc = toptimize.optimize_lut(Config(_opt_cfg(
        rig, out, max_iterations=60, convergence_criterion="0.002", **CPU)),
        argv=["optimize_lut"])
    assert rc == 0
    before = _flux_errors(rig["lut"], rig["training"])
    after = _flux_errors(out, rig["training"])
    assert after[0] < 0.7 * before[0]
    assert after[2] < 0.7 * before[2]
    assert after[1] < before[1] * 1.25 + 0.05


@pytest.mark.parametrize("remove_min_max", [False, True])
def test_bounds_respected(rig, tmp_path, remove_min_max):
    """tests/test_optimize.py's bounds and remove_min_max checks, on the
    port."""
    out = str(tmp_path / "lut_opt_b.nc")
    toptimize.optimize_lut(Config(_opt_cfg(
        rig, out, max_iterations=20, bounded_minimization=1,
        remove_min_max=int(remove_min_max), **CPU)), argv=["optimize_lut"])
    before, after = CkdModel.read(rig["lut"]), CkdModel.read(out)
    g0, g1 = before.gas("h2o"), after.gas("h2o")
    pos = g0.molar_abs > 0
    assert np.all(g1.molar_abs[pos] <= g0.max_molar_abs[pos] * (1 + 1e-9))
    assert np.all(g1.molar_abs[pos] >= g0.min_molar_abs[pos]
                  * np.where(g0.min_molar_abs[pos] > 0, 1 - 1e-9, 0.0))
    assert np.all(g1.molar_abs[~pos] == 0.0)
    with NcFile(out) as f:
        assert f.exist("h2o_molar_absorption_coeff_min") != remove_min_max


def test_unported_options_raise(rig, tmp_path, monkeypatch):
    """Every solver option of the JAX tool is ported: solver=device runs
    (tests/test_torch_device_solver.py holds it to JAX's), data_parallel
    (the tool's default) changes nothing on the CPU, and only a solver
    that neither package has raises."""
    with pytest.raises(ValueError, match="not understood"):
        toptimize.optimize_lut(Config(_opt_cfg(
            rig, str(tmp_path / "o.nc"), max_iterations=2, solver="newton",
            **CPU)), argv=["optimize_lut"])
    res = _recorded(monkeypatch, toptimize)
    for tag, extra in (("dev", {"solver": "device"}),
                       ("dp0", {"data_parallel": 0}), ("dp1", {})):
        rc = toptimize.optimize_lut(Config(_opt_cfg(
            rig, str(tmp_path / f"{tag}.nc"), max_iterations=3,
            convergence_criterion="1e-12", **extra, **CPU)),
            argv=["optimize_lut"])
        assert rc == 0
    assert res[0].n_iterations == 3 and res[0].host_reads > 0
    assert res[1].cost == res[2].cost
    assert res[1].n_evaluations == res[2].n_evaluations


def test_checkpoint_resume(rig, tmp_path, monkeypatch):
    """The port resumes from a checkpoint it wrote (total-iteration
    budget, as tests/test_checkpoint.py holds JAX's), and from one JAX
    wrote, where it continues as JAX does from the same file."""
    res = _recorded(monkeypatch, toptimize)
    ck = str(tmp_path / "opt.ckpt")
    run = lambda tool, cfg_cls, out, ck, n, **kw: tool(cfg_cls(_opt_cfg(
        rig, str(tmp_path / out), max_iterations=n, checkpoint_file=ck,
        checkpoint_every=4, convergence_criterion="1e-12", **kw)),
        argv=["optimize_lut"])
    run(toptimize.optimize_lut, Config, "o1.nc", ck, 9, **CPU)
    with np.load(ck) as f:
        assert int(f["_n_iter"]) == 8
        assert set(f.files) == {"_n_iter", "_cost", "state_h2o"}
    run(toptimize.optimize_lut, Config, "o2.nc", ck, 12, **CPU)
    assert res[-1].n_iterations == 12
    with np.load(ck) as f:
        assert int(f["_n_iter"]) == 12

    jck = str(tmp_path / "jax.ckpt")
    run(joptimize.optimize_lut, JConfig, "j1.nc", jck, 8)
    with np.load(jck) as f:
        assert int(f["_n_iter"]) == 8
    tck = str(tmp_path / "copy.ckpt")
    with open(jck, "rb") as src, open(tck, "wb") as dst:
        dst.write(src.read())
    run(joptimize.optimize_lut, JConfig, "j2.nc", jck, 12)
    run(toptimize.optimize_lut, Config, "t2.nc", tck, 12, **CPU)
    assert res[-1].n_iterations == 12
    with NcFile(str(tmp_path / "j2.nc")) as a, \
            NcFile(str(tmp_path / "t2.nc")) as b:
        np.testing.assert_allclose(b.read("h2o_molar_absorption_coeff"),
                                   a.read("h2o_molar_absorption_coeff"),
                                   rtol=1e-6)


def test_float32_against_float64(rig):
    """The port's float32 training cost against its float64 on the rig, by
    PARITY.md's optimize rows (scripts/tpu_parity.py): the value, the
    gradient norm and the cost after 20 fixed-rate gradient-descent steps,
    each within 1e-3."""
    costs = {}
    for dtype in (torch.float64, torch.float32):
        model = CkdModel.read(rig["lut"], active_gas_list=["h2o"])
        lbl = LblFluxes.read(rig["training"])
        model.create_error_covariances(4.0)
        toptimize.prepare_lbl(lbl, model, 1e4)
        tc = TrainingCost(model, [lbl], tcost.CostWeights(), device="cpu",
                          dtype=dtype)
        costs[dtype] = (tc, tc.tensor(ravel_tree(
            tsolver.log_state_tree(model))))
    lev = precision_levels(*costs[torch.float64], *costs[torch.float32])
    assert lev["cost_20"] < lev["value"]
    for key in ("value_rel", "gradient_norm_rel", "cost_20_rel"):
        assert lev[key] <= 1e-3, (key, lev)


# ----------------------------------------------------------------- run_ckd

@pytest.fixture(scope="module")
def models(rig, tmp_path_factory):
    d = tmp_path_factory.mktemp("run_ckd")
    paths = {"rig": rig["lut"]}
    for name, make in (("lw", synth_lw_ckd_model), ("sw", synth_sw_ckd_model)):
        paths[name] = str(d / f"{name}.nc")
        make().write(paths[name], argv=["t"], config_str="")
    paths["scenario"] = synth_scenario_file(
        str(d / "scen.nc"), gases=("h2o", "co2", "ch4"))
    return paths


@pytest.mark.parametrize("model,extra", [
    ("rig", {}),
    ("lw", {"co2_scaling": "2.0"}),
    ("lw", {"gases": "h2o co2", "write_od_only": "1"}),
    ("sw", {"tsi": "1300.0", "co2_scaling": "0.5"}),
    ("sw", {"write_od_only": "1"}),
])
def test_run_ckd(models, tmp_path, model, extra):
    """Every output variable of both tools, and their names and shapes."""
    outs = []
    for tag, tool, cfg_cls, dev in (("jax", jrun_ckd, JConfig, {}),
                                    ("torch", run_ckd, Config, CPU)):
        out = str(tmp_path / f"{tag}.nc")
        tool(cfg_cls({"ckd_model": models[model],
                      "input": models["scenario"], "output": out,
                      **extra, **dev}), argv=["run_ckd"])
        outs.append(out)
    with NcFile(outs[0]) as a, NcFile(outs[1]) as b:
        assert sorted(a.names()) == sorted(b.names())
        for name in a.names():
            va, vb = np.asarray(a.read(name)), np.asarray(b.read(name))
            assert va.shape == vb.shape and va.dtype == vb.dtype, name
            np.testing.assert_allclose(vb, va, rtol=1e-12, atol=0,
                                       err_msg=name)
        for attr in ("experiment", "experiment_id", "title"):
            assert b.attribute(attr) == a.attribute(attr)
        assert "run_ckd" in b.attribute("history")
    if "write_od_only" in extra:
        with NcFile(outs[1]) as b:
            assert not any(n.startswith(("flux", "spectral_flux"))
                           for n in b.names())


def test_run_ckd_cli(models, tmp_path):
    from ecckd_tpu_torch.tools.run_ckd import main
    out = str(tmp_path / "cli.nc")
    assert main([f"ckd_model={models['lw']}", f"input={models['scenario']}",
                 f"output={out}", "device=cpu"]) == 0
    assert os.path.exists(out)
