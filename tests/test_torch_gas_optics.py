"""The port's gas optics and CkdModel against the JAX package, on the CPU
in float64.

The same models (``tests/synth.py``'s LW and SW models, carried across as
their numpy arrays) and atmospheres, made from a seed, go through both
packages.  Held: ``calc_optical_depth`` in every concentration dependence
with and without logarithmic interpolation, ``planck_from_lut`` (also
below the table start) and ``rayleigh_optical_depth`` to 1e-12 relative;
the table gradient against ``jax.grad`` to 1e-10 normwise, and finite
where the table holds exact zeros; ``CkdModel.read`` of files either
package wrote gives identical arrays, flags and prior machinery.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecckd_tpu.models import CkdModel as JCkdModel
from ecckd_tpu.models import gas_optics as jgo
from ecckd_tpu_torch.models import CkdModel, ConcDependence, GasData
from ecckd_tpu_torch.models import gas_optics as tgo
from synth import synth_lw_ckd_model, synth_sw_ckd_model

CPU = torch.device("cpu")


def to_port_model(jm):
    """The port's CkdModel holding a JAX CkdModel's arrays."""
    gases = [GasData(**{f.name: getattr(g, f.name)
                        for f in dataclasses.fields(GasData)})
             for g in jm.single_gas_data]
    kw = dict(temperature_planck=jm.temperature_planck,
              planck_function=jm.planck_function,
              solar_irradiance=jm.solar_irradiance, ssi=jm.ssi,
              rayleigh_molar_scat=jm.rayleigh_molar_scat,
              reference_total_solar_irradiance=(
                  jm.reference_total_solar_irradiance),
              model_id=jm.model_id)
    m = CkdModel(gases, np.exp(jm.log_pressure), jm.temperature,
                 jm.wavenumber1, jm.wavenumber2, jm.gpoint_fraction,
                 jm.wavenumber1_band, jm.wavenumber2_band, jm.band_number,
                 **kw)
    m.logarithmic_interpolation = jm.logarithmic_interpolation
    m.rayleigh_is_active = jm.rayleigh_is_active
    return m


def _lut_model(seed=4):
    """synth's LW model with an o3 LUT gas of three concentrations."""
    jm = synth_lw_ckd_model(seed=seed)
    rng = np.random.default_rng(seed)
    h2o = jm.gas("h2o")
    k = np.stack([h2o.molar_abs * s for s in (0.7, 1.0, 1.6)])
    k *= rng.uniform(0.8, 1.2, k.shape)
    o3 = type(h2o)("o3", jgo.ConcDependence.LUT, molar_abs=k,
                   vmr=np.array([1e-7, 1e-6, 1e-5]))
    o3.min_molar_abs, o3.max_molar_abs = 0.5 * k, 2.0 * k
    jm.single_gas_data.append(o3)
    return jm


def _atmosphere(ncol=3, nlay=14, seed=0):
    """Columns spanning the LUT's grid and a little beyond (clipped)."""
    rng = np.random.default_rng(seed)
    p = np.exp(np.linspace(np.log(60.0), np.log(1.1e5), nlay + 1))
    p = p[None, :] * rng.uniform(0.9, 1.1, (ncol, 1))
    t_hl = (np.linspace(180.0, 310.0, nlay + 1)[None, :]
            + rng.normal(0.0, 8.0, (ncol, nlay + 1)))
    t_fl = np.asarray(jgo.temperature_fl_from_hl(p, t_hl))
    vmr = 10.0 ** rng.uniform(-7.5, -2.0, (ncol, nlay))
    return p, t_hl, t_fl, vmr


def _max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.maximum(np.abs(want), 1e-300)
    return float(np.max(np.abs(got - want) / scale))


GASES = [("composite", ConcDependence.NONE), ("h2o", ConcDependence.LINEAR),
         ("co2", ConcDependence.RELATIVE_LINEAR), ("o3", ConcDependence.LUT)]


@pytest.mark.parametrize("log_interp", [False, True])
@pytest.mark.parametrize("gas,cd", GASES)
def test_calc_optical_depth(gas, cd, log_interp):
    jm = _lut_model()
    g = jm.gas(gas)
    assert int(g.conc_dependence) == int(cd)
    p, _, t_fl, vmr = _atmosphere()
    if cd == ConcDependence.RELATIVE_LINEAR:
        vmr = g.reference_vmr + vmr
    vmr_arg = None if cd == ConcDependence.NONE else vmr
    args = (g.molar_abs, p, t_fl, jm.log_pressure, jm.temperature)
    kw = dict(vmr_fl=vmr_arg, lut_vmr=g.vmr, reference_vmr=g.reference_vmr,
              logarithmic_interpolation=log_interp)
    want = np.asarray(jgo.calc_optical_depth(g.conc_dependence, *args, **kw))
    got = tgo.calc_optical_depth(cd, *args, **kw)
    assert got.dtype == torch.float64 and got.device == CPU
    assert got.shape == want.shape == (3, 14, jm.ng)
    assert _max_rel(got, want) <= 1e-12


@pytest.mark.parametrize("log_interp", [False, True])
@pytest.mark.parametrize("gas,cd", GASES)
def test_table_gradient(gas, cd, log_interp):
    """d(sum of od * weights)/d(table) against jax.grad: the transpose of
    the interpolation replaces the gather's scatter-add."""
    jm = _lut_model()
    g = jm.gas(gas)
    p, _, t_fl, vmr = _atmosphere(seed=1)
    if cd == ConcDependence.RELATIVE_LINEAR:
        vmr = g.reference_vmr + vmr
    vmr_arg = None if cd == ConcDependence.NONE else vmr
    w = np.random.default_rng(2).normal(size=(3, 14, jm.ng))
    geo = (p, t_fl, jm.log_pressure, jm.temperature)
    kw = dict(vmr_fl=vmr_arg, lut_vmr=g.vmr, reference_vmr=g.reference_vmr,
              logarithmic_interpolation=log_interp)
    want = np.asarray(jax.grad(lambda tab: jnp.sum(jnp.asarray(w) * (
        jgo.calc_optical_depth(g.conc_dependence, tab, *geo, **kw))))(
        jnp.asarray(g.molar_abs)))
    table = torch.tensor(g.molar_abs, requires_grad=True)
    torch.sum(torch.as_tensor(w) * tgo.calc_optical_depth(
        cd, table, *geo, **kw)).backward()
    got = table.grad.numpy()
    assert np.linalg.norm(got - want) <= 1e-10 * np.linalg.norm(want)


def test_gradient_finite_with_zero_coefficients():
    """Exact zeros in the table (the MIN_X sentinels of the optimiser's
    state) give a finite gradient with linear interpolation, as in JAX."""
    jm = synth_lw_ckd_model()
    g = jm.gas("h2o")
    k = g.molar_abs.copy()
    k[:, :3, 0] = 0.0
    k[1, :, 2] = 0.0
    p, _, t_fl, vmr = _atmosphere()
    geo = (p, t_fl, jm.log_pressure, jm.temperature)
    table = torch.tensor(k, requires_grad=True)
    tgo.calc_optical_depth(ConcDependence.LINEAR, table, *geo,
                           vmr_fl=vmr).sum().backward()
    want = np.asarray(jax.grad(lambda tab: jnp.sum(jgo.calc_optical_depth(
        jgo.ConcDependence.LINEAR, tab, *geo, vmr_fl=vmr)))(jnp.asarray(k)))
    assert np.all(np.isfinite(table.grad.numpy()))
    np.testing.assert_allclose(table.grad.numpy(), want, rtol=1e-12,
                               atol=1e-300)


def test_interpolation_matrix_is_the_gather():
    """The dense interpolation matrix times the flat table equals the
    gathered interpolation, for a LUT gas (tri-linear)."""
    jm = _lut_model()
    g = jm.gas("o3")
    p, _, t_fl, vmr = _atmosphere()
    interp = tgo.lut_interpolation(ConcDependence.LUT, p, t_fl,
                                   jm.log_pressure, jm.temperature,
                                   vmr_fl=vmr, lut_vmr=g.vmr)
    table = torch.as_tensor(g.molar_abs)
    m = interp.matrix(torch.float64)
    assert m.shape == (3 * 14, table[..., 0].numel())
    assert torch.all((m != 0).sum(1) <= 8)
    np.testing.assert_allclose(m.sum(1).numpy(), 1.0, rtol=1e-14)
    got = (m @ table.reshape(-1, jm.ng)).reshape(3, 14, jm.ng)
    np.testing.assert_allclose(got.numpy(), interp._combine(table).numpy(),
                               rtol=1e-13)


def test_planck_from_lut():
    jm = synth_lw_ckd_model()
    _, t_hl, _, _ = _atmosphere()
    temps = np.concatenate([t_hl, [[100.0, 119.9, 120.0, 349.0, 400.0]
                                   + [250.0] * 10]], axis=0)
    want = np.asarray(jgo.planck_from_lut(temps, jm.temperature_planck,
                                          jm.planck_function))
    got = tgo.planck_from_lut(temps, jm.temperature_planck,
                              jm.planck_function)
    assert got.shape == want.shape == temps.shape + (jm.ng,)
    assert _max_rel(got, want) <= 1e-12
    # below the table start: linear to zero
    np.testing.assert_allclose(
        got[-1, 0].numpy(),
        100.0 / jm.temperature_planck[0] * jm.planck_function[0], rtol=1e-14)


def test_rayleigh_and_temperature_fl():
    jm = synth_sw_ckd_model()
    p, t_hl, _, _ = _atmosphere()
    want = np.asarray(jgo.rayleigh_optical_depth(p, jm.rayleigh_molar_scat))
    got = tgo.rayleigh_optical_depth(p, jm.rayleigh_molar_scat)
    assert _max_rel(got, want) <= 1e-12
    np.testing.assert_array_equal(
        tgo.temperature_fl_from_hl(p, t_hl),
        np.asarray(jgo.temperature_fl_from_hl(p, t_hl)))


@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_model_wrappers(kind):
    """CkdModel.calc_optical_depth / calc_planck_function /
    calc_rayleigh_optical_depth / iband_per_g against JAX's."""
    jm = synth_lw_ckd_model() if kind == "lw" else synth_sw_ckd_model()
    tm = to_port_model(jm)
    p, t_hl, t_fl, vmr = _atmosphere()
    for igas, name in enumerate(jm.molecules):
        v = None if name == "composite" else vmr + 4e-4
        want = np.asarray(jm.calc_optical_depth(igas, p, t_fl, v))
        assert _max_rel(tm.calc_optical_depth(name, p, t_fl, v), want) \
            <= 1e-12
    if kind == "lw":
        assert _max_rel(tm.calc_planck_function(t_hl),
                        jm.calc_planck_function(t_hl)) <= 1e-12
    else:
        assert _max_rel(tm.calc_rayleigh_optical_depth(p),
                        jm.calc_rayleigh_optical_depth(p)) <= 1e-12
    # synth's fractions sum to 5 per g-point: both refuse them
    fraction = jm.gpoint_fraction / 5.0
    for m in (jm, tm):
        with pytest.raises(ValueError, match="G-points do not lie"):
            m.iband_per_g(jm.wavenumber1_band, jm.wavenumber2_band)
        m.gpoint_fraction = fraction
    mid = 0.5 * (jm.wavenumber1_band[0] + jm.wavenumber2_band[0])
    bands = ([jm.wavenumber1_band[0], mid], [mid, jm.wavenumber2_band[0]])
    iband = tm.iband_per_g(*bands)
    np.testing.assert_array_equal(iband, jm.iband_per_g(*bands))
    assert set(iband) == {0, 1}


def _assert_same_models(a, b):
    """Identical arrays, flags and attributes of two CkdModels (either
    package)."""
    for name in ("log_pressure", "temperature", "wavenumber1", "wavenumber2",
                 "gpoint_fraction", "wavenumber1_band", "wavenumber2_band",
                 "band_number", "temperature_planck", "planck_function",
                 "solar_irradiance", "ssi", "rayleigh_molar_scat",
                 "wavenumber_hr", "g_point"):
        va, vb = getattr(a, name), getattr(b, name)
        assert (va is None) == (vb is None), name
        if va is not None:
            np.testing.assert_array_equal(va, vb, name)
            assert np.asarray(va).dtype == np.asarray(vb).dtype, name
    assert a.molecules == b.molecules
    for attr in ("history", "config", "summary", "model_id",
                 "reference_total_solar_irradiance", "rayleigh_is_active",
                 "logarithmic_interpolation"):
        assert getattr(a, attr) == getattr(b, attr), attr
    for ga, gb in zip(a.single_gas_data, b.single_gas_data):
        assert int(ga.conc_dependence) == int(gb.conc_dependence)
        assert ga.is_active == gb.is_active
        assert ga.reference_vmr == gb.reference_vmr
        assert ga.composite_molecules == gb.composite_molecules
        for name in ("molar_abs", "min_molar_abs", "max_molar_abs", "vmr",
                     "composite_vmr"):
            va, vb = getattr(ga, name), getattr(gb, name)
            assert (va is None) == (vb is None), name
            if va is not None:
                np.testing.assert_array_equal(va, vb, name)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", ["lw", "sw", "lut"])
@pytest.mark.parametrize("active", [None, [], ["h2o", "rayleigh"]])
def test_read(tmp_path, writer, kind, active):
    """A file written by either package reads back identically in both,
    with the same active gases."""
    jm = {"lw": synth_lw_ckd_model, "sw": synth_sw_ckd_model,
          "lut": _lut_model}[kind]()
    if kind == "lw":
        jm.wavenumber_hr = np.linspace(0.0, 2000.0, 80)
        jm.g_point = np.arange(80, dtype=np.int32) % jm.ng
    path = str(tmp_path / f"{kind}.nc")
    (jm if writer == "jax" else to_port_model(jm)).write(
        path, argv=["write"], config_str="a b")
    j = JCkdModel.read(path, active_gas_list=active)
    t = CkdModel.read(path, active_gas_list=active)
    _assert_same_models(j, t)
    if active:
        assert t.gas("h2o").is_active and not t.gas("co2").is_active
        assert t.rayleigh_is_active == (kind == "sw")
    assert set(t.active_lut_pytree()) == set(j.active_lut_pytree())


@pytest.mark.parametrize("prior_error", [1.0, -1.0])
def test_prior_machinery(tmp_path, prior_error):
    """create_error_covariances (Markov shape and estimated errors) and
    calc_background_cost_function as tests/test_ckd_model.py holds JAX's,
    compared with JAX's, on a LUT gas too."""
    path = str(tmp_path / "m.nc")
    _lut_model().write(path, argv=["t"], config_str="")
    j = JCkdModel.read(path, active_gas_list=["h2o", "o3"])
    t = CkdModel.read(path, active_gas_list=["h2o", "o3"])
    for m in (j, t):
        m.create_error_covariances(prior_error=prior_error,
                                   min_prior_error=0.3, max_prior_error=3.0,
                                   pressure_corr=0.5, temperature_corr=0.4,
                                   conc_corr=0.6)
    for gj, gt in zip(j.single_gas_data, t.single_gas_data):
        for name in ("inv_background_shape", "background_error"):
            va, vb = getattr(gj, name), getattr(gt, name)
            assert (va is None) == (vb is None)
            if va is not None:
                np.testing.assert_array_equal(va, vb)
    nx = t.nt * t.np_
    assert t.gas("h2o").inv_background_shape.shape == (nx, nx)
    assert t.gas("o3").inv_background_shape.shape == (3 * nx, 3 * nx)
    rng = np.random.default_rng(5)
    delta = {mol: rng.normal(0.0, 0.1, np.shape(k))
             for mol, k in t.active_lut_pytree().items()}
    cj, gj = j.calc_background_cost_function(delta)
    ct, gt = t.calc_background_cost_function(delta)
    assert abs(float(ct) - float(cj)) <= 1e-12 * abs(float(cj))
    for mol in delta:
        np.testing.assert_allclose(gt[mol].numpy(), np.asarray(gj[mol]),
                                   rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(
        float(ct), 0.5 * sum(float(np.sum(delta[m] * gt[m].numpy()))
                             for m in delta), rtol=1e-9)


def test_cap_relative_linear(tmp_path):
    jm = synth_lw_ckd_model()
    jm.gas("co2").molar_abs[0, 0, :] = 1.0      # above the cap
    path = str(tmp_path / "m.nc")
    jm.write(path, argv=["t"], config_str="")
    models = [cls.read(path, active_gas_list=["co2"])
              for cls in (JCkdModel, CkdModel)]
    for m in models:
        m.cap_relative_linear_coeffts(0.8)
    np.testing.assert_array_equal(models[1].gas("co2").molar_abs,
                                  models[0].gas("co2").molar_abs)
    assert np.any(models[1].gas("co2").molar_abs
                  < jm.gas("co2").molar_abs.astype(np.float32))
