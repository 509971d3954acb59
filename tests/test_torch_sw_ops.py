"""The port's shortwave ops against the JAX package, on the CPU in float64.

Inputs are made with numpy from a seed and handed to both packages.  The
plain version of kernel K2 (``sweep_sw_plain``) is held against the JAX
package's XLA form and its Pallas kernel in interpret mode.  Tolerance:
rtol 1e-12, plus an absolute 1e-12 of the largest magnitude of the
expected array (a flux in an opaque layer is a tiny difference of large
terms); the two packages' exp/log and BLAS/XLA sums differ by a few ulp.
"""

import numpy as np
import pytest
import torch

from ecckd_tpu.ops.average import fit_optical_depth_sw as jfit_sw
from ecckd_tpu.ops.average import (
    fit_optical_depth_sw_total_trans as jfit_tt)
from ecckd_tpu.ops.pallas.sweep_sw import rt_sw_bb_intervals_pallas
from ecckd_tpu.ops.rayleigh import rayleigh_molar_scattering_coeff as jray
from ecckd_tpu.ops.rt_sw import rt_direct_sw as jrt_direct
from ecckd_tpu.ops.rt_sw import rt_norayleigh_sw as jrt_norayleigh
from ecckd_tpu.ops.rt_sw import rt_sw_bb_intervals as jrt_sw_bb_intervals
from ecckd_tpu_torch.ops import (fit_optical_depth_sw,
                                 fit_optical_depth_sw_total_trans,
                                 rayleigh_molar_scattering_coeff,
                                 rt_direct_sw, rt_norayleigh_sw)
from ecckd_tpu_torch.ops.kernels import sweep_sw_plain

RTOL = 1e-12
T = torch.from_numpy


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _spectrum(nlay=15, nwav=1500, seed=0):
    rng = np.random.default_rng(seed)
    ssi = np.abs(rng.normal(1.0, 0.3, nwav))
    col = np.sort(10.0 ** rng.uniform(-3, 1.5, nwav))
    od = col[None, :] * rng.dirichlet(np.ones(nlay), nwav).T
    return ssi, od, rng


def test_rt_direct_and_norayleigh():
    ssi, od, rng = _spectrum(seed=1)
    albedo = rng.uniform(0.0, 0.3, len(ssi))
    _close(rt_direct_sw(0.5, T(ssi), T(od)), jrt_direct(0.5, ssi, od))
    got = rt_norayleigh_sw(0.37, T(ssi), T(od), T(albedo))
    for g, w in zip(got, jrt_norayleigh(0.37, ssi, od, albedo)):
        _close(g, w)


def test_rayleigh_coefficient():
    wav = np.linspace(250.0, 50000.0, 777)
    want = np.asarray(jray(wav))
    _close(rayleigh_molar_scattering_coeff(wav), want)
    _close(rayleigh_molar_scattering_coeff(T(wav)), want)


def _sweep_inputs(nlay, nwav, i1, i2, seed, seg_outside=0):
    rng = np.random.default_rng(seed)
    i1 = np.asarray(i1, np.int32)
    i2 = np.asarray(i2, np.int32)
    ssi = np.abs(rng.normal(1.0, 0.3, nwav))
    bg_od = rng.gamma(0.5, 0.2, (nlay, nwav))
    od_fit = rng.gamma(0.5, 0.2, (nlay, len(i1)))
    seg = np.maximum(0, np.searchsorted(i1, np.arange(nwav), side="right")
                     - 1).astype(np.int32)
    if seg_outside:
        seg[-seg_outside:] = -1
    albedo = rng.uniform(0.05, 0.3, nwav)
    return ssi, bg_od, od_fit, seg, i1, i2, albedo


# Interval layouts of costs(): a plain partition, front-padded [0, 0]
# bucket columns with a shared boundary index, a ragged tile and segments
# outside [0, nseg) (the padded-rank convention of the Pallas kernel)
_SWEEP_CASES = {
    "partition": dict(nlay=12, nwav=2500, i1=[0, 500, 1200, 2000],
                      i2=[499, 1199, 1999, 2499]),
    "bucket_shared": dict(nlay=50, nwav=3000, i1=[0, 0, 0, 700, 1400],
                          i2=[0, 0, 700, 1400, 2999]),
    "seg_outside": dict(nlay=9, nwav=1333, i1=[0, 600], i2=[599, 1332],
                        seg_outside=41),
}


@pytest.mark.parametrize("upwelling", ["vector_albedo", "scalar_albedo",
                                       "none"])
@pytest.mark.parametrize("case", sorted(_SWEEP_CASES))
@pytest.mark.parametrize("jax_path", ["xla", "pallas_interpret"])
def test_sweep_sw_plain(case, upwelling, jax_path):
    c = dict(_SWEEP_CASES[case])
    ssi, bg_od, od_fit, seg, i1, i2, albedo = _sweep_inputs(
        c.pop("nlay"), c.pop("nwav"), c.pop("i1"), c.pop("i2"), seed=5, **c)
    with_up = upwelling != "none"
    if upwelling == "scalar_albedo":
        albedo = 0.15
    if jax_path == "xla":
        grey = np.where(seg >= 0, od_fit[:, np.maximum(seg, 0)], 0.0)
        want = jrt_sw_bb_intervals(0.5, ssi, bg_od, grey, albedo, i1, i2,
                                   with_upwelling=with_up)
    else:
        want = rt_sw_bb_intervals_pallas(ssi, bg_od, od_fit, seg, i1, i2,
                                         cos_sza=0.5, albedo=albedo,
                                         with_upwelling=with_up,
                                         interpret=True, form="scan")
    alb = albedo if np.isscalar(albedo) else T(albedo)
    got = sweep_sw_plain(*map(T, (ssi, bg_od, od_fit, seg, i1, i2)), 0.5,
                         alb, with_up)
    for g, w in zip(got, want):
        _close(g, w)


def _fit_inputs(seed=2, nlay=15, nwav=2048):
    ssi, od, rng = _spectrum(nlay, nwav, seed)
    od[:, :5] = 0.0                       # zero metric for the log fit
    bg = rng.gamma(0.5, 0.01, (nlay, nwav))
    i1 = np.array([0, 3, 700, 1400], np.int32)
    i2 = np.array([2, 700, 1399, 2047], np.int32)
    return ssi, od, bg, i1, i2


@pytest.mark.parametrize("method", ["linear", "transmission",
                                    "transmission-2", "square-root",
                                    "logarithmic"])
def test_fit_optical_depth_sw(method):
    ssi, od, _, i1, i2 = _fit_inputs()
    if method.startswith("transmission"):
        scale = 1.66 * (2.0 if method == "transmission-2" else 1.0)
        metric = -np.expm1(-scale * od)
    elif method == "square-root":
        metric = np.sqrt(od)
    else:
        metric = od
    _close(fit_optical_depth_sw(method, T(ssi), T(metric), T(i1), T(i2)),
           jfit_sw(method, ssi, metric, i1, i2))


@pytest.mark.parametrize("profile", ["fit", "linear_fallback"])
def test_fit_optical_depth_sw_total_trans(profile):
    """A profile whose broadband flux underflows to zero in some layer of
    an interval falls back to the linear fit over the whole profile."""
    ssi, od, bg, i1, i2 = _fit_inputs(seed=3)
    if profile == "linear_fallback":
        od[-1, 1400:] = 500.0             # exp(-1000) underflows to 0
    want = np.asarray(jfit_tt(ssi, bg, od, i1, i2))
    got = fit_optical_depth_sw_total_trans(T(ssi), T(bg), T(od), T(i1),
                                           T(i2))
    _close(got, want)
    linear = np.asarray(jfit_sw("linear", ssi, od, i1, i2))
    fell_back = np.allclose(want[:, -1], linear[:, -1], rtol=RTOL, atol=0.0)
    assert fell_back == (profile == "linear_fallback")
