"""The port's LW candidate cost, interval fits and g-point averaging
against the JAX package, on the CPU in float64.

Both ``CandidateCostLw`` classes are bound to the same numpy arrays, the
port's through ``convert.lw_band_state``.  Tolerances: costs to 1e-11
relative to the largest cost of the batch (the bar PARITY.md sets for a
change of f64 summation order; a near-zero cost of a one-point interval
is a difference of nearly equal fluxes and has no relative accuracy);
fits and averages to 1e-12 relative, with an absolute floor of 1e-12 of the
largest magnitude for entries that are differences of large terms.
"""

import numpy as np
import pytest
import torch

from ecckd_tpu.ops.average import average_od_to_gpoints as javerage
from ecckd_tpu.ops.average import fit_optical_depth_lw as jfit
from ecckd_tpu.ops.planck import planck_function as jplanck
from ecckd_tpu.ops.rt_lw import rt_lw as jrt_lw
from ecckd_tpu.ops.heating_rate import heating_rate as jheating_rate
from ecckd_tpu.partition.cost_kernel import CandidateCostLw as JCost
from ecckd_tpu.partition.cost_kernel import CkdEquipartition as JEq
from ecckd_tpu_torch.convert import lw_band_state
from ecckd_tpu_torch.ops.average import fit_optical_depth_lw
from ecckd_tpu_torch.ops.streaming import average_od_to_gpoints
from ecckd_tpu_torch.partition import CandidateCostLw, CkdEquipartition

T = torch.from_numpy


def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _band(nlay=15, nwav=2048, seed=0, with_bg=True):
    """A rank-ordered LW band: monotone od, truth fluxes from the JAX
    spectral RT, as find_g_points binds them."""
    rng = np.random.default_rng(seed)
    p_hl = np.exp(np.linspace(np.log(100.0), np.log(1.013e5), nlay + 1))
    t_hl = np.linspace(210.0, 284.0, nlay + 1)
    wav = np.sort(rng.uniform(1.0, 2000.0, nwav))
    dwav = np.full(nwav, 2000.0 / nwav)
    col = np.sort(10.0 ** rng.uniform(-3, 2, nwav))
    od = col[None, :] * rng.dirichlet(np.ones(nlay), nwav).T
    od[:, :5] = 0.0                       # zero metric for the log fit
    bg = rng.gamma(0.5, 0.01, (nlay, nwav)) if with_bg else np.zeros_like(od)
    planck_hl = np.array(jplanck(t_hl, wav, dwav))
    fd, fu = (np.array(a) for a in jrt_lw(planck_hl, od + bg,
                                            np.ones(nwav), planck_hl[-1]))
    hr = np.array(jheating_rate(p_hl, fd, fu))
    lw = np.sqrt(p_hl[1:]) - np.sqrt(p_hl[:-1])
    return dict(layer_weight=lw / lw.sum(), pressure_hl=p_hl,
                surf_emissivity=np.ones(nwav), surf_planck=planck_hl[-1],
                flux_dn_surf=fd[-1], flux_up_toa=fu[0], planck_hl=planck_hl,
                bg_od=bg, metric=od, hr=hr)


def _metric(method, od):
    if method in ("transmission", "transmission-2"):
        scale = 1.66 * (2.0 if method == "transmission-2" else 1.0)
        return -np.expm1(-scale * od)
    if method == "square-root":
        return np.sqrt(od)
    return od


# Candidate sets of a sweep: a full partition (one group), a set that the
# bucket pads at the front, a shared boundary index, and single points
_INTERVALS = [
    ([0, 512, 1024, 1536], [511, 1023, 1535, 2047]),
    ([0, 100, 900], [99, 899, 2047]),
    ([0, 700, 1400], [700, 1400, 2047]),
    ([3, 4, 2047], [3, 2000, 2047]),
]


@pytest.mark.parametrize("method", ["transmission", "linear", "logarithmic",
                                    "square-root", "transmission-2"])
def test_candidate_costs(method):
    arrays = _band()
    arrays["metric"] = _metric(method, arrays["metric"])
    jcost = JCost(method, 0.02, **arrays)
    cost = CandidateCostLw(method, 0.02,
                           **lw_band_state(arrays, "cpu", torch.float64))
    for i1, i2 in _INTERVALS:
        i1 = np.asarray(i1, np.int32)
        i2 = np.asarray(i2, np.int32)
        want = jcost.costs(i1, i2)
        got = cost.costs(i1, i2)
        assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()


def test_equipartition_matches():
    """The same equipartition search on both kernels ends on identical
    bounds."""
    arrays = _band(seed=1, with_bg=False)
    arrays["metric"] = _metric("transmission", arrays["metric"])
    eqs = [JEq(JCost("transmission", 0.02, **arrays)),
           CkdEquipartition(CandidateCostLw(
               "transmission", 0.02,
               **lw_band_state(arrays, "cpu", torch.float64)))]
    out = []
    for eq in eqs:
        eq.set_partition_max_iterations(30)
        eq.set_verbose(False)
        status, bounds, error = eq.equipartition_e(0.4, 0.0, 1.0)
        out.append((status.name, [eq.lower_index(b) for b in bounds],
                    np.asarray(error)))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=1e-11)


@pytest.mark.parametrize("method", ["transmission", "linear", "logarithmic",
                                    "square-root"])
def test_fit_optical_depth_lw(method):
    arrays = _band(seed=2)
    metric = _metric(method, arrays["metric"])
    i1 = np.array([0, 3, 700, 1400], np.int32)
    i2 = np.array([2, 700, 1399, 2047], np.int32)
    want = jfit(method, arrays["planck_hl"], metric, i1, i2)
    got = fit_optical_depth_lw(method, T(arrays["planck_hl"]), T(metric),
                               T(i1), T(i2))
    _close(got, want)


@pytest.mark.parametrize("method", [
    "linear", "transmission", "transmission-3", "square-root",
    "logarithmic", "hybrid-logarithmic-transmission-3"])
def test_average_od_to_gpoints(method):
    rng = np.random.default_rng(4)
    nz, nwav, ng = 15, 3000, 7
    od = rng.gamma(0.4, 1.0, (nz, nwav))
    od[:, :40] = 0.0
    weight = np.abs(rng.normal(1.0, 0.3, (nz, nwav)))
    g_point = rng.integers(-1, ng - 1, nwav)    # g-point ng-1 stays empty
    g_point[:8] = 2
    p_fl = np.exp(np.linspace(np.log(200.0), np.log(1.0e5), nz))
    want = javerage(ng, g_point, od, weight, method, pressure_fl=p_fl)
    got = average_od_to_gpoints(ng, T(g_point), T(od), T(weight), method,
                                pressure_fl=T(p_fl))
    for g, w in zip(got, want):
        _close(g, w)
