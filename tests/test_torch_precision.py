"""The port's float32 chain held against its float64 chain on the CPU.

``ecckd_tpu_torch.scripts.precision`` runs reorder_core -> find_g_points_core
-> create_lut_core in both precisions on the LW rig of
tests/test_torch_pipeline.py and the two-band SW rig of
tests/test_torch_sw_pipeline.py, at the bounds PARITY.md sets for the
reference's own float32 (LW costs 1e-5, SW costs 2e-4, linear averaging
1e-5, transmission averaging 5e-4).  Float32 departs from float64 beyond
them in two places, and the comparison shows each rather than widening a
bound: the transmission clamp moves every LW interval's cost and the LW
g-point bounds, and the float32 range of the total-transmission fit's
level fluxes moves SW costs and ranks.  With the float64 search given
float32's clamp and range (not its rounding), every probe is back within
its bound and the ranks are float32's; every interval whose float64 cost
those limits leave alone is within its bound in float32 as it is, and
in SW the intervals they change are exactly those with an empty level
flux in float32 and none in float64.  A rank that the reorder moves is a
tie of the sorting variable within float32's rounding.  chip_smoke.py
runs the same comparison on the card.
"""

import numpy as np
import pytest
import torch

from ecckd_tpu_torch.ops import average
from ecckd_tpu_torch.partition import cost_kernel
from ecckd_tpu_torch.scripts import precision
from ecckd_tpu_torch.scripts.exp_kernels import build_inputs

KINDS = ["lw", "sw"]


@pytest.fixture(scope="module", params=KINDS)
def run(request):
    lev, fail = precision.compare(request.param, "cpu")
    return request.param, lev, fail


def test_no_failures(run):
    kind, lev, fail = run
    assert fail == [], (kind, lev)


def test_reorder_ties(run):
    """The sorting variable to 1e-5; every pair of wavenumbers that
    float32 orders the other way round is a tie within its rounding."""
    kind, lev, _ = run
    assert lev["sorting_variable"] <= precision.SORTING_BOUND
    assert lev["order_inversions"] <= lev["order_ranks_moved"]
    if kind == "lw":    # two neighbours swap at 6.3639579 and 6.3639588
        assert lev["order_ranks_moved"] == 2


def test_probe_costs(run):
    """Every cost the float32 search computed is within the bound of the
    float64 cost of the same probe once float64 takes float32's clamp and
    range, and, as it is, wherever those limits change no float64 cost;
    the LW clamp changes every interval's cost, the SW range exactly
    those of the intervals with an empty flux in float32 only."""
    kind, lev, _ = run
    bound = precision.COST_BOUND[kind]
    assert lev["probes"] > 0
    assert lev["probe_err_float32_limits"] <= bound
    assert lev["probe_err_native_untouched"] <= bound
    assert 0 < lev["intervals_beyond_bound_native"] \
        <= lev["intervals_touched_by_limits"]
    if kind == "lw":
        assert lev["intervals_touched_by_limits"] == lev["intervals"]
    else:
        assert lev["intervals_touched_not_empty_in_float32_only"] == 0
        assert lev["intervals_touched_by_limits"] \
            == lev["intervals_empty_in_float32_only"]


def test_g_points(run):
    """The ranks move with float64's own clamp and range and are float32's
    with float32's; the per-g-point errors then agree within the bound of
    their cost scale."""
    kind, lev, _ = run
    assert not lev["ranks_identical_native"]
    assert lev["ranks_identical_float32_limits"]
    assert lev["error_err_float32_limits"] <= precision.COST_BOUND[kind]


def test_lut(run):
    """Linear averaging to 1e-5; transmission averaging to 5e-4 where
    -log1p(-mean) is well conditioned, and within its conditioning
    elsewhere."""
    _, lev, _ = run
    assert lev["lut_linear"] <= precision.LINEAR_BOUND
    assert lev["lut_transmission_well_conditioned"] \
        <= precision.TRANSMISSION_BOUND
    assert lev["lut_transmission_over_allowed"] <= 1.0


def test_fit_limits():
    """A fit given float32's limits takes float32's transmission clamp,
    and the total-transmission levels below float32's smallest normal
    number are zero; by default each dtype keeps its own."""
    f64, f32 = torch.float64, torch.float32
    planck = torch.ones(3, 4, dtype=f64)
    metric = torch.zeros(2, 4, dtype=f64)
    i1 = torch.tensor([0], dtype=torch.int32)
    # interval sums whose mean transmission is 1 - 1e-9 in both layers
    sums = torch.tensor([[1.0 - 1e-9]] * 2 + [[1.0]] * 2, dtype=f64)
    od = {limits: average.fit_parts_lw("transmission", planck, metric,
                                       limits)[2](sums, i1, i1)
          for limits in (None, f32)}
    clamp32 = average._trans_clamp(f32)
    assert clamp32 < 1.0 - 1e-9 < average._trans_clamp(f64)
    want = -np.log1p(-clamp32) / 1.66
    np.testing.assert_allclose(od[f32].numpy(), want, rtol=1e-12)
    assert (od[None] > od[f32]).all()
    ssi = torch.ones(4, dtype=f64)
    od = torch.tensor([[1.0, 20.0, 40.0, 50.0]], dtype=f64)
    levels = {limits: average.total_trans_fit_parts(
        ssi, torch.zeros_like(od), od, limits)[0][0].arrays[0]
        for limits in (None, f32)}
    low = levels[None] < torch.finfo(f32).tiny
    assert low.any() and (levels[None][low] > 0).all()
    assert (levels[f32][low] == 0).all()
    assert torch.equal(levels[f32][~low], levels[None][~low])


def _lw_kernel(**options):
    d = build_inputs(6, 512, 4, torch.float64, "cpu")
    return cost_kernel.CandidateCostLw(
        "transmission", 0.02, layer_weight=d["layer_weight"],
        pressure_hl=d["pressure_hl"], surf_emissivity=d["surf_emissivity"],
        surf_planck=d["surf_planck"], flux_dn_surf=d["flux_dn_surf"],
        flux_up_toa=d["flux_up_toa"], planck_hl=d["planck_hl"],
        bg_od=d["bg_od"], metric=d["metric"], hr=d["hr"], **options)


def test_probe_log_and_zero_fit_costs():
    """The kernel logs every costs call when given a list, and the cost
    of a zero fit is the cost formula on the truth alone."""
    log = []
    k = _lw_kernel(probe_log=log)
    i1, i2 = np.array([0, 100, 300]), np.array([99, 299, 511])
    costs = k.costs(i1, i2)
    assert len(log) == 1 and log[0][0] is k
    np.testing.assert_array_equal(log[0][1], i1)
    np.testing.assert_array_equal(log[0][3], costs)
    assert _lw_kernel().probe_log is None
    hr = torch.stack([k.hr[:, a:b + 1].sum(1) for a, b in zip(i1, i2)], 1)
    fd = torch.stack([k.flux_dn_surf[a:b + 1].sum() for a, b in zip(i1, i2)])
    fu = torch.stack([k.flux_up_toa[a:b + 1].sum() for a, b in zip(i1, i2)])
    want = torch.sqrt(cost_kernel.HR_WEIGHT ** 2
                      * (k.layer_weight[:, None] * hr * hr).sum(0)
                      + 0.02 * (fd * fd + fu * fu))
    np.testing.assert_allclose(k.zero_fit_costs(i1, i2), want.numpy(),
                               rtol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_small_rig_is_the_synth_rig(kind, tmp_path):
    """The comparison's arrays are those tests/synth.py writes for the
    pipeline tests (od stored as float32)."""
    from ecckd_tpu_torch.io import read_spectrum
    from synth import synth_spectrum_file
    profiles, ssi, _, _ = precision.small_rig(kind)
    sw = kind == "sw"
    path = synth_spectrum_file(str(tmp_path / "s.h5"), molecule="h2o",
                               nwav=1024, ncol=6 if sw else 5,
                               seed=11 if sw else 3, is_sw=sw)
    for icol, prof in enumerate(profiles):
        sp = read_spectrum(path, icol)
        np.testing.assert_array_equal(sp.wavenumber, prof.wavenumber)
        np.testing.assert_array_equal(sp.temperature_hl, prof.temperature_hl)
        np.testing.assert_allclose(sp.optical_depth, prof.optical_depth,
                                   rtol=1e-7)
    assert (ssi is not None) == sw


def test_compare_defaults_to_the_card(monkeypatch):
    """compare() runs on the card unless asked for the CPU: without one it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        precision.compare("lw")
