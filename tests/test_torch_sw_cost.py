"""The port's SW candidate cost against the JAX package and against the
independent f64 oracle ``csrc/crosscheck.cpp``, on the CPU in float64.

Both ``CandidateCostSw`` classes are bound to the same numpy arrays (the
rig of tests/test_sharded_sweep.py), the port's through
``convert.sw_band_state``.  Costs agree to 1e-12 of the largest cost of
the batch: the two packages differ only in the order of f64 sums, and a
near-zero cost of a one-point interval has no relative accuracy.
"""

import numpy as np
import pytest
import torch

from ecckd_tpu.partition import native_baseline
from ecckd_tpu.partition.cost_kernel import CandidateCostSw as JCost
from ecckd_tpu.partition.cost_kernel import CkdEquipartition as JEq
from ecckd_tpu_torch.convert import SW_BAND_ARRAYS, sw_band_state
from ecckd_tpu_torch.partition import CandidateCostSw, CkdEquipartition
from test_sharded_sweep import probe_batches, sw_args

METHODS = ["linear", "transmission", "transmission-2", "square-root",
           "logarithmic", "total-transmission"]
NWAV = 1000


def _kernels(method, albedo=0.15, seed=0):
    """(JAX kernel, port kernel, args, extras) on one rig."""
    args, extras, _ = sw_args(method, NWAV, seed=seed, albedo=albedo)
    jcost = JCost(*args, extras=extras, use_pallas=False)
    names = ("layer_weight", None, "pressure_hl") + SW_BAND_ARRAYS[2:]
    arrays = {k: v for k, v in zip(names, args[2:]) if k is not None}
    cost = CandidateCostSw(method, args[1], cos_sza=args[3],
                           **sw_band_state(arrays, extras, "cpu",
                                           torch.float64))
    return jcost, cost, args, extras


def _assert_costs_close(got, want):
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# Probe batches of a search: a partition sweep, a batch the bucket pads at
# the front, a shared boundary index and single probes
_EXTRA_PROBES = [
    ([0, 100, 900], [99, 899, NWAV - 1]),
    ([0, 300, 600], [300, 600, NWAV - 1]),
    ([3, 4, NWAV - 1], [3, 900, NWAV - 1]),
]


@pytest.mark.parametrize("albedo", [0.0, 0.15])
@pytest.mark.parametrize("method", METHODS)
def test_candidate_costs(method, albedo):
    jcost, cost, _, _ = _kernels(method, albedo)
    assert cost.with_upwelling == jcost.with_upwelling == (albedo > 0)
    for i1, i2 in probe_batches(NWAV) + _EXTRA_PROBES:
        i1 = np.asarray(i1, np.int32)
        i2 = np.asarray(i2, np.int32)
        _assert_costs_close(cost.costs(i1, i2), jcost.costs(i1, i2))


def test_vector_albedo():
    """A per-wavenumber albedo (bands of different no-Rayleigh albedo)."""
    args, _, _ = sw_args("transmission", NWAV, seed=6)
    albedo = np.zeros(NWAV)
    albedo[:450] = 0.2
    args = args[:6] + (albedo,) + args[7:]
    jcost = JCost(*args, use_pallas=False)
    arrays = dict(zip(("layer_weight", "pressure_hl") + SW_BAND_ARRAYS[2:],
                      args[2:3] + args[4:]))
    cost = CandidateCostSw("transmission", 0.02, cos_sza=args[3],
                           **sw_band_state(arrays, None, "cpu",
                                           torch.float64))
    for i1, i2 in probe_batches(NWAV, seed=9):
        _assert_costs_close(cost.costs(i1, i2), jcost.costs(i1, i2))


@pytest.fixture
def native():
    if not native_baseline.available():
        pytest.skip("native cross-check library unavailable (needs g++)")
    return native_baseline


@pytest.mark.parametrize("method", ["transmission", "total-transmission"])
def test_costs_match_native_oracle(native, method):
    """The independent f64 C++ implementation of the SW cost (the oracle
    that tests/test_native_baseline.py holds the JAX kernel to)."""
    _, cost, args, extras = _kernels(method, seed=4)
    for i1, i2 in probe_batches(NWAV, seed=2):
        got = cost.costs(i1, i2)
        if method == "transmission":
            want = native.sw_cost_transmission(
                args[3], args[2], args[4], args[5], args[6], args[7],
                args[8], args[9], args[10], args[11], i1, i2, args[1])
        else:
            want = native.sw_cost_total_transmission(
                args[3], args[2], args[4], args[5], args[6], args[9],
                args[10], extras, i1, i2, args[1])
        _assert_costs_close(got, want)


@pytest.mark.parametrize("method", ["transmission", "total-transmission"])
def test_equipartition_matches(method):
    """The same equipartition search on both kernels ends on identical
    bounds."""
    jcost, cost, _, _ = _kernels(method, seed=1)
    out = []
    for eq in (JEq(jcost), CkdEquipartition(cost)):
        eq.set_partition_max_iterations(30)
        eq.set_verbose(False)
        status, bounds, error = eq.equipartition_e(0.5 * float(np.median(
            jcost.costs(np.array([0], np.int32),
                        np.array([NWAV - 1], np.int32)))), 0.0, 1.0)
        out.append((status.name, [eq.lower_index(b) for b in bounds],
                    np.asarray(error)))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]
    assert len(out[0][1]) > 2
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=1e-11)


@pytest.mark.parametrize("method", ["transmission", "total-transmission"])
def test_components(method):
    """The debug_partition components: MID for a plain method; LOW, HIGH
    and MID for total-transmission."""
    jcost, cost, _, _ = _kernels(method, seed=2)
    i1 = np.array([0, 200, 650], np.int32)
    i2 = np.array([199, 649, NWAV - 1], np.int32)
    want = jcost.components(i1, i2, JEq(jcost)._seg_of_wav(i1))
    got = cost.components(i1, i2)
    assert sorted(got) == sorted(want)
    for tag in want:
        assert sorted(got[tag]) == sorted(want[tag])
        for key, w in want[tag].items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[tag][key], w, rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max(),
                                       err_msg=f"{tag} {key}")
