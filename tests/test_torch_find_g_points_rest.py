"""The rest of find_g_points in ecckd_tpu_torch against the JAX package,
on the CPU in float64: ``g_split`` sub-bands, ``band_parallel`` probe
batching and the cost kernels' prefix-sum path.

Bars: g-point ranks and maps identical, errors to 1e-3 of the largest (the
transmission conditioning of tests/test_torch_pipeline.py); a band's
probes on a gas-level kernel against a band-sliced kernel to 1e-12; a
merged dispatch against direct calls to 1e-13 (the CPU plain versions'
sums of an interval depend on the launch's shape); band_parallel runs of
the port bit-identical to each other, and against JAX's parallel run and
the port's own per-band run the same g-point counts, ranks within 2 and
errors to 1e-3 (tests/test_band_parallel.py's bars); prefix sums to 1e-12
(f64) and 1e-6 (f32) of JAX's, prefix costs to 1e-10 of JAX's prefix
costs and of the port's K3 path.
"""

import threading

import numpy as np
import pytest
import torch

from ecckd_tpu.config import Config
from ecckd_tpu.io import NcFile
from ecckd_tpu.ops.segments import build_prefix_sums as jbuild_prefix
from ecckd_tpu.ops.segments import interval_sum_from_prefix as jfrom_prefix
from ecckd_tpu.ops.segments import part_of as jpart_of
from ecckd_tpu.partition.cost_kernel import CandidateCostLw as JCostLw
from ecckd_tpu.partition.cost_kernel import CandidateCostSw as JCostSw
from ecckd_tpu.tools.find_g_points import find_g_points as jfind_g_points
from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum as jreorder
from ecckd_tpu_torch.convert import lw_band_state, sw_band_state
from ecckd_tpu_torch.partition import CandidateCostLw, CandidateCostSw
from ecckd_tpu_torch.partition import cost_kernel
from ecckd_tpu_torch.partition.band_parallel import (BandKernelView,
                                                     ProbeScheduler)
from ecckd_tpu_torch.ops.segments import (build_prefix_sums,
                                          interval_sum_from_prefix, part_of)
from ecckd_tpu_torch.tools import find_g_points as tfgp
from synth import synth_spectrum_file
from test_sharded_sweep import lw_args, sw_args

CPU = {"device": "cpu"}


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _lw_kernel(args, sl=slice(None), **kw):
    """The port's LW kernel on lw_args' arrays, sliced to the ranks sl."""
    names = ("layer_weight", "pressure_hl", "surf_emissivity", "surf_planck",
             "flux_dn_surf", "flux_up_toa", "planck_hl", "bg_od", "metric",
             "hr")
    arrays = {k: (a if k in names[:2] else np.asarray(a)[..., sl])
              for k, a in zip(names, args[2:])}
    return CandidateCostLw(args[0], args[1],
                           **lw_band_state(arrays, "cpu", torch.float64),
                           **kw)


def _sw_kernel(args, extras, sl=slice(None), albedo=None, **kw):
    (method, flux_weight, layer_weight, cos_sza, pressure_hl, ssi, alb,
     fd, fu, bg, metric, hr) = args
    cut = lambda a: np.asarray(a)[..., sl]
    arrays = dict(layer_weight=layer_weight, pressure_hl=pressure_hl,
                  ssi=cut(ssi), surf_albedo=alb if albedo is None else albedo,
                  flux_dn_surf=cut(fd), flux_up_toa=cut(fu), bg_od=cut(bg),
                  metric=cut(metric), hr=cut(hr))
    ex = None if extras is None else {
        k: (v if np.ndim(v) == 0 else cut(v)) for k, v in extras.items()}
    return CandidateCostSw(method, flux_weight, cos_sza=cos_sza,
                           **sw_band_state(arrays, ex, "cpu", torch.float64),
                           **kw)


def _probes(n, nseg, seed):
    edges = np.sort(np.random.default_rng(seed).choice(
        np.arange(1, n), nseg - 1, replace=False))
    return (np.r_[0, edges].astype(np.int32),
            np.r_[edges - 1, n - 1].astype(np.int32))


# ------------------------------------------------------------- g_split

@pytest.fixture(scope="module")
def gsplit_rig(tmp_path_factory):
    """tests/test_advanced_features.py's rig: h2o, 1024 wavenumbers, 6
    profiles, the JAX order file."""
    d = tmp_path_factory.mktemp("torch_gsplit")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o", nwav=1024,
                              ncol=6, seed=3)
    order = str(d / "order.h5")
    jreorder(Config({"input": h2o, "output": order}), argv=["r"])
    return dict(d=d, h2o=h2o, order=order)


def _gsplit_config(rig, output, **extra):
    cfg = {"output": output, "gases": "h2o", "heating_rate_tolerance": "0.5",
           "averaging_method": "transmission",
           "h2o.reordering_input": rig["order"], "h2o.input": rig["h2o"],
           "h2o.g_split": "0.5", "h2o.subband_wavenumber_boundary": "1000",
           **extra}
    return Config({k: v for k, v in cfg.items() if v is not None})


def _read(path, names):
    with NcFile(path) as f:
        return {k: np.asarray(f.read(k)) for k in names}


def test_g_split_matches_jax(gsplit_rig):
    names = ("h2o_n_g_points", "h2o_rank1", "h2o_rank2", "h2o_error",
             "g_point", "h2o_g_point", "wavenumber")
    out = {}
    for tag, tool, dev in (("jax", jfind_g_points, {}),
                           ("torch", tfgp.find_g_points, CPU)):
        path = str(gsplit_rig["d"] / f"gp_{tag}.h5")
        tool(_gsplit_config(gsplit_rig, path, **dev), argv=["find_g_points"])
        out[tag] = _read(path, names)
    jax, got = out["jax"], out["torch"]
    for k in ("h2o_n_g_points", "h2o_rank1", "h2o_rank2", "g_point",
              "h2o_g_point"):
        np.testing.assert_array_equal(got[k], jax[k], err_msg=k)
    _close(got["h2o_error"], jax["h2o_error"], 1e-3)
    # tests/test_advanced_features.py:42-58 on the port's file
    r1, r2, gp = got["h2o_rank1"], got["h2o_rank2"], got["h2o_g_point"]
    ng = len(r1)
    assert ng >= 3
    assert np.all(r2 >= r1) and np.all(r1[1:] <= r2[:-1] + 1)
    assert gp.min() >= 0 and gp.max() == ng - 1
    wav = got["wavenumber"]
    assert wav[gp == 0].max() <= 1000.0 or wav[gp == 1].max() <= 1000.0


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("extra,match", [
    ({"h2o.subband_wavenumber_boundary": None},
     "subband_wavenumber_boundary"),
    ({"h2o.base_split": "0.5"}, "both g_split and base_split")])
def test_g_split_errors(gsplit_rig, tmp_path, package, extra, match):
    cfg = _gsplit_config(gsplit_rig, str(tmp_path / "x.h5"), **extra,
                         **({} if package == "jax" else CPU))
    tool = jfind_g_points if package == "jax" else tfgp.find_g_points
    with pytest.raises(ValueError, match=match):
        tool(cfg, argv=["find_g_points"])


def test_g_split_core_raises_before_searching():
    gas = tfgp.GasInput("h2o", *([np.zeros(1)] * 10), g_split=[0.5])
    with pytest.raises(ValueError, match="subband_wavenumber_boundary"):
        tfgp.find_g_points_core([gas], 0.5, device="cpu")


# ------------------------------------------------------------- band_parallel

def test_gas_kernel_band_probes_match_per_band():
    args, _ = lw_args("transmission", 384)
    gas = _lw_kernel(args)
    for b1, b2 in ((0, 127), (128, 383)):
        n = b2 - b1 + 1
        sliced = _lw_kernel(args, slice(b1, b2 + 1))
        i1, i2 = _probes(n, 4, seed=b1)
        _close(BandKernelView(gas, b1, n).costs(i1, i2),
               sliced.costs(i1, i2), 1e-12)


def _run_threads(sched, nband, body):
    for _ in range(nband):
        sched.register()

    def run(j):
        try:
            body(j)
        finally:
            sched.done()

    threads = [threading.Thread(target=run, args=(j,)) for j in range(nband)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def test_scheduler_merges_and_matches_direct():
    args, _ = lw_args("transmission", 512, seed=5)
    gas = _lw_kernel(args)
    sched = ProbeScheduler(gas)
    bands = [(0, 255), (256, 511)]
    probes = {0: (np.array([0, 60], np.int32), np.array([59, 200], np.int32)),
              1: (np.array([10], np.int32), np.array([250], np.int32))}
    direct = {j: BandKernelView(gas, b1, b2 - b1 + 1).costs(*probes[j])
              for j, (b1, b2) in enumerate(bands)}
    got = {}

    def body(j):
        b1, b2 = bands[j]
        got[j] = BandKernelView(gas, b1, b2 - b1 + 1, sched, j).costs(
            *probes[j])

    _run_threads(sched, 2, body)
    assert sched.dispatches == 1
    for j in range(2):
        _close(got[j], direct[j], 1e-13)


class _Boom:
    npoints = 64

    def costs(self, i1, i2):
        raise ValueError("boom")


def test_scheduler_error_propagates():
    sched = ProbeScheduler(_Boom())
    errs = {}

    def body(j):
        try:
            sched.costs(j, np.array([0]), np.array([1]))
        except RuntimeError as e:
            errs[j] = e

    _run_threads(sched, 2, body)
    assert sorted(errs) == [0, 1]
    assert isinstance(sched.error, ValueError)
    assert all(e.__cause__ is sched.error for e in errs.values())
    with pytest.raises(RuntimeError):   # the error stays set
        sched.costs(0, np.array([0]), np.array([1]))


def test_search_bands_reraises_in_the_caller():
    """A failed dispatch and a failed band search both reach the caller
    after every band thread has ended."""
    def search(jband, view):
        return view.costs(np.array([0]), np.array([1]))

    with pytest.raises(ValueError, match="boom"):
        tfgp._search_bands(_Boom(), [(0, 31), (32, 63)], search, "parallel")

    def failing(jband, view):
        if jband == 1:
            raise KeyError("band 1")
        return view.costs(np.array([0]), np.array([1]))

    args, _ = lw_args("transmission", 64)
    with pytest.raises(KeyError, match="band 1"):
        tfgp._search_bands(_lw_kernel(args), [(0, 31), (32, 63)], failing,
                           "parallel")


def test_sw_vector_albedo_equals_scalar_per_band():
    args, extras, _ = sw_args("transmission", 400, albedo=0.0)
    albedo = np.zeros(400)
    albedo[:160] = 0.15
    gas = _sw_kernel(args, extras, albedo=albedo)
    assert gas.with_upwelling
    for (b1, b2), alb in (((0, 159), 0.15), ((160, 399), 0.0)):
        n = b2 - b1 + 1
        sliced = _sw_kernel(args, extras, slice(b1, b2 + 1), albedo=alb)
        i1, i2 = _probes(n, 3, seed=b1)
        _close(BandKernelView(gas, b1, n).costs(i1, i2),
               sliced.costs(i1, i2), 1e-10)


@pytest.mark.parametrize("value,device,nband,debug,want", [
    ("auto", "cpu", 3, False, "off"), ("auto", "cuda", 3, False, "parallel"),
    (1, "cpu", 3, False, "parallel"), ("serial", "cpu", 3, False, "serial"),
    ("0", "cuda", 3, False, "off"), ("parallel", "cuda", 1, False, "off"),
    ("parallel", "cuda", 3, True, "off")])
def test_band_mode(value, device, nband, debug, want):
    assert tfgp._band_mode(value, torch.device(device), nband,
                           debug) == want


def test_band_mode_rejects_unknown_values():
    with pytest.raises(ValueError, match="band_parallel"):
        tfgp._band_mode("sometimes", torch.device("cpu"), 3, False)


@pytest.fixture(scope="module")
def multiband(tmp_path_factory):
    """tests/test_band_parallel.py's rig: h2o over three LW bands."""
    d = tmp_path_factory.mktemp("torch_bp")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o", nwav=1024,
                              seed=7)
    order = str(d / "order.h5")
    jreorder(Config({"input": h2o, "output": order,
                     "wavenumber1": "0 700 1400",
                     "wavenumber2": "700 1400 2001"}), argv=["r"])
    return dict(d=d, h2o=h2o, order=order)


_BP_NAMES = ("h2o_n_g_points", "h2o_rank1", "h2o_rank2", "h2o_error",
             "g_point")


def _run_bp(rig, tag, band_parallel, package="torch"):
    """The g-point file of one run and the number of candidate-cost calls
    (dispatches) it made."""
    out = str(rig["d"] / f"gp_{package}_{tag}.h5")
    calls = [0]
    if package == "torch":
        cls, tool = cost_kernel._CandidateCostBase, tfgp.find_g_points
        dev = CPU
    else:
        from ecckd_tpu.partition import cost_kernel as jcost_kernel
        cls, tool, dev = jcost_kernel._CandidateCostBase, jfind_g_points, {}
    orig = cls.costs

    def counted(self, *a, **k):
        calls[0] += 1
        return orig(self, *a, **k)

    cls.costs = counted
    try:
        tool(Config({"output": out, "gases": "h2o",
                     "heating_rate_tolerance": "0.4",
                     "averaging_method": "transmission",
                     "band_parallel": band_parallel,
                     "h2o.reordering_input": rig["order"],
                     "h2o.input": rig["h2o"], **dev}),
             argv=["find_g_points"])
    finally:
        cls.costs = orig
    return _read(out, _BP_NAMES), calls[0]


@pytest.fixture(scope="module")
def bp_runs(multiband):
    return {key: _run_bp(multiband, *key) for key in (
        ("parallel", "parallel"), ("parallel_b", "1"), ("serial", "serial"),
        ("off", "off"), ("jax_parallel", "parallel", "jax"))}


def test_band_parallel_runs_bit_identical(bp_runs):
    (a, na), (b, nb) = bp_runs["parallel", "parallel"], \
        bp_runs["parallel_b", "1"]
    for k in _BP_NAMES:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert na == nb


def _structurally_equal(got, want):
    np.testing.assert_array_equal(got["h2o_n_g_points"],
                                  want["h2o_n_g_points"])
    assert np.max(np.abs(got["h2o_rank1"].astype(np.int64)
                         - want["h2o_rank1"])) <= 2
    _close(got["h2o_error"], want["h2o_error"], 1e-3)


@pytest.mark.parametrize("other", [("off", "off"),
                                   ("jax_parallel", "parallel", "jax")])
def test_band_parallel_matches(bp_runs, other):
    _structurally_equal(bp_runs["parallel", "parallel"][0], bp_runs[other][0])


def test_band_parallel_fewer_dispatches_than_serial(bp_runs):
    par, serial = bp_runs["parallel", "parallel"], bp_runs["serial", "serial"]
    _structurally_equal(par[0], serial[0])
    assert par[1] < serial[1], (par[1], serial[1])


# ------------------------------------------------------------- prefix path

@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)])
def test_prefix_sums_match_jax(dtype, rtol):
    rng = np.random.default_rng(4)
    n = 3000
    rows = rng.gamma(0.5, 1.0, (7, n)).astype(dtype)
    w = rng.uniform(0.5, 1.5, n).astype(dtype)
    i1, i2 = _probes(n, 9, seed=2)
    i1 = np.r_[0, 0, i1].astype(np.int32)     # front-padded bucket columns
    i2 = np.r_[0, 0, i2].astype(np.int32)
    want = np.asarray(jfrom_prefix(*jbuild_prefix(
        [jpart_of(rows, w), jpart_of(w)], n), i1, i2))
    t = torch.from_numpy
    hi, lo = build_prefix_sums([part_of(t(rows), t(w)), part_of(t(w))], n,
                               row_chunk=4)
    assert hi.shape == (8, n + 1) and hi.dtype == t(rows).dtype
    got = interval_sum_from_prefix(hi, lo, t(i1), t(i2)).numpy()
    _close(got, want, rtol)
    exact = np.stack([(np.vstack([rows * w, w]).astype(np.float64)
                       [:, a:b + 1]).sum(1) for a, b in zip(i1, i2)], 1)
    _close(got, exact, rtol)


def _no_k3(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("K3 called on the prefix path")
    monkeypatch.setattr(cost_kernel, "fused_interval_sum", refuse)


def _batches(n):
    i1, i2 = _probes(n, 7, seed=1)
    q = n // 4
    return [(i1, i2), (np.array([q], np.int32), np.array([q + 3], np.int32)),
            (np.array([q], np.int32), np.array([3 * q], np.int32))]


@pytest.mark.parametrize("method", ["linear", "transmission", "logarithmic"])
def test_lw_prefix_costs(method, monkeypatch):
    args, _ = lw_args(method, 700)
    k3 = _lw_kernel(args)
    prefix = _lw_kernel(args, use_prefix=True)
    jprefix = JCostLw(*args, use_pallas=False, use_prefix=True)
    assert prefix.use_prefix and jprefix.use_prefix
    want_k3 = [k3.costs(i1, i2) for i1, i2 in _batches(700)]
    _no_k3(monkeypatch)
    for (i1, i2), w in zip(_batches(700), want_k3):
        got = prefix.costs(i1, i2)
        _close(got, jprefix.costs(i1, i2), 1e-10)
        _close(got, w, 1e-10)


@pytest.mark.parametrize("method", ["linear", "transmission",
                                    "total-transmission"])
def test_sw_prefix_costs(method, monkeypatch):
    args, extras, _ = sw_args(method, 600)
    k3 = _sw_kernel(args, extras)
    prefix = _sw_kernel(args, extras, use_prefix=True)
    jprefix = JCostSw(*args, extras=extras, use_pallas=False,
                      use_prefix=True)
    want_k3 = [k3.costs(i1, i2) for i1, i2 in _batches(600)]
    _no_k3(monkeypatch)
    for (i1, i2), w in zip(_batches(600), want_k3):
        got = prefix.costs(i1, i2)
        _close(got, jprefix.costs(i1, i2), 1e-10)
        _close(got, w, 1e-10)


def test_prefix_is_off_by_default():
    args, _ = lw_args("linear", 64)
    assert not _lw_kernel(args).use_prefix


def test_find_g_points_with_prefix(multiband):
    """A whole search on the prefix path: the per-band search's g-points
    within 2 ranks, the same counts."""
    want = _run_bp(multiband, "off_k3", "off")[0]
    from ecckd_tpu_torch.io import read_order
    from ecckd_tpu_torch.io.spectrum import read_spectrum
    order = read_order(multiband["order"])
    sp = read_spectrum(multiband["h2o"], 0)
    gas = tfgp.GasInput("h2o", order.rank, order.band_number,
                        order.wavenumber1_band, order.wavenumber2_band,
                        order.sorting_variable, sp.pressure_hl,
                        sp.temperature_hl, sp.wavenumber, sp.d_wavenumber,
                        sp.optical_depth)
    got = tfgp.find_g_points_core([gas], 0.4, averaging_method="transmission",
                                  device="cpu",
                                  cost_options={"use_prefix": True})
    g = got.gases[0]
    _structurally_equal({"h2o_n_g_points": g.n_g_points,
                         "h2o_rank1": g.rank1, "h2o_error": g.error}, want)
