"""The port's meshes and sharded execution against the JAX package's, on the
CPU in float64.

JAX runs over the eight virtual CPU devices of tests/conftest.py, the port
over as many logical CPU shards (``make_mesh(devices=[cpu] * n)``); the
same seeded numpy inputs go through both.  Held:
* ``make_mesh``'s (data, spectral) shapes for 1, 2, 4 and 8 devices;
* the four sharded-averaging entry points for all eight averaging methods
  over 2, 4 and 8 shards, against JAX's mesh runs (1e-10), with min and max
  bit-identical, and the empty and all-zero g-point cases; on a mesh of
  one spectral shard, the one-device averages' bits;
* the sharded LW and SW candidate costs (CandidateCostLw/Sw with ``mesh``)
  against JAX's mesh mode (1e-10 of the batch's largest cost), including a
  band smaller than the mesh;
* the find_g_points and create_lut tools sharded (the ``sharded`` rule
  handed a mesh of logical shards) against unsharded and against the JAX
  tools with ``sharded=1``, on the LW and two-band SW rigs: identical
  ranks, the LUT within 1e-10 and its min and max identical;
* ``solve(data_parallel=True)`` against one shard and against JAX's, as
  tests/test_parallel.py holds JAX's, including 5 profiles over 8 shards.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from ecckd_tpu.config import Config as JConfig
from ecckd_tpu.io import NcFile, read_spectrum
from ecckd_tpu.ops.average import GPOINT_AVERAGING_METHODS
from ecckd_tpu.parallel import make_mesh as jmake_mesh
from ecckd_tpu.parallel import sharded_average as jsa
from ecckd_tpu.partition.cost_kernel import CandidateCostLw as JLw
from ecckd_tpu.partition.cost_kernel import CandidateCostSw as JSw
from ecckd_tpu.tools.create_lut import create_lut as jcreate_lut
from ecckd_tpu.tools.find_g_points import find_g_points as jfind_g_points
from ecckd_tpu.tools.reorder_spectrum import reorder_spectrum as jreorder
from ecckd_tpu_torch.config import Config
from ecckd_tpu_torch.convert import (LW_BAND_ARRAYS, SW_BAND_ARRAYS,
                                     lw_band_state, sw_band_state)
from ecckd_tpu_torch.ops.streaming import (average_od_to_gpoints,
                                           streaming_average_od_to_gpoints)
from ecckd_tpu_torch.parallel import make_mesh, profile_slices
from ecckd_tpu_torch.parallel import sharded_average as tsa
from ecckd_tpu_torch.partition import CandidateCostLw, CandidateCostSw
from ecckd_tpu_torch.tools import common
from ecckd_tpu_torch.tools import create_lut as tcreate
from ecckd_tpu_torch.tools import find_g_points as tfind
from synth import synth_spectrum_file, synth_ssi_file
from test_sharded_average import PRESSURE_FL, build_problem
from test_sharded_sweep import lw_args, probe_batches, sw_args

CPU = torch.device("cpu")
SHARDS = [2, 4, 8]


def cpu_mesh(n, data_parallel=1):
    return make_mesh(devices=[CPU] * n, data_parallel=data_parallel)


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("n,dp", [(1, None), (2, None), (4, None),
                                  (8, None), (8, 1), (8, 4), (8, 2)])
def test_make_mesh_shapes(n, dp):
    j = jmake_mesh(n, data_parallel=dp)
    t = make_mesh(n, data_parallel=dp, devices=[CPU] * 8)
    assert t.shape == dict(j.shape)
    assert t.size == n and t.axis_names == tuple(j.axis_names)


def test_make_mesh_refuses():
    with pytest.raises(ValueError, match="not divisible"):
        cpu_mesh(6, data_parallel=4)
    with pytest.raises(ValueError, match="9 shards asked"):
        make_mesh(9, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            make_mesh()


def test_profile_slices_pad_with_zero_weight():
    """5 profiles over 8 shards: one each, the last three copies of the
    last profile with weight zero (ecckd_tpu/optimize/solver.py:97-138)."""
    sl = profile_slices(cpu_mesh(8), 5)
    assert [list(s[1]) for s in sl] == [[0], [1], [2], [3], [4], [4], [4],
                                        [4]]
    assert [float(s[2][0]) for s in sl] == [1, 1, 1, 1, 1, 0, 0, 0]
    sl = profile_slices(cpu_mesh(2), 5)
    assert [list(s[1]) for s in sl] == [[0, 1, 2], [3, 4, 4]]


def test_collectives_in_shard_order():
    """Pairwise in shard order: two processes of two shards each add as
    one process of four does."""
    mesh = cpu_mesh(4)
    x = [torch.tensor([1e16, 1.0, -3.0]), torch.tensor([1.0, 2.0, 5.0]),
         torch.tensor([-1e16, 4.0, -7.0]), torch.tensor([1.0, 0.5, 9.0])]
    want = (x[0] + x[1]) + (x[2] + x[3])
    assert torch.equal(mesh.sum(x), want)
    assert not torch.equal(mesh.sum(x), ((x[0] + x[1]) + x[2]) + x[3])
    assert torch.equal(cpu_mesh(3).sum(x[:3]), (x[0] + x[1]) + x[2])
    assert torch.equal(mesh.min(x), torch.tensor([-1e16, 0.5, -7.0]))
    assert torch.equal(mesh.max(x), torch.tensor([1e16, 4.0, 9.0]))


# --------------------------------------------------- sharded averaging

class _Reader:
    def __init__(self, od):
        self.od = od

    def iter_blocks(self, block_wav):
        for i0 in range(0, self.od.shape[1], block_wav):
            yield i0, self.od[:, i0:i0 + block_wav]


def _four_paths(mod, mesh, od, weight, g_point, ng, method, **kw):
    """The four entry points of ``mod`` (either package) in one process:
    dense, streamed, and the multihost forms given the whole axis."""
    w_fn = lambda i0, nb: weight[:, i0:i0 + nb]
    return [
        mod.sharded_average_od_to_gpoints(mesh, ng, g_point, od, weight,
                                          method, pressure_fl=PRESSURE_FL,
                                          **kw),
        mod.streaming_sharded_average_od_to_gpoints(
            mesh, _Reader(od), ng, g_point, w_fn, method, block_wav=300,
            pressure_fl=PRESSURE_FL, **kw),
        mod.sharded_average_od_to_gpoints_multihost(
            mesh, ng, g_point, od, weight, method, pressure_fl=PRESSURE_FL,
            **kw),
        mod.streaming_sharded_average_od_to_gpoints_multihost(
            mesh, ng, g_point, lambda i0, nb: od[:, i0:i0 + nb],
            od.shape[1], w_fn, method, block_wav=300,
            pressure_fl=PRESSURE_FL, **kw)]


def _normwise(got, want):
    got, want = np.ravel(np.asarray(got)), np.ravel(np.asarray(want))
    scale = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (scale if scale else 1.0))


@pytest.mark.parametrize("method", list(GPOINT_AVERAGING_METHODS))
def test_sharded_average_all_methods(method):
    """All four entry points over 2, 4 and 8 logical shards against the
    same four of JAX on its 8-device mesh: fits within 1e-10 normwise,
    min and max identical."""
    od, weight, g_point = build_problem(nwav=1000)
    ng = 5
    jax_runs = _four_paths(jsa, jmake_mesh(data_parallel=1), od, weight,
                           g_point, ng, method)
    want = jax_runs[0]
    for fit, mn, mx in jax_runs[1:]:     # JAX's own paths agree first
        assert _normwise(fit, want[0]) <= 1e-10
    for n in SHARDS:
        for fit, mn, mx in _four_paths(tsa, cpu_mesh(n), od, weight,
                                       g_point, ng, method):
            assert _normwise(fit, want[0]) <= 1e-10, (n, method)
            np.testing.assert_array_equal(mn, want[1])
            np.testing.assert_array_equal(mx, want[2])


@pytest.mark.parametrize("method", list(GPOINT_AVERAGING_METHODS))
@pytest.mark.parametrize("n", [1, 4])
def test_one_spectral_shard_is_one_device(n, method):
    """A mesh whose spectral axis is one shard (one shard, or four in four
    data rows) runs the one-device block loop on the same blocks: each of
    the four entry points gives the bits of the one-device average, the
    streamed ones those of the streamed average at the same block size,
    the dense ones those of the dense average in one block."""
    od, weight, g_point = build_problem(nwav=1000)
    ng = 5
    T = torch.from_numpy
    stream = streaming_average_od_to_gpoints(
        _Reader(od), ng, g_point, lambda i0, nb: weight[:, i0:i0 + nb],
        method, block_wav=300, pressure_fl=PRESSURE_FL, device="cpu")
    dense = average_od_to_gpoints(ng, T(g_point), T(od), T(weight), method,
                                  pressure_fl=PRESSURE_FL,
                                  block_wav=od.shape[1])
    runs = _four_paths(tsa, cpu_mesh(n, data_parallel=n), od, weight,
                       g_point, ng, method)
    for got, want in zip(runs, (dense, stream, dense, stream)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_sharded_average_empty_and_all_zero_gpoints():
    od, weight, g_point = build_problem(zeros=False)
    g_point[g_point == 3] = 0          # g-point 3 holds no wavenumber
    od[:, g_point == 2] = 0.0          # g-point 2 holds zeros only
    mesh, jmesh = cpu_mesh(8), jmake_mesh(data_parallel=1)
    for method in ("transmission", "logarithmic"):
        fit, mn, mx = tsa.sharded_average_od_to_gpoints(
            mesh, 5, g_point, od, weight, method)
        jfit, jmn, jmx = jsa.sharded_average_od_to_gpoints(
            jmesh, 5, g_point, od, weight, method)
        assert np.all(fit[:, 3] == 0) and np.all(mn[:, 3] == 0) \
            and np.all(mx[:, 3] == 0)
        assert np.all(fit[:, 2] == 0)
        assert _normwise(fit, jfit) <= 1e-10
        np.testing.assert_array_equal(mn, jmn)
        np.testing.assert_array_equal(mx, jmx)


def test_sharded_average_errors():
    od, weight, g_point = build_problem()
    mesh = cpu_mesh(4)
    for fn in (tsa.sharded_average_od_to_gpoints,
               tsa.sharded_average_od_to_gpoints_multihost):
        with pytest.raises(ValueError, match="does not support"):
            fn(mesh, 5, g_point, od, weight, "geometric")
        with pytest.raises(ValueError, match="pressure_fl"):
            fn(mesh, 5, g_point, od, weight,
               "hybrid-logarithmic-transmission-3")


# ------------------------------------------------- sharded candidate costs

def _assert_costs_close(got, want):
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def _cut(args, first, width):
    """The arguments with every array from ``first`` on cut to its first
    ``width`` wavenumbers."""
    if width is None:
        return args
    return tuple(a if i < first or np.ndim(a) == 0 else a[..., :width]
                 for i, a in enumerate(args))


def _lw_pair(method, nwav, jmesh, mesh, width=None):
    args, _ = lw_args(method, nwav)
    args = _cut(args, 4, width)
    state = lw_band_state(dict(zip(LW_BAND_ARRAYS, args[2:])), "cpu",
                          torch.float64)
    return (JLw(*args, use_pallas=False, mesh=jmesh),
            CandidateCostLw(method, 0.02, mesh=mesh, **state))


def _sw_pair(method, nwav, jmesh, mesh, albedo=0.15, width=None):
    args, extras, _ = sw_args(method, nwav, albedo=albedo)
    args = _cut(args, 5, width)
    if extras is not None and width is not None:
        extras = {k: v if np.ndim(v) == 0 else v[..., :width]
                  for k, v in extras.items()}
    names = ("layer_weight", None, "pressure_hl") + SW_BAND_ARRAYS[2:]
    arrays = {k: v for k, v in zip(names, args[2:]) if k is not None}
    state = sw_band_state(arrays, extras, "cpu", torch.float64)
    return (JSw(*args, extras=extras, use_pallas=False, mesh=jmesh),
            CandidateCostSw(method, args[1], cos_sza=args[3], mesh=mesh,
                            **state))


@pytest.mark.parametrize("kind,method", [
    ("lw", "linear"), ("lw", "transmission"), ("lw", "logarithmic"),
    ("sw", "linear"), ("sw", "transmission"), ("sw", "logarithmic"),
    ("sw", "total-transmission")])
def test_sharded_candidate_costs(kind, method):
    """2, 4 and 8 shards, 257 wavenumbers (the padding path), against
    JAX's mesh mode on 8 devices and the port's one-device kernel."""
    jmesh = jmake_mesh(data_parallel=1)
    pair = _lw_pair if kind == "lw" else _sw_pair
    jk, _ = pair(method, 257, jmesh, None)
    _, dense = pair(method, 257, None, None)
    for n in SHARDS:
        _, k = pair(method, 257, jmesh, cpu_mesh(n))
        assert len(k._shards) == n and k.use_prefix is False
        for i1, i2 in probe_batches(257):
            got = k.costs(i1, i2)
            _assert_costs_close(got, jk.costs(i1, i2))
            _assert_costs_close(got, dense.costs(i1, i2))


def test_sharded_costs_band_smaller_than_mesh():
    """Six wavenumbers over eight shards: two shards hold padding only."""
    jmesh = jmake_mesh(data_parallel=1)
    i1, i2 = np.array([0, 2, 5], np.int32), np.array([1, 4, 5], np.int32)
    for pair, method in ((_lw_pair, "transmission"),
                         (_sw_pair, "total-transmission")):
        jk, k = pair(method, 64, jmesh, cpu_mesh(8), width=6)
        assert k.npoints == jk.npoints == 6
        _assert_costs_close(k.costs(i1, i2), jk.costs(i1, i2))


def test_sharded_costs_data_spectral_mesh():
    """A (data 2, spectral 4) mesh shards the wavenumbers over 4 slices, as
    JAX's does, and gives its costs."""
    jk, _ = _lw_pair("transmission", 256, jmake_mesh(data_parallel=2), None)
    _, k = _lw_pair("transmission", 256, None, cpu_mesh(8, data_parallel=2))
    assert len(k._shards) == 4
    for i1, i2 in probe_batches(256):
        _assert_costs_close(k.costs(i1, i2), jk.costs(i1, i2))


# ------------------------------------------------------- the tools sharded

@contextlib.contextmanager
def _tool_mesh(monkeypatch, mesh):
    """The port's tools with ``sharded=1`` on ``mesh`` (the rule resolves
    cards; the tests hand it logical CPU shards)."""
    seen = []

    def rule(value, device, tool):
        seen.append((tool, value))
        return mesh if str(value) == "1" else None
    monkeypatch.setattr(tfind, "sharded_mesh", rule)
    monkeypatch.setattr(tcreate, "sharded_mesh", rule)
    yield seen
    monkeypatch.undo()


@pytest.fixture(scope="module")
def lw_rig(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel_lw")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o", nwav=1024,
                              seed=3)
    order = str(d / "order.h5")
    jreorder(JConfig({"input": h2o, "output": order,
                      "wavenumber1": "1 900", "wavenumber2": "900 2000"}),
             argv=["r"])
    return dict(d=d, h2o=h2o, order=order)


@pytest.fixture(scope="module")
def sw_rig(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel_sw")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), molecule="h2o", nwav=1024,
                              ncol=2, seed=11, is_sw=True)
    ssi, _ = synth_ssi_file(str(d / "ssi.h5"),
                            read_spectrum(h2o, 0).wavenumber)
    order = str(d / "order.h5")
    jreorder(JConfig({"input": h2o, "output": order, "ssi": ssi,
                      "threshold_optical_depth": "0.25",
                      "wavenumber1": "250 10000",
                      "wavenumber2": "10000 50000"}), argv=["r"])
    return dict(d=d, h2o=h2o, order=order, ssi=ssi)


def _ranks(path):
    with NcFile(path) as f:
        return {k: np.asarray(f.read(k)) for k in
                ("g_point", "h2o_rank1", "h2o_rank2", "h2o_n_g_points")}


def _lut(path):
    with NcFile(path) as f:
        return {k: np.asarray(f.read(k)) for k in
                ("h2o_molar_absorption_coeff",
                 "h2o_molar_absorption_coeff_min",
                 "h2o_molar_absorption_coeff_max")}


def _chain(rig, tag, sharded, extra, fgp_keys, monkeypatch=None, mesh=None):
    """find_g_points then create_lut (transmission, dense and streamed)
    through one package's tools; the port's with ``mesh`` for
    ``sharded=1``."""
    d = rig["d"]
    gp = str(d / f"gp_{tag}.h5")
    cfg = {"output": gp, "gases": "h2o", "sharded": sharded,
           "h2o.reordering_input": rig["order"], "h2o.input": rig["h2o"],
           **fgp_keys, **extra}
    luts = {}
    port = bool(extra)
    with (_tool_mesh(monkeypatch, mesh) if port
          else contextlib.nullcontext()):
        fgp, lut, cls = ((tfind.find_g_points, tcreate.create_lut, Config)
                         if port else (jfind_g_points, jcreate_lut, JConfig))
        with _flush_subnormals(port):
            fgp(cls(cfg), argv=["find_g_points"])
        for method, streaming in LUT_RUNS:
            out = str(d / f"lut_{tag}_{method}_{streaming}.nc")
            keys = {"input": gp, "output": out, "gases": "h2o",
                    "averaging_method": method, "sharded": sharded,
                    "h2o.conc_dependence": "linear", "h2o.input": rig["h2o"],
                    "streaming": streaming, "streaming_block_wav": "300",
                    **extra}
            if "ssi" in fgp_keys:
                keys["ssi"] = fgp_keys["ssi"]
            lut(cls(keys), argv=["create_lut"])
            luts[method, streaming] = _lut(out)
    return _ranks(gp), luts


# create_lut's runs: (averaging method, streaming)
LUT_RUNS = (("linear", "0"), ("linear", "1"), ("transmission", "0"),
            ("transmission", "1"))


@contextlib.contextmanager
def _flush_subnormals(on):
    """XLA's floating-point environment on the CPU for the port's SW
    searches (tests/test_torch_sw_pipeline.py says why)."""
    torch.set_flush_denormal(on)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


LW_KEYS = {"heating_rate_tolerance": "0.4",
           "averaging_method": "transmission"}


def _sw_keys(rig):
    return {"heating_rate_tolerance": "1.0", "ssi": rig["ssi"],
            "averaging_method": "total-transmission",
            "h2o.min_scaling": "0.5", "h2o.max_scaling": "2.0"}


@pytest.mark.parametrize("kind", ["lw", "sw"])
def test_tools_sharded(kind, lw_rig, sw_rig, monkeypatch):
    """The port's find_g_points and create_lut over 8 logical shards
    against the port unsharded and the JAX tools with sharded=1 on 8
    devices: identical ranks; linear LUTs within 1e-10 normwise, dense and
    streamed, and every LUT's min and max identical.  The transmission
    LUTs are held to 1e-2, as tests/test_torch_pipeline.py holds them:
    near the transmission clamp -log1p(-mean) turns the sums' last bits
    into the od's leading digits (ROADMAP §3)."""
    rig = lw_rig if kind == "lw" else sw_rig
    keys = LW_KEYS if kind == "lw" else _sw_keys(rig)
    cpu = {"device": "cpu"}
    jranks, jluts = _chain(rig, "jax", "1", {}, keys)
    ranks0, luts0 = _chain(rig, "port0", "0", cpu, keys, monkeypatch)
    ranks, luts = _chain(rig, "port8", "1", cpu, keys, monkeypatch,
                         cpu_mesh(8))
    for k in ranks:
        np.testing.assert_array_equal(ranks[k], jranks[k])
        np.testing.assert_array_equal(ranks[k], ranks0[k])
    for run in LUT_RUNS:
        bar = 1e-10 if run[0] == "linear" else 1e-2
        got = luts[run]
        for want in (jluts[run], luts0[run]):
            assert _normwise(got["h2o_molar_absorption_coeff"],
                             want["h2o_molar_absorption_coeff"]) <= bar
            for m in ("min", "max"):
                name = f"h2o_molar_absorption_coeff_{m}"
                np.testing.assert_array_equal(got[name], want[name])


def test_sharded_key_rule():
    """``sharded``: 0 never, auto never on the CPU, 1 on the CPU raises
    (the cores take a mesh of logical shards instead)."""
    assert common.sharded_mesh("0", CPU, "t") is None
    assert common.sharded_mesh("auto", CPU, "t") is None
    with pytest.raises(ValueError, match="mesh of logical shards"):
        common.sharded_mesh("1", CPU, "t")
    with pytest.raises(ValueError, match="not understood"):
        common.sharded_mesh("maybe", CPU, "t")


# ------------------------------------------------------ data-parallel solve

@pytest.fixture(scope="module")
def opt_rig(tmp_path_factory):
    """tests/test_parallel.py's rig: h2o, 512 wavenumbers, 6 profiles,
    training fluxes of profiles 0-4."""
    d = tmp_path_factory.mktemp("torch_parallel_opt")
    h2o = synth_spectrum_file(str(d / "h2o.h5"), nwav=512, ncol=6)
    order = str(d / "o.h5")
    jreorder(JConfig({"input": h2o, "output": order}), argv=["r"])
    gp = str(d / "g.h5")
    jfind_g_points(JConfig({
        "output": gp, "gases": "h2o", "heating_rate_tolerance": "0.4",
        "averaging_method": "transmission",
        "h2o.reordering_input": order, "h2o.input": h2o}), argv=["f"])
    lut = str(d / "l.nc")
    jcreate_lut(JConfig({
        "input": gp, "output": lut, "gases": "h2o",
        "averaging_method": "transmission",
        "h2o.conc_dependence": "linear", "h2o.input": h2o}), argv=["c"])
    from synth import synth_lbl_flux_file
    out = dict(lut=lut)
    for n in (4, 5):
        out[n] = str(d / f"t{n}.nc")
        synth_lbl_flux_file(out[n], [h2o], gp, ["h2o"],
                            iprofiles=tuple(range(n)))
    return out


def _port_model(opt_rig, nprof, prior=True):
    from ecckd_tpu_torch.io.lbl_fluxes import LblFluxes
    from ecckd_tpu_torch.models import CkdModel
    from ecckd_tpu_torch.tools.optimize_lut import prepare_lbl
    model = CkdModel.read(opt_rig["lut"], active_gas_list=["h2o"])
    if prior:
        model.create_error_covariances(prior_error=4.0)
    lbl = LblFluxes.read(opt_rig[nprof])
    prepare_lbl(lbl, model, 1e4)
    return model, lbl


def test_data_parallel_value_and_grad(opt_rig):
    """5 profiles over 8 shards (three padding copies of weight zero), and
    over 2: value and gradient within 1e-12 / 1e-10 of one shard, and
    bit-identical in a repeat."""
    from ecckd_tpu_torch.ops.cost import CostWeights
    from ecckd_tpu_torch.optimize.solver import (TrainingCost,
                                                 log_state_tree, ravel_tree)
    model, lbl = _port_model(opt_rig, 5)
    x = ravel_tree(log_state_tree(model))
    v1, g1 = TrainingCost(model, [lbl], CostWeights(), device="cpu")(x)
    for n in (8, 2):
        cost = TrainingCost(model, [lbl], CostWeights(), device="cpu",
                            mesh=cpu_mesh(n))
        assert len(cost.shards) == n
        v, g = cost(x)
        assert abs(v - v1) <= 1e-12 * abs(v1)
        assert _normwise(g, g1) <= 1e-10
        v2, g2 = cost(x)
        assert v2 == v and np.array_equal(g2, g)


@pytest.mark.parametrize("solver", ["scipy", "device"])
def test_data_parallel_solve(opt_rig, solver):
    """15 iterations with data_parallel over 4 logical shards against one
    shard (and, for scipy, JAX's data-parallel solve on 8 devices): the
    cost within 1e-8 and the LUT within 1e-6, as tests/test_parallel.py
    holds JAX's."""
    from ecckd_tpu_torch.optimize import solve
    results = {}
    for tag, dp, mesh in (("one", False, None),
                          ("four", True, cpu_mesh(4))):
        model, lbl = _port_model(opt_rig, 4)
        res = solve(model, [lbl], max_iterations=15, prior_error=4.0,
                    data_parallel=dp, mesh=mesh, solver=solver,
                    device="cpu")
        results[tag] = (res.cost, model.gas("h2o").molar_abs.copy())
    np.testing.assert_allclose(results["four"][0], results["one"][0],
                               rtol=1e-8)
    np.testing.assert_allclose(results["four"][1], results["one"][1],
                               rtol=1e-6)
    if solver == "scipy":
        from ecckd_tpu.io.lbl_fluxes import LblFluxes as JLbl
        from ecckd_tpu.models import CkdModel as JModel
        from ecckd_tpu.optimize import solve as jsolve
        from ecckd_tpu.tools.optimize_lut import _prepare_lbl
        jm = JModel.read(opt_rig["lut"], active_gas_list=["h2o"])
        jm.create_error_covariances(prior_error=4.0)
        jl = JLbl.read(opt_rig[4])
        _prepare_lbl(jl, jm, 1e4)
        jres = jsolve(jm, [jl], max_iterations=15, prior_error=4.0,
                      data_parallel=True)
        assert len(jax.devices()) == 8
        np.testing.assert_allclose(results["four"][0], jres.cost, rtol=1e-8)
        np.testing.assert_allclose(results["four"][1],
                                   jm.gas("h2o").molar_abs, rtol=1e-6)


def test_data_parallel_padding_against_jax(opt_rig):
    """5 profiles over 8 shards in both packages: the padded copies carry
    zero weight, and the value and gradient agree (1e-12 / 1e-10)."""
    import jax.numpy as jnp
    from ecckd_tpu.io.lbl_fluxes import LblFluxes as JLbl
    from ecckd_tpu.models import CkdModel as JModel
    from ecckd_tpu.ops.cost import CostWeights as JW
    from ecckd_tpu.optimize import build_scene, log_state_tree, make_cost_fn
    from ecckd_tpu.optimize.solver import _shard_scene_profiles
    from ecckd_tpu.tools.optimize_lut import _prepare_lbl
    from ecckd_tpu_torch.ops.cost import CostWeights
    from ecckd_tpu_torch.optimize.solver import TrainingCost, ravel_tree
    from ecckd_tpu_torch.optimize.solver import log_state_tree as tlog
    jm = JModel.read(opt_rig["lut"], active_gas_list=["h2o"])
    jl = JLbl.read(opt_rig[5])
    _prepare_lbl(jl, jm, 1e4)
    scene, meta = _shard_scene_profiles(*build_scene(jm, jl))
    tree = {k: jnp.asarray(v) for k, v in log_state_tree(jm).items()}
    jv, jg = jax.value_and_grad(make_cost_fn(jm, [(scene, meta)], JW()))(
        tree)
    model, lbl = _port_model(opt_rig, 5, prior=False)
    cost = TrainingCost(model, [lbl], CostWeights(), device="cpu",
                        mesh=cpu_mesh(8))
    assert [float(w) for s in profile_slices(cost.mesh, 5)
            for w in s[2]] == [1, 1, 1, 1, 1, 0, 0, 0]
    v, g = cost(ravel_tree(tlog(model)))
    assert abs(v - float(jv)) <= 1e-12 * abs(float(jv))
    assert _normwise(g, ravel_tree({k: np.asarray(a)
                                    for k, a in jg.items()})) <= 1e-10
