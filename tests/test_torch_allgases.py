"""The LW search over ecCKD's full climate gas set: the configuration
``ckd_bench/configs/lw-fsck32-allgases.json`` (h2o, o3, the well-mixed
composite, ch4, n2o, cfc11 and cfc12) cut to a size the CPU runs in
seconds, the plain reference of the overlap of the gases
(``ckd_bench/reference/overlap.py``), and the overlap's spans and
counter.

Held: the port's seven-gas search passes every limit of the
``search_merged`` job, with ch4's three g-points at least; its float32
path, an overlap that advances the wrong gas and per-gas maps of
half-open intervals fail one; the reference
gives the port's per-gas maps, merged g-points, ranges and merged map on
seeded random g-points of 2, 3 and 7 gases over 2 and 5 bands;
``map_counts()`` counts one pass a gas's store and one a gas of the
merged map; the spans of the hypercube and the maps nest in the
overlap and store spans under a profile, and only then; the benchmark's
two readers of them give numbers, and None where the counter or span is
absent.
"""

import importlib.util
import json
import math
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ecckd_tpu_torch import logs
from ecckd_tpu_torch.partition import gas_data
from ecckd_tpu_torch.partition.gas_data import (SingleGasData,
                                                merged_g_point_map,
                                                overlap_g_points)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
_spec = importlib.util.spec_from_file_location(
    "ckd_bench_tests_conftest", ROOT / "ckd_bench" / "tests" / "conftest.py")
bench_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_conftest)

from ckd_bench.reference import overlap  # noqa: E402

CELL = "lw-fsck32-allgases.search"
GASES = ("h2o", "o3", "composite", "ch4", "n2o", "cfc11", "cfc12")
# Seven gases at 32768 wavenumbers x 20 layers, at a tolerance that gives
# 9 g-points in all on each of the seeds (8 to 10 at 0.3 and 0.5)
TINY = {"nwav": 32768, "nlay": 20, "tolerance": 0.4, "g_points": 9}
SEEDS = (5, 2 ** 31 + 12345)
TRACED_SEED = 77
MAIN = threading.main_thread().native_id
MAP_SPANS = ("ecckd.find_g_points.overlap.hypercube",
             "ecckd.find_g_points.overlap.map",
             "ecckd.find_g_points.store.map")


@pytest.fixture
def quiet():
    """The port's log quiet and one torch thread, as the test runner's
    workers share the cores."""
    threads = torch.get_num_threads()
    logs.set_log_level("error")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    logs.set_log_level("info")


def _config():
    return bench_conftest.tiny("lw-fsck32-allgases", **TINY)


_runs = {}


def search(dtype, seed):
    """One search of the cut configuration, its checks and the map
    counts it made, once a (dtype, seed)."""
    from ckd_bench.harness import load_job
    key = (dtype, seed)
    if key not in _runs:
        job = load_job({"job": "search_merged"})(_config(), {}, seed, "cpu",
                                                 dtype=dtype)
        gas_data.reset_map_counts()
        answer = job.run()
        counts = gas_data.map_counts()
        _runs[key] = SimpleNamespace(job=job, answer=answer, counts=counts,
                                     checks=job.check([answer]))
    return _runs[key]


def test_configuration_is_the_full_gas_model():
    from ecckd_tpu_torch.pipeline.presets import gas_preset_options
    cfg = bench_conftest.tiny("lw-fsck32-allgases", nwav=5_600_000,
                              nlay=50)
    fsck = bench_conftest.tiny("lw-fsck32", nwav=5_600_000, nlay=50)
    narrow = bench_conftest.tiny("lw-narrow64", nwav=5_600_000, nlay=50)
    assert [g["name"] for g in cfg["gases"]] == list(GASES)
    # h2o and o3 line for line as lw-fsck32's, the composite as
    # lw-narrow64's co2
    assert cfg["gases"][:2] == fsck["gases"]
    assert cfg["gases"][2] == dict(narrow["gases"][2], name="composite")
    for key in ("bands_wavenumber", "g_points", "documented_tolerance",
                "averaging_method", "reorder_threshold",
                "partition_tolerance", "flux_weight", "min_pressure_pa",
                "precision", "nwav", "nlay"):
        assert cfg[key] == fsck[key], key
    preset = gas_preset_options("lw", "fsck", cfg["documented_tolerance"])
    for gas in cfg["gases"]:
        for key, value in preset.get(gas["name"], {}).items():
            assert gas[key] == [int(value)], (gas["name"], key)
    assert cfg["reduced"] == {}
    assert set(cfg["limits"]) == {"search_merged"}


@pytest.mark.parametrize("seed", SEEDS)
def test_search_passes_every_limit(quiet, seed):
    run = search(torch.float64, seed)
    for key, (value, limit) in run.checks.items():
        assert value <= limit, (key, value, limit)
    gp = run.answer[1]
    assert [g.molecule for g in gp.gases] == list(GASES)
    assert len(gp.gases[GASES.index("ch4")].rank1) >= 3
    assert run.checks["gas_map_faults"][0] == 0
    assert run.checks["merged_map_faults"][0] == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_map_counts_of_a_search(quiet, seed):
    """One pass a gas's store (its gather), one a gas of the merged map
    (its map read into the tuple ids)."""
    run = search(torch.float64, seed)
    assert run.counts == {"store": len(GASES), "merged": len(GASES)}
    gas_data.reset_map_counts()
    assert gas_data.map_counts() == {"store": 0, "merged": 0}


def test_float32_control_fails(quiet):
    run = search(torch.float32, SEEDS[0])
    assert any(value > limit for value, limit in run.checks.values()), \
        run.checks


def _wrong_gas(gases):
    """The port's hypercube advancing the gas whose next g-point has the
    largest median sorting variable."""
    for g in gases:
        g.sorting_variable = -g.sorting_variable
    try:
        return overlap_g_points(gases)
    finally:
        for g in gases:
            g.sorting_variable = -g.sorting_variable


def test_planted_overlap_fault_fails(quiet):
    from ckd_bench.reference.overlap import check_overlap
    run = search(torch.float64, SEEDS[0])
    orders, gp = run.answer
    bands = _wrong_gas(gp.gases)
    faulty = SimpleNamespace(
        gases=gp.gases, band_number=bands,
        g_point=merged_g_point_map(gp.gases, len(bands), len(gp.g_point)))
    gas_faults, merged_faults, _ = check_overlap(
        run.job.cfg, run.job.spec, run.job.gases, orders, faulty, "cpu")
    assert gas_faults == 0
    assert merged_faults > run.job.cfg["limits"]["search_merged"][
        "merged_map_faults"]
    # The answer itself is left as it was
    overlap_g_points(gp.gases)


def test_planted_gas_map_fault_fails(quiet):
    """Each gas's map with its intervals taken half-open: the last rank of
    an interval that the next one does not share has no g-point."""
    from ckd_bench.reference.overlap import check_overlap
    run = search(torch.float64, SEEDS[1])
    orders, gp = run.answer
    gases = []
    for g, order in zip(gp.gases, orders):
        rank = np.asarray(order["rank"])
        bad = SimpleNamespace(**vars(g))
        bad.g_point = np.full(len(rank), -1, np.int32)
        for ig in range(g.ng()):
            bad.g_point[(rank >= g.rank1[ig]) & (rank < g.rank2[ig])] = ig
        gases.append(bad)
    gas_faults, _, _ = check_overlap(
        run.job.cfg, run.job.spec, run.job.gases, orders,
        SimpleNamespace(gases=gases, band_number=gp.band_number,
                        g_point=gp.g_point), "cpu")
    assert gas_faults > run.job.cfg["limits"]["search_merged"][
        "gas_map_faults"]


def _random_gases(ngas, nband, seed, nwav=600):
    """Per-gas g-points of ``ngas`` gases over ``nband`` bands of a
    shuffled spectrum: 1 to 4 rank intervals a band that tile it (with a
    shared rank now and then), medians drawn with ties across gases, and
    each gas's per-wavenumber map."""
    rng = np.random.default_rng(seed)
    edges = np.r_[0, np.sort(rng.choice(np.arange(40, nwav - 40, 40),
                                        nband - 1, replace=False)), nwav]
    out = []
    for k in range(ngas):
        rank = rng.permutation(nwav)
        n_g, band, r1, r2 = [], [], [], []
        for j in range(nband):
            n = int(rng.integers(1, 5))
            cuts = np.sort(rng.choice(np.arange(edges[j] + 1, edges[j + 1]),
                                      n - 1, replace=False))
            lo = np.r_[edges[j], cuts]
            hi = np.r_[cuts - rng.integers(0, 2, n - 1), edges[j + 1] - 1]
            n_g.append(n)
            band += [j] * n
            r1 += list(lo)
            r2 += list(hi)
        g = SingleGasData(
            molecule=f"gas{k}", n_g_points=np.array(n_g, np.int64),
            band_number=np.array(band, np.int32),
            rank1=np.array(r1, np.int64), rank2=np.array(r2, np.int64),
            error=np.ones(len(r1)),
            sorting_variable=np.round(rng.uniform(0, 3, len(r1)), 1))
        g.store_g_points(rank)
        out.append((g, rank))
    return out


@pytest.mark.parametrize("nband", [2, 5])
@pytest.mark.parametrize("ngas", [2, 3, 7])
def test_reference_overlap_equals_the_port(ngas, nband):
    gases = _random_gases(ngas, nband, seed=100 * ngas + nband)
    data = [g for g, _ in gases]
    maps = []
    for g, rank in gases:
        gmap = overlap.gas_g_point(torch.as_tensor(rank), g.rank1, g.rank2)
        np.testing.assert_array_equal(gmap.numpy(), g.g_point)
        maps.append(gmap)
    bands = overlap_g_points(data)
    ref_bands, ranges = overlap.hypercube(
        [g.n_g_points for g in data], [g.sorting_variable for g in data])
    np.testing.assert_array_equal(ref_bands, bands)
    for k, g in enumerate(data):
        assert [r[k] for r in ranges] == list(zip(g.g_min, g.g_max))
    np.testing.assert_array_equal(
        overlap.merged_map(maps, ranges).numpy(),
        merged_g_point_map(data, len(bands), len(maps[0])))


def test_reference_median_is_the_port_median():
    from ecckd_tpu_torch.tools.find_g_points import (
        calc_median_sorting_variable)
    rng = np.random.default_rng(3)
    nwav = 500
    rank = rng.permutation(nwav)
    sv, weight = rng.normal(size=nwav), rng.uniform(0, 2, nwav)
    weight[rng.integers(0, nwav, 50)] = 0.0
    r1, r2 = np.array([0, 7, 8, 300]), np.array([6, 7, 299, 499])
    order = np.empty(nwav, np.int64)
    order[rank] = np.arange(nwav)
    want = [calc_median_sorting_variable(sv[order], weight[order], a, b)
            for a, b in zip(r1, r2)]
    got = overlap.median_sorting_variable(
        torch.as_tensor(sv), torch.as_tensor(weight), torch.as_tensor(rank),
        r1, r2)
    np.testing.assert_array_equal(got, want)


def test_no_map_span_without_a_profile(quiet):
    gases = [g for g, _ in _random_gases(3, 2, seed=1)]
    logs.clear_spans()
    bands = overlap_g_points(gases)
    merged_g_point_map(gases, len(bands), len(gases[0].g_point))
    assert logs.spans() == []


@pytest.fixture(scope="module")
def traced():
    """The cell traced through the harness at the cut size: its result
    line, spans and context."""
    from ckd_bench import harness
    from ckd_bench.run import load_cell, metrics_of
    real_load = harness.load_metric
    contexts = []

    def load_metric(name):
        mod = real_load(name)

        def read(ctx):
            contexts.append(ctx)
            return mod.read(ctx)
        return SimpleNamespace(read=read)

    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "load_metric", load_metric)
        torch.set_num_threads(1)
        try:
            cell, _, traffic, bench = load_cell(ROOT, CELL)
            logs.clear_spans()
            gas_data.reset_map_counts()
            result = harness.run_cell(
                cell, _config(), traffic, metrics_of(bench, cell, True),
                TRACED_SEED, 0.0, True, "cpu", time.perf_counter())
            return SimpleNamespace(result=result, spans=logs.spans(),
                                   ctx=contexts[-1])
        finally:
            logs.clear_spans()
            logs.set_log_level("info")
            torch.set_num_threads(threads)


def test_map_spans_nest_in_their_steps(traced):
    """One hypercube and one merged map a search inside its overlap span,
    one store map a gas inside its store span, all on the main thread;
    so gpoint_idle_ms's union is the same with them and without."""
    from ckd_bench import spans as bench_spans
    from ckd_bench.harness import load_metric
    steps = load_metric("gpoint_idle_ms").STEPS
    spans = traced.spans
    by_id = {s.id: s for s in spans}
    parents = {MAP_SPANS[0]: ("ecckd.find_g_points.overlap", 1),
               MAP_SPANS[1]: ("ecckd.find_g_points.overlap", 1),
               MAP_SPANS[2]: ("ecckd.find_g_points.store", len(GASES))}
    for name, (parent, count) in parents.items():
        found = [s for s in spans if s.name == name]
        assert len(found) == count, name
        for s in found:
            up = by_id[s.parent]
            assert up.name == parent and s.thread == up.thread == MAIN
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    assert bench_spans.intervals(traced.ctx, steps) == \
        bench_spans.intervals(traced.ctx, steps | set(MAP_SPANS))
    assert traced.result["correct"] is True, traced.result["checks"]


def test_map_readers_give_numbers(traced):
    metrics = traced.result["metrics"]
    idle = metrics["map_idle_ms"]["value"]
    assert math.isfinite(idle) and idle > 0.0
    # Set-up's search and the window's one: a store and a merged pass a
    # gas, whatever the g-points
    assert traced.result["checks"]["g_point_count_gap"]["value"] == 0
    passes = metrics["map_passes_per_search"]["value"]
    assert passes == 2 * len(GASES)


def test_map_readers_give_none_without_counter_or_span(monkeypatch):
    from ckd_bench.harness import load_metric
    from ckd_bench.trace import merged
    monkeypatch.delattr(gas_data, "map_counts")
    assert load_metric("map_passes_per_search").read(
        SimpleNamespace(durations=[1.0])) is None
    ctx = SimpleNamespace(
        trace=SimpleNamespace(window=(0.0, 100.0)),
        busy=merged([(10.0, 20.0)], 0.0, 100.0), busy_s=1e-5,
        durations=[1.0],
        _ecckd_spans=[("ecckd.find_g_points.overlap", 5.0, 30.0, None)])
    assert load_metric("map_idle_ms").read(ctx) is None
    ctx._ecckd_spans.append(("ecckd.find_g_points.store.map", 0.0, 40.0,
                             None))
    assert load_metric("map_idle_ms").read(ctx) == pytest.approx(0.03)


def test_benchmark_lists_the_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "lw-fsck32-allgases", "search-merged", 1)
    searches = [w["name"] for w in bench["workloads"]
                if w["name"].endswith(".search")]
    for m in bench["per_layer"]:
        if m["name"] in ("map_idle_ms", "map_passes_per_search"):
            assert sorted(m["workloads"]) == sorted(searches)
