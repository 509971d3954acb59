"""The LW search over many bands: ecCKD's 13-band narrow model
(``ckd_bench/configs/lw-narrow64.json``) cut to a size the CPU runs in
seconds, and band_parallel's counters and barrier spans.

Held: with every band's search on its own thread ("parallel") and with a
kernel a band ("off"), the port's answers pass every limit of the plain
reference (``ckd_bench/reference/search.check_gas``) and give each band
the same number of g-points; the port's float32 path fails one limit;
the merged dispatches, the band batches they carry and their intervals are
counted, one dispatch a K3 call; each band thread's waits at the barrier
are recorded as ``ecckd.partition.barrier`` spans under a profile, and
only then; the benchmark maps them and reads its two metrics of the
barrier from them, and gives None where the counter or span is absent.
"""

import importlib.util
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
from ecckd_tpu_torch.partition import band_parallel

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
_spec = importlib.util.spec_from_file_location(
    "ckd_bench_tests_conftest", ROOT / "ckd_bench" / "tests" / "conftest.py")
bench_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_conftest)

NBAND = 13
GASES = ("h2o", "o3", "co2")
# All 13 bands and three gases at 32768 wavenumbers x 12 layers, at a
# tolerance that gives 18 g-points on each of the seeds
NARROW = {"nwav": 32768, "nlay": 12, "tolerance": 0.16, "g_points": 18}
SEEDS = (5, 77, 2 ** 31 + 12345)
MODES = ("parallel", "off")
CELL = "lw-narrow64.search"
MAIN = threading.main_thread().native_id


@pytest.fixture
def quiet():
    """The port's log quiet and one torch thread, as the test runner's
    workers share the cores."""
    threads = torch.get_num_threads()
    logs.set_log_level("warning")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    logs.set_log_level("info")


def _config():
    return bench_conftest.tiny("lw-narrow64", **NARROW)


@pytest.fixture
def band_mode(monkeypatch):
    """Sets find_g_points' band mode, which "auto" makes "off" on the
    CPU."""
    from ecckd_tpu_torch.tools import find_g_points as fgp
    real = fgp._band_mode

    def use(mode):
        monkeypatch.setattr(fgp, "_band_mode", lambda m, device, nband, dbg:
                            real(mode, device, nband, dbg))
    return use


_runs = {}


def search(band_mode, mode, dtype, seed):
    """One search of the cut configuration and its checks, once a
    (mode, dtype, seed)."""
    from ckd_bench.harness import load_job
    key = (mode, dtype, seed)
    if key not in _runs:
        band_mode(mode)
        job = load_job({"job": "search"})(_config(), {}, seed, "cpu",
                                          dtype=dtype)
        answer = job.run()
        _runs[key] = (answer, job.check([answer]))
    return _runs[key]


def test_configuration_is_the_narrow_model():
    from ecckd_tpu_torch.pipeline.presets import LW_BAND_STRUCTURES
    cfg = bench_conftest.tiny("lw-narrow64", nwav=5_600_000, nlay=50)
    band1, band2 = LW_BAND_STRUCTURES["narrow"]
    assert cfg["bands_wavenumber"] == [[float(a), float(b)]
                                       for a, b in zip(band1, band2)]
    assert [g["name"] for g in cfg["gases"]] == list(GASES)
    assert not any("base_split" in g for g in cfg["gases"])
    assert (cfg["g_points"], cfg["documented_tolerance"]) == (64, 0.013)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode", MODES)
def test_search_passes_every_limit(quiet, band_mode, mode, seed):
    (_, gp), checks = search(band_mode, mode, torch.float64, seed)
    for key, (value, limit) in checks.items():
        assert value <= limit, (key, value, limit)
    assert [len(g.n_g_points) for g in gp.gases] == [NBAND] * len(GASES)
    assert np.all(np.concatenate([g.n_g_points for g in gp.gases]) >= 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_control_fails(quiet, band_mode, seed):
    _, checks = search(band_mode, "off", torch.float32, seed)
    assert any(value > limit for value, limit in checks.values()), checks


@pytest.mark.parametrize("seed", SEEDS)
def test_parallel_and_off_agree_band_by_band(quiet, band_mode, seed):
    (_, par), _ = search(band_mode, "parallel", torch.float64, seed)
    (_, off), _ = search(band_mode, "off", torch.float64, seed)
    for a, b in zip(par.gases, off.gases):
        assert a.molecule == b.molecule
        np.testing.assert_array_equal(a.n_g_points, b.n_g_points)
    np.testing.assert_array_equal(par.band_number, off.band_number)


def test_dispatch_counts(quiet, band_mode, monkeypatch):
    """Band batches over dispatches is what bands_per_dispatch reads, and
    every merged dispatch is one K3 call; "off" merges none."""
    from ckd_bench.harness import load_job, load_metric
    from ecckd_tpu_torch.partition import cost_kernel
    real, calls = cost_kernel.fused_interval_sum, []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(cost_kernel, "fused_interval_sum", counted)
    reader = load_metric("bands_per_dispatch")
    job = load_job({"job": "search"})(_config(), {}, SEEDS[0], "cpu")
    counts = {}
    for mode in ("off", "parallel"):
        band_mode(mode)
        band_parallel.reset_dispatch_counts()
        calls.clear()
        job.run()
        counts[mode] = band_parallel.dispatch_counts()
        value = reader.read(None)
        if mode == "off":
            assert counts[mode] == {"dispatches": 0, "batches": 0,
                                    "intervals": 0}
            assert value is None
    c = counts["parallel"]
    assert c["dispatches"] == len(calls) > 0
    assert c["dispatches"] <= c["batches"] <= NBAND * c["dispatches"]
    assert c["intervals"] >= c["batches"]
    assert value == c["batches"] / c["dispatches"]
    assert 1.0 < value <= NBAND
    band_parallel.reset_dispatch_counts()
    assert set(band_parallel.dispatch_counts().values()) == {0}


def test_no_barrier_span_without_a_profile(quiet, band_mode):
    from ckd_bench.harness import load_job
    band_mode("parallel")
    logs.clear_spans()
    load_job({"job": "search"})(_config(), {}, SEEDS[1], "cpu").run()
    assert logs.spans() == []


@pytest.fixture(scope="module")
def traced():
    """The cell traced through the harness at the cut size, every band's
    search on its own thread: its result line, spans and context."""
    from ckd_bench import harness
    from ckd_bench.run import load_cell, metrics_of
    from ecckd_tpu_torch.tools import find_g_points as fgp
    real_mode, real_load = fgp._band_mode, harness.load_metric
    contexts = []

    def load_metric(name):
        mod = real_load(name)

        def read(ctx):
            contexts.append(ctx)
            return mod.read(ctx)
        return SimpleNamespace(read=read)

    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fgp, "_band_mode", lambda mode, device, nband, debug:
                   real_mode("parallel", device, nband, debug))
        mp.setattr(harness, "load_metric", load_metric)
        torch.set_num_threads(1)
        try:
            cell, _, traffic, bench = load_cell(ROOT, CELL)
            logs.clear_spans()
            band_parallel.reset_dispatch_counts()
            result = harness.run_cell(
                cell, _config(), traffic, metrics_of(bench, cell, True),
                SEEDS[2], 0.0, True, "cpu", time.perf_counter())
            return SimpleNamespace(result=result, spans=logs.spans(),
                                   ctx=contexts[-1])
        finally:
            logs.clear_spans()
            logs.set_log_level("info")
            torch.set_num_threads(threads)


def test_barrier_spans_on_the_band_threads(traced):
    """One barrier span a band probe, on the probe's band thread and
    inside it, the dispatch that ends it fired before the probe returned;
    the thread that completes a barrier fires it at once."""
    spans = traced.spans
    by_id = {s.id: s for s in spans}
    barriers = [s for s in spans if s.name == "ecckd.partition.barrier"]
    probes = [s for s in spans if s.name == "ecckd.partition.band_probe"]
    assert len(barriers) == len(probes) > 0
    core = next(s for s in spans if s.name == "ecckd.find_g_points.core")
    for s in barriers:
        parent = by_id[s.parent]
        assert parent.name == "ecckd.partition.band_probe"
        assert s.thread == parent.thread != MAIN
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        assert s.call == core.id
    assert len({s.thread for s in barriers}) >= NBAND
    assert traced.result["correct"] is True, traced.result["checks"]


def test_benchmark_maps_the_barrier_spans(traced):
    from ckd_bench import spans as bench_spans
    mapped = [m for m in bench_spans.mapped(traced.ctx)
              if m[0] == "ecckd.partition.barrier"]
    assert mapped and all(a < b for _, a, b, _ in mapped)
    lo, hi = traced.ctx.trace.window
    assert all(lo <= a and b <= hi for _, a, b, _ in mapped)


@pytest.mark.parametrize("metric", ["bands_per_dispatch", "barrier_idle_ms",
                                    "probe_idle_ms", "gpoint_idle_ms",
                                    "reorder_idle_ms"])
def test_reader_gives_a_finite_number(traced, metric):
    value = traced.result["metrics"][metric]["value"]
    assert math.isfinite(value) and value > 0.0, value


def test_readers_give_none_without_counter_or_span(monkeypatch):
    from ckd_bench.harness import load_metric
    from ckd_bench.trace import merged
    # A port without the counter
    monkeypatch.delattr(band_parallel, "dispatch_counts")
    assert load_metric("bands_per_dispatch").read(None) is None
    # A trace whose spans hold no barrier
    ctx = SimpleNamespace(
        trace=SimpleNamespace(window=(0.0, 100.0)),
        busy=merged([(10.0, 20.0)], 0.0, 100.0), busy_s=1e-5,
        durations=[1.0],
        _ecckd_spans=[("ecckd.partition.probe", 5.0, 30.0, None)])
    assert load_metric("barrier_idle_ms").read(ctx) is None
    ctx._ecckd_spans.append(("ecckd.partition.barrier", 0.0, 40.0, None))
    assert load_metric("barrier_idle_ms").read(ctx) == pytest.approx(0.03)


def test_record_takes_the_open_span_as_parent():
    logs.clear_spans()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        assert logs.tracing()
        with logs.span("ecckd.test.outer"):
            t0 = time.perf_counter_ns()
            logs.record("ecckd.test.recorded", t0, t0 + 10)
    assert not logs.tracing()
    spans = {s.name: s for s in logs.spans()}
    logs.clear_spans()
    outer, rec = spans["ecckd.test.outer"], spans["ecckd.test.recorded"]
    assert rec.parent == outer.id and rec.call == outer.id
    assert (rec.start_ns, rec.end_ns - rec.start_ns) == (t0, 10)
    assert rec.thread == MAIN
