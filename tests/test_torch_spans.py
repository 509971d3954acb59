"""The port's trace spans (``ecckd_tpu_torch.logs.span``) and the
benchmark's readers of them (``ckd_bench/spans.py``), on the CPU.

The three cells of the benchmark are traced once each at a tiny size
(``ckd_bench/tests/conftest.tiny``): the SW search with every band's
search on its own thread, the table streamed block by block through the
prefetch thread.  Held: nothing is recorded without a profile; the spans
of the band threads and the prefetch thread take the span that started
the thread as their parent and share one core call's id; every span of
each cell is there; the benchmark's offset puts the main thread's spans
on the profiler's events; each of the five metrics that read them comes
out finite; the profile a tool writes holds the spans of every thread.
"""

import importlib.util
import json
import math
import statistics
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ecckd_tpu_torch import logs

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
_spec = importlib.util.spec_from_file_location(
    "ckd_bench_tests_conftest", ROOT / "ckd_bench" / "tests" / "conftest.py")
bench_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_conftest)

SEED = 2 ** 31 + 11
CELLS = {"lw-fsck32.search": bench_conftest.LW_SEARCH,
         "sw-rgb32.search": bench_conftest.SW_SEARCH,
         "lw-fsck32.lut": {}}
SPANS = {
    "lw-fsck32.search": [
        "ecckd.reorder.core", "ecckd.reorder.sorting_variable",
        "ecckd.reorder.sort", "ecckd.find_g_points.core",
        "ecckd.find_g_points.prepare", "ecckd.find_g_points.truth",
        "ecckd.find_g_points.search", "ecckd.find_g_points.split",
        "ecckd.find_g_points.store", "ecckd.find_g_points.overlap",
        "ecckd.partition.probe"],
    "lw-fsck32.lut": [
        "ecckd.create_lut.core", "ecckd.create_lut.profile",
        "ecckd.io.read_block", "ecckd.create_lut.wait_block",
        "ecckd.create_lut.copy", "ecckd.create_lut.partials",
        "ecckd.create_lut.finish"],
}
SPANS["sw-rgb32.search"] = SPANS["lw-fsck32.search"] + [
    "ecckd.partition.band_probe"]
METRICS = {"probe_idle_ms": "search", "gpoint_idle_ms": "search",
           "reorder_idle_ms": "search", "block_wait_ms": "lut",
           "lut_idle_ms": "lut"}
MAIN = threading.main_thread().native_id


@pytest.fixture(scope="module")
def traced():
    """Each cell's traced run: its result line, its spans and the traced
    window's context, which the metrics read."""
    from ckd_bench import harness
    from ckd_bench.run import load_cell, metrics_of
    from ecckd_tpu_torch.tools import create_lut
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
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fgp, "_band_mode", lambda mode, device, nband, debug:
                   real_mode("parallel", device, nband, debug))
        mp.setattr(create_lut._Execution, "use_streaming",
                   lambda self, nlay, nwav: True)
        mp.setattr(harness, "load_metric", load_metric)
        torch.set_num_threads(1)
        try:
            for name, override in CELLS.items():
                cell, cfg, traffic, bench = load_cell(ROOT, name)
                logs.clear_spans()
                result = harness.run_cell(
                    cell, bench_conftest.tiny(cell["config"], **override),
                    traffic, metrics_of(bench, cell, True), SEED, 0.0, True,
                    "cpu", time.perf_counter())
                out[name] = SimpleNamespace(result=result,
                                            spans=logs.spans(),
                                            ctx=contexts[-1])
        finally:
            logs.clear_spans()
            logs.set_log_level("info")
            torch.set_num_threads(threads)
    return out


def test_nothing_recorded_without_a_profile():
    from ecckd_tpu_torch.tools.reorder_spectrum import reorder_core
    logs.clear_spans()
    assert logs.span("ecckd.a") is logs.span("ecckd.b")
    rng = np.random.default_rng(0)
    nlay, nwav = 4, 64
    reorder_core(np.linspace(10.0, 1e5, nlay + 1), np.linspace(1, 64, nwav),
                 np.ones(nwav), rng.random((nlay, nwav)), device="cpu")
    target = lambda: None
    assert logs.spawned(target) is target
    assert logs.spans() == []


def _one(spans, name):
    found = [s for s in spans if s.name == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


def test_band_threads_take_the_core_call_as_parent(traced):
    """The SW search: each band's search on its own thread, its parent the
    find_g_points core (open on the thread that started the band threads),
    its probes below it, every span one core call."""
    spans = traced["sw-rgb32.search"].spans
    core = _one(spans, "ecckd.find_g_points.core")
    assert core.thread == MAIN and core.parent == 0 and core.call == core.id
    searches = [s for s in spans if s.name == "ecckd.find_g_points.search"]
    assert len(searches) == 10       # five bands of each of two gases
    assert len({s.thread for s in searches} - {MAIN}) >= 5
    assert all(s.thread != MAIN and s.parent == core.id for s in searches)
    by_id = {s.id: s for s in spans}
    band_probes = [s for s in spans
                   if s.name == "ecckd.partition.band_probe"]
    assert band_probes and all(
        by_id[s.parent].name == "ecckd.find_g_points.search"
        and by_id[s.parent].thread == s.thread for s in band_probes)
    # A merged dispatch runs on the band thread that completes the barrier:
    # inside its band probe, or after its search where its end lowers the
    # bar for the rest
    probes = [s for s in spans if s.name == "ecckd.partition.probe"]
    assert probes and all(
        s.thread != MAIN and (
            by_id[s.parent].name == "ecckd.partition.band_probe"
            or s.parent == core.id) for s in probes)
    # reorder's calls, before the core, hold their steps and the block
    # loop's spans of the sorting variable
    reorders = {s.id for s in spans if s.name == "ecckd.reorder.core"}
    call = [s for s in spans if s.call == core.id]
    assert len(call) == sum(1 for s in spans if s.call not in reorders)
    for s in spans:
        if s.name.startswith("ecckd.reorder.") and s.name != \
                "ecckd.reorder.core":
            assert by_id[s.parent].name == "ecckd.reorder.core"
            assert s.call == s.parent
        elif s.call in reorders and s.id not in reorders:
            assert s.name.startswith("ecckd.create_lut.")
            assert by_id[s.parent].name == "ecckd.reorder.sorting_variable"


def test_prefetch_thread_takes_the_profile_as_parent(traced):
    spans = traced["lw-fsck32.lut"].spans
    core = _one(spans, "ecckd.create_lut.core")
    by_id = {s.id: s for s in spans}
    reads = [s for s in spans if s.name == "ecckd.io.read_block"]
    profiles = [s for s in spans if s.name == "ecckd.create_lut.profile"]
    assert len(reads) == len(profiles) == 6     # 2 gases x 3 columns
    for s in reads:
        assert s.thread != MAIN and s.call == core.id
        assert by_id[s.parent].name == "ecckd.create_lut.profile"
    for s in spans:
        assert s.call == core.id
        if s.name in ("ecckd.create_lut.wait_block", "ecckd.create_lut.copy",
                      "ecckd.create_lut.partials"):
            assert s.thread == MAIN
            assert by_id[s.parent].name == "ecckd.create_lut.profile"


LOOP = ("ecckd.create_lut.wait_block", "ecckd.create_lut.copy",
        "ecckd.create_lut.partials", "ecckd.create_lut.stage")


def _loop_spans_by_step(spans):
    """The block loop's spans of a search, by the name of the search step
    they ran under: their parent, or the span that started their thread."""
    by_id = {s.id: s for s in spans}
    steps = {}
    for s in spans:
        if s.name in LOOP:
            steps.setdefault(by_id[s.parent].name, []).append(s)
    return steps


@pytest.mark.parametrize("cell", ["lw-fsck32.search", "sw-rgb32.search"])
def test_search_copies_nest_under_their_steps(traced, cell):
    """The block loop of the search's od copies, on the CPU: its wait,
    copy and read-back spans on the main thread, under reorder's
    ``sorting_variable`` (a block a gas at this size) and find_g_points'
    ``prepare`` (the od of each gas and the background of the second),
    and under no other step."""
    steps = _loop_spans_by_step(traced[cell].spans)
    assert set(steps) == {"ecckd.reorder.sorting_variable",
                          "ecckd.find_g_points.prepare"}
    for step, found in steps.items():
        assert all(s.thread == MAIN for s in found)
        names = [s.name for s in found]
        blocks = 2 if step == "ecckd.reorder.sorting_variable" else 3
        assert names.count("ecckd.create_lut.copy") == blocks, (step, names)
        assert names.count("ecckd.create_lut.partials") >= blocks
        assert names.count("ecckd.create_lut.wait_block") >= blocks


@pytest.mark.gpu
def test_search_staging_nests_under_its_steps():
    """On the card (``python -m pytest --noconftest -m gpu
    tests/test_torch_spans.py``): the prefetch thread's ``.stage`` spans
    and the main thread's ``.copy`` and ``.partials`` spans of a small LW
    search under a profile nest under reorder's ``sorting_variable`` and
    find_g_points' ``prepare``, one ``.stage`` and one ``.copy`` a
    block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: staging has no CPU mode")
    from ckd_bench.jobs.search import Job
    cfg = bench_conftest.tiny("lw-fsck32", **bench_conftest.LW_SEARCH)
    job = Job(cfg, {"job": "search"}, SEED, "cuda")
    logs.set_log_level("warning")
    try:
        job.run()
        logs.clear_spans()
        with torch.profiler.profile():
            job.run()
        steps = _loop_spans_by_step(logs.spans())
    finally:
        logs.clear_spans()
        logs.set_log_level("info")
    # a block a gas: reorder's od; find_g_points' od and one background
    blocks = {"ecckd.reorder.sorting_variable": 2,
              "ecckd.find_g_points.prepare": 3}
    assert set(steps) == set(blocks)
    for step, found in steps.items():
        stages = [s for s in found if s.name == "ecckd.create_lut.stage"]
        copies = [s for s in found if s.name == "ecckd.create_lut.copy"]
        assert len(stages) == len(copies) == blocks[step], step
        assert all(s.thread != MAIN for s in stages)
        assert all(s.thread == MAIN for s in copies)
        assert any(s.name == "ecckd.create_lut.partials" for s in found)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_span_of_the_cell_is_recorded(traced, cell):
    names = {s.name for s in traced[cell].spans}
    assert set(SPANS[cell]) <= names, set(SPANS[cell]) - names
    for s in traced[cell].spans:
        assert s.end_ns >= s.start_ns


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_offset_puts_main_thread_spans_on_the_profiler(traced, cell):
    """Each main-thread span, mapped by ckd_bench/spans.py, starts within a
    median of 50 us of its profiler event."""
    from ckd_bench import spans as bench_spans
    ctx = traced[cell].ctx
    events = {}
    for name, start, _ in sorted(ctx.trace.cpu_events, key=lambda e: e[1]):
        if name.startswith("ecckd."):
            events.setdefault(name, []).append(start)
    mapped = {}
    for name, start, _, s in sorted(bench_spans.mapped(ctx),
                                    key=lambda m: m[1]):
        if s.thread == MAIN:
            mapped.setdefault(name, []).append(start)
    gaps = [abs(a - b) for name, starts in mapped.items()
            for a, b in zip(starts, events[name])]
    assert len(gaps) == sum(map(len, mapped.values())) >= 10
    assert statistics.median(gaps) < 50.0


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_reader_gives_a_finite_number(traced, metric):
    cell = {"search": ["lw-fsck32.search", "sw-rgb32.search"],
            "lut": ["lw-fsck32.lut"]}[METRICS[metric]]
    for name in cell:
        value = traced[name].result["metrics"][metric]["value"]
        assert math.isfinite(value) and value > 0.0, (name, value)


def test_profile_written_with_every_thread_spans(tmp_path):
    """A tool's profile (``profile_dir``) holds the spans of every thread
    as events of the process "ecckd spans", on the trace's clock."""
    from ecckd_tpu_torch.config import Config
    from ecckd_tpu_torch.tools.common import maybe_profile

    def inner():
        with logs.span("ecckd.test.inner"):
            torch.ones(8).sum()

    with maybe_profile(Config({"profile_dir": str(tmp_path)})):
        with logs.span("ecckd.test.outer"):
            t = threading.Thread(target=logs.spawned(inner))
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    assert logs.spans() == []
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat") == "ecckd_span"}
    outer, inner_ev = ours["ecckd.test.outer"], ours["ecckd.test.inner"]
    assert outer["pid"] == inner_ev["pid"] == "ecckd spans"
    assert outer["tid"] == MAIN and inner_ev["tid"] != MAIN
    assert inner_ev["args"]["parent"] == outer["args"]["id"]
    assert inner_ev["args"]["call"] == outer["args"]["id"]
    profiled = [e for e in events if e.get("cat") == "cpu_op"
                and e["name"] == "ecckd.test.outer"]
    assert len(profiled) == 1
    assert abs(profiled[0]["ts"] - outer["ts"]) < 50.0
