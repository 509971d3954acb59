"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by its name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ckd_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    from ckd_bench.harness import load_job
    from ckd_bench.run import load_cell
    cell, cfg, traffic, _ = load_cell(ROOT, name)
    assert cell["chips"] == 1
    assert hasattr(load_job(traffic), "check")
    assert cfg["name"] == cell["config"]
    assert cfg["limits"][traffic["job"]]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    assert entry["source"].startswith("https://")
    assert cfg["assumed"]["tolerance"]
    for key in entry["reduced"]:
        assert NAME.match(key)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_names_and_units(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_reader_found_by_name(metric):
    from ckd_bench.harness import load_metric
    assert callable(load_metric(metric["name"]).read)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", CELLS)


def test_every_cell_reports_setup_and_a_metric_of_each_kind():
    from ckd_bench.run import metrics_of
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in metrics_of(BENCH, w, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert metrics_of(BENCH, w, True)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_texts_on_one_line():
    texts = [c[k] for c in BENCH["configs"] for k in ("source", "why")]
    texts += [w["why"] for w in BENCH["workloads"]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    texts += BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
