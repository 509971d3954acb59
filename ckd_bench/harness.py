"""The run of one cell: set-up, the measured window, the check against the
plain reference, and the metrics.

Driven by data: the job kind and its parameters come from the traffic
file (``ckd_bench/jobs/<job>.py``, a class ``Job``), each per-layer metric
from its reader ``ckd_bench/metrics/<name>.py``.  A job class is built from
(configuration, traffic, seed, device) and offers ``warm()`` (set-up's
run of the cell's shapes), ``run()`` (one whole job; its answer),
``digest(answer)``, ``end_to_end(durations, window_s)``, ``release()``
(frees the program's state), ``check(answers)`` (each number compared:
name -> (value, limit)) and a ``tracing`` flag, set for a traced window,
under which it keeps what its per-layer metrics read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from . import trace as tracing

HERE = Path(__file__).resolve().parent


def load_job(traffic):
    return importlib.import_module(f"ckd_bench.jobs.{traffic['job']}").Job


def load_metric(name):
    """The reader of one per-layer metric, found by its name: its own file
    ``metrics/<name>.py``, or the file of the part of its name before the
    first dot, which the metrics of one quantity split by the end-to-end
    metric they move (``idle_share.search``, ``idle_share.lut``) share."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"ckd_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_info(device, peak):
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def run_window(job, seconds, device):
    """Whole jobs back to back until the first job end after ``seconds``:
    (answers by digest, durations, failures, window seconds)."""
    answers, durations, failed = {}, [], 0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        try:
            answer = job.run()
            sync(device)
        except Exception:       # a failed job counts, and the run goes on
            traceback.print_exc()
            failed += 1
            answer = None
        durations.append(time.perf_counter() - t)
        print(json.dumps({"job": len(durations), "seconds": durations[-1],
                          **(job.describe(answer) if answer else {})}),
              file=sys.stderr, flush=True)
        if answer is not None:
            key = job.digest(answer)
            answers.setdefault(key, [answer, 0])[1] += 1
        if time.perf_counter() - t0 >= seconds:
            break
    return answers, durations, failed, time.perf_counter() - t0


def run_cell(cell, cfg, traffic, metric_entries, seed, seconds, trace,
             device, t_start):
    """One run of ``cell``; returns the result line as a dict."""
    from ecckd_tpu_torch import logs
    from ecckd_tpu_torch.config import Config
    from ecckd_tpu_torch.tools.common import setup
    logs.set_log_level("warning")
    if torch.device(device).type == "cuda":
        from ecckd_tpu_torch.ops.kernels import _build
        _build.prebuild((False,))
    # The tools' own set-up: TF32 off, float64 as the configuration states
    setup(Config({"device": device, "precision": cfg["precision"]}))
    job = load_job(traffic)(cfg, traffic, seed, device)
    job.warm()
    sync(device)
    setup_s = time.perf_counter() - t_start
    print(json.dumps({"setup_s": setup_s}), file=sys.stderr, flush=True)

    ctx = None
    if trace:
        job.tracing = True
        with tracing.Trace(device) as tr:
            answers, durations, failed, window_s = run_window(
                job, seconds, device)
        ctx = tracing.Context(job, tr, durations, window_s)
    else:
        answers, durations, failed, window_s = run_window(job, seconds,
                                                          device)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    job.release()
    checks = job.check([a for a, _ in answers.values()])
    correct = failed == 0 and bool(answers) and all(
        value <= limit for value, limit in checks.values())

    metrics = {}
    if trace:
        for m in metric_entries:
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = job.end_to_end(durations, window_s)
        e2e["setup_s"] = setup_s
        for m in metric_entries:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(durations),
           "failed": failed, "metrics": metrics,
           "device": device_info(device, peak)}
    if trace:
        out["device"].update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        out["breakdown"] = ctx.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in checks.items()}
    return out

