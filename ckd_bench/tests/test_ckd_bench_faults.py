"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a tiny size, with one fault planted in the port: an
answer altered where it is produced (every candidate cost 1% high; every
fitted od of a table 1% high), half of the batch left out with the mean
taken over the rest (the cost's layer sum over every other layer,
doubled; a table averaged over every other wavenumber), and a search that
decides wrongly with costs that are right for what it decided (the
equipartition cut to one iteration; the first inner bound of each band
moved halfway to the next, its costs recomputed; each band searched at
1.5 times the tolerance, so with fewer g-points).  The two faults
of training (a step that returns its state unchanged) and of several
cards (the exchange between them left out) have no place in these
single-card cells, which hold no state from job to job."""

import time

import pytest
import torch

from ckd_bench.control import FAULTS
from conftest import LW_SEARCH, SW_SEARCH, tiny


def run(name, job, **override):
    from ckd_bench.harness import run_cell
    cell = {"name": f"{name}.{job}", "chips": 1}
    return run_cell(cell, tiny(name, **override), {"job": job}, [],
                    2 ** 31 + 7, 0.0, False, "cpu", time.perf_counter())


def altered_cost(monkeypatch):
    from ecckd_tpu_torch.partition import cost_kernel
    real = cost_kernel._cost_terms

    def high(*a):
        hr2, flux2 = real(*a)
        return 1.0201 * hr2, 1.0201 * flux2
    monkeypatch.setattr(cost_kernel, "_cost_terms", high)


def half_layers(monkeypatch):
    from ecckd_tpu_torch.partition import cost_kernel
    monkeypatch.setattr(cost_kernel, "_layer_sum",
                        lambda x: 2.0 * torch.cumsum(x[::2], dim=0)[-1])


def altered_table(monkeypatch):
    from ecckd_tpu_torch.ops import average
    from ecckd_tpu_torch.tools import create_lut
    real = average.finalize_gpoint_partials

    def fit_high(*a, **k):
        fit, lo, hi = real(*a, **k)
        return 1.01 * fit, lo, hi
    for mod in (average, create_lut):
        if hasattr(mod, "finalize_gpoint_partials"):
            monkeypatch.setattr(mod, "finalize_gpoint_partials", fit_high)
    from ecckd_tpu_torch.ops import streaming
    monkeypatch.setattr(streaming, "finalize_gpoint_partials", fit_high,
                        raising=False)


def half_wavenumbers(monkeypatch):
    from ecckd_tpu_torch.ops import average, streaming
    real = average.gpoint_block_partials

    def every_other(ng, g_point, od, weight, method):
        w = torch.broadcast_to(weight, od.shape)
        return real(ng, g_point[::2], od[:, ::2], w[:, ::2], method)
    for mod in (average, streaming):
        monkeypatch.setattr(mod, "gpoint_block_partials", every_other,
                            raising=False)


def fewer_iterations(monkeypatch):
    FAULTS["fewer_iterations"](monkeypatch.setattr)


def bound_moved(monkeypatch):
    FAULTS["bound_moved"](monkeypatch.setattr)


def stops_early(monkeypatch):
    FAULTS["stops_early"](monkeypatch.setattr)


LUT = {"tolerance": 0.5}
CASES = [("lw-fsck32", "search", LW_SEARCH, altered_cost),
         ("lw-fsck32", "search", LW_SEARCH, half_layers),
         ("sw-rgb32", "search", SW_SEARCH, altered_cost),
         ("lw-fsck32", "lut", LUT, altered_table),
         ("lw-fsck32", "lut", LUT, half_wavenumbers),
         ("lw-fsck32", "search", LW_SEARCH, fewer_iterations),
         ("lw-fsck32", "search", LW_SEARCH, bound_moved),
         ("lw-fsck32", "search", LW_SEARCH, stops_early),
         ("sw-rgb32", "search", SW_SEARCH, fewer_iterations),
         ("sw-rgb32", "search", SW_SEARCH, bound_moved),
         ("sw-rgb32", "search", SW_SEARCH, stops_early)]


@pytest.mark.parametrize("name,job,override,fault", CASES,
                         ids=[f"{c[0]}.{c[1]}-{c[3].__name__}"
                              for c in CASES])
def test_fault_is_not_correct(quiet, monkeypatch, name, job, override,
                              fault):
    fault(monkeypatch)
    out = run(name, job, **override)
    assert out["correct"] is False, out["checks"]
    if fault in (fewer_iterations, bound_moved, stops_early):
        # Caught by what the search decided, not by a cost it reported
        assert out["checks"]["gpoint_cost_gap"]["value"] <= \
            out["checks"]["gpoint_cost_gap"]["limit"], out["checks"]


@pytest.mark.parametrize("name,job,override",
                         [CASES[i][:3] for i in (0, 2, 3)],
                         ids=["lw-fsck32.search", "sw-rgb32.search",
                              "lw-fsck32.lut"])
def test_sound_run_is_correct(quiet, name, job, override):
    out = run(name, job, **override)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
