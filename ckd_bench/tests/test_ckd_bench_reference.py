"""The plain reference against the port at a tiny size on the CPU: the
port's answers pass every limit, and the control, the port's own float32
path in place of the float64 the configurations state, fails one.  The
limits are the cells' own."""

import pytest
import torch

from conftest import LW_SEARCH, SW_SEARCH, tiny

SEEDS = (5, 77, 2 ** 31 + 12345)
CASES = [("lw-fsck32", "search", LW_SEARCH),
         ("sw-rgb32", "search", SW_SEARCH),
         ("lw-fsck32", "lut", {"tolerance": 0.15})]
IDS = [f"{c[0]}.{c[1]}" for c in CASES]


def numbers(name, job, dtype, override, seed):
    from ckd_bench.harness import load_job
    cfg = tiny(name, **override)
    j = load_job({"job": job})(cfg, {}, seed, "cpu", dtype=dtype)
    return j.check([j.run()])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,job,override", CASES, ids=IDS)
def test_port_agrees_with_reference(quiet, name, job, override, seed):
    checks = numbers(name, job, torch.float64, override, seed)
    for key, (value, limit) in checks.items():
        assert value <= limit, (key, value, limit)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,job,override", CASES, ids=IDS)
def test_control_fails(quiet, name, job, override, seed):
    checks = numbers(name, job, torch.float32, override, seed)
    assert any(value > limit for value, limit in checks.values()), checks


@pytest.mark.gpu
@pytest.mark.parametrize("name,job,override", CASES, ids=IDS)
def test_cell_on_card(card, quiet, name, job, override):
    """A whole run of each cell's job on the card, at a size a test holds,
    through the harness: correct, with the kernels launched.  The number
    of g-points is not held at this size."""
    import time
    from ckd_bench.harness import run_cell
    from ecckd_tpu_torch.ops.kernels import fused_interval_sum
    cfg = tiny(name, nwav=1 << 18, nlay=50, nlines=200, **{
        k: v for k, v in override.items() if k not in ("nwav", "g_points")})
    cfg["limits"].get("search", {})["g_point_count_gap"] = float("inf")
    out = run_cell({"name": f"{name}.{job}", "chips": 1}, cfg,
                   {"job": job}, [], SEEDS[0], 0.0, False, card,
                   time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert fused_interval_sum.launches > 0
