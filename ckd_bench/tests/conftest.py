"""Settings of the benchmark's own tests (``python -m pytest
ckd_bench/tests``).  Tests that need a CUDA card take the ``card``
fixture, which skips them here; the check is made when the fixture runs,
never while a module is imported."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny(name, nwav=4096, nlay=12, nlines=40, **override):
    """A configuration cut to a size the CPU runs in seconds."""
    cfg = json.loads((ROOT / "ckd_bench" / "configs"
                      / f"{name}.json").read_text())
    cfg.update(nwav=nwav, nlay=nlay, **override)
    for g in cfg["gases"]:
        g["nlines"] = nlines
    return cfg


# Searches at a size the CPU runs in seconds, each with the tolerance that
# gives the same number of g-points, ``g_points``, on every seed the tests
# use.
LW_SEARCH = {"nwav": 32768, "tolerance": 0.3, "g_points": 5}
SW_SEARCH = {"nwav": 16384, "tolerance": 0.5, "g_points": 11}


@pytest.fixture
def quiet():
    """The port's log quiet and one torch thread, as the test runner's
    workers share the cores."""
    import torch
    from ecckd_tpu_torch import logs
    threads = torch.get_num_threads()
    logs.set_log_level("warning")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    logs.set_log_level("info")
