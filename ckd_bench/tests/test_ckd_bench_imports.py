"""The benchmark loads neither JAX nor the JAX package: top-level module
names compared whole, so the port's name, which begins with the JAX
package's, passes."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_compared_whole():
    from ckd_bench.run import forbidden_modules
    assert forbidden_modules(["ecckd_tpu_torch", "ecckd_tpu_torch.ops",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "ecckd_tpu.ops", "jaxlib",
                              "flax.linen"]) == ["ecckd_tpu", "flax", "jax",
                                                 "jaxlib"]


def test_a_run_loads_no_jax():
    """Load everything a run loads, and drive a job at a tiny size on the
    CPU, in a fresh process, then look at sys.modules."""
    code = (
        "import json, sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"sys.path.insert(0, {str(Path(__file__).parent)!r})\n"
        "from conftest import tiny\n"
        "from ckd_bench.harness import run_cell, load_metric\n"
        "from ckd_bench.run import forbidden_modules\n"
        "import ckd_bench.jobs.search, ckd_bench.jobs.lut\n"
        "import ckd_bench.calibrate, ckd_bench.control\n"
        f"bench = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))\n"
        "for m in bench['per_layer']: load_metric(m['name'])\n"
        "from ecckd_tpu_torch import logs\n"
        "cell = {'name': 'lw-fsck32.search', 'chips': 1}\n"
        "run_cell(cell, tiny('lw-fsck32', nwav=1024, nlay=6, nlines=8),\n"
        "         {'job': 'search'}, [], 5, 0.0, False, 'cpu',\n"
        "         time.perf_counter())\n"
        "print('FORBIDDEN', forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def _imports(path):
    import ast
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_sources_import_no_jax():
    from ckd_bench.run import FORBIDDEN
    sources = sorted((ROOT / "ckd_bench").rglob("*.py"))
    assert len(sources) > 20
    found = [f"{p.relative_to(ROOT)} {name}" for p in sources
             for name in _imports(p) if name in FORBIDDEN]
    assert found == []


def test_reference_imports_nothing_of_the_port():
    """The plain reference works everything out again: it imports neither
    the port nor the benchmark's other modules."""
    sources = sorted((ROOT / "ckd_bench" / "reference").glob("*.py"))
    assert sources
    found = [f"{p.name} {name}" for p in sources for name in _imports(p)
             if name not in ("__future__", "math", "numpy", "torch")]
    assert found == []
