"""ecckd_tpu_torch stands alone: it imports neither jax nor ecckd_tpu.

Two checks: a scan of the import statements of every module of the port
and of ``chip_smoke.py``, and a fresh interpreter that refuses to import
jax or the JAX package and imports every module of the port and
``chip_smoke`` all the same.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "ecckd_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name):
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "ecckd_tpu"))


def test_sources_import_nothing_of_jax_or_the_jax_package():
    found = []
    for path in SOURCES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                      for n in names if _forbidden(n)]
    assert len(SOURCES) > 30
    # the parallel package and the smoke's parallel phase are scanned too
    assert {"mesh.py", "distributed.py", "sharded_average.py"} <= {
        p.name for p in SOURCES if p.parent.name == "parallel"}
    assert "def phase_parallel" in (ROOT / "chip_smoke.py").read_text()
    assert not found, found


_PROBE = r"""
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == top or name.startswith(top + ".")
               for top in ("jax", "ecckd_tpu")):
            raise ImportError(f"import of {name} refused")
        return None

sys.meta_path.insert(0, Refuse())
import ecckd_tpu_torch
names = sorted({m.name for m in pkgutil.walk_packages(
    ecckd_tpu_torch.__path__, "ecckd_tpu_torch.")} | set(sys.argv[1:]))
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if any(m == top or m.startswith(top + ".")
                    for top in ("jax", "ecckd_tpu")))
assert not bad, bad
print(len(names))
"""


def test_port_imports_with_jax_and_the_jax_package_refused():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    # every module file of the port, whether or not its directory is a
    # package that pkgutil walks
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in SOURCES[:-1] if p.name != "__init__.py"]
    proc = subprocess.run([sys.executable, "-c", _PROBE, *modules],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= len(modules) > 50


WORKFLOW_MODULES = ["ecckd_tpu_torch.io.ncio",
                    "ecckd_tpu_torch.pipeline.orchestrator",
                    "ecckd_tpu_torch.pipeline.presets",
                    "ecckd_tpu_torch.evaluate.metrics",
                    "ecckd_tpu_torch.evaluate.plots",
                    "ecckd_tpu_torch.tools.evaluate_ckd",
                    "ecckd_tpu_torch.tools.plot_ckd"]

_PROBE_NO_H5PY = r"""
import importlib, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == top or name.startswith(top + ".")
               for top in ("jax", "ecckd_tpu", "h5py")):
            raise ImportError(f"import of {name} refused")
        return None

sys.meta_path.insert(0, Refuse())
importlib.import_module(sys.argv[1])
print("ok")
"""


@pytest.mark.parametrize("module", WORKFLOW_MODULES)
def test_workflow_modules_import_without_jax_or_h5py(module):
    """The orchestrator, its presets, the evaluation tools and the NetCDF
    layer are scanned above, and import in a fresh interpreter that
    refuses jax, the JAX package and h5py (the card's machine has none)."""
    path = ROOT.joinpath(*module.split(".")).with_suffix(".py")
    assert path in SOURCES
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PROBE_NO_H5PY, module],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"
