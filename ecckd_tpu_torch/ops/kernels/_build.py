"""Build and load the hand-written Hopper kernels of ``ecckd_tpu_torch/csrc``.

The ``.cu`` sources have a plain C interface.  Each is compiled by its own
``nvcc``, all at once, and the objects are linked into one shared library,
loaded with :mod:`ctypes`.  The library goes into
``build/ecckd_tpu_torch/`` at the root of the checkout, under a name that
carries a hash of the sources and flags, so it is built at first use and
rebuilt whenever a source changes.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ecckd_tpu_torch"
SOURCES = ("sweep_lw.cu", "sweep_sw.cu", "interval_sum.cu",
           "sweep_lw_scan.cu", "fused_sums_lw.cu")
HEADERS = ("interval_reduce.cuh", "interval_stream.cuh", "lw_coeffs.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every entry point: pointers and the stream as c_void_p, so
# ctypes never truncates a 64-bit address to an int
_SIGNATURES = {
    "ecckd_sweep_strip_size": (_I,),
    "ecckd_sweep_lw_f64": (_P,) * 9 + (_I,) * 4 + (_P,),
    "ecckd_sweep_lw_f32": (_P,) * 9 + (_I,) * 4 + (_P,),
    "ecckd_sweep_sw_f64": (_P,) * 8 + (_I,) * 4 + (ctypes.c_double, _I, _P),
    "ecckd_sweep_sw_f32": (_P,) * 8 + (_I,) * 4 + (ctypes.c_double, _I, _P),
    "ecckd_stream_chunk_size": (),
    "ecckd_interval_sum_f64": (_P,) * 5 + (_I,) * 5 + (_P,),
    "ecckd_interval_sum_f32": (_P,) * 5 + (_I,) * 5 + (_P,),
    "ecckd_scan_max_layers": (),
    "ecckd_chunk_size": (),
    "ecckd_sweep_lw_scan_f64": (_P,) * 10 + (_I, _I, _I, _P),
    "ecckd_sweep_lw_scan_f32": (_P,) * 10 + (_I, _I, _I, _P),
    "ecckd_fused_sums_lw_f64": (_P,) * 8 + (_I,) * 5 + (_P,),
    "ecckd_fused_sums_lw_f32": (_P,) * 8 + (_I,) * 5 + (_P,),
}

_lock = threading.Lock()
_lib = None
#: Seconds the last :func:`library` call spent compiling (0 when the
#: library was already built), and the compiler's resource report.
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of ecckd_tpu_torch "
                       "are built with the CUDA toolkit's nvcc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run(cmds):
    """Run the commands at once; return their joined output or raise
    with the first failure's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile(target: Path) -> str:
    """Compile each source into an object, all at once, link the objects
    into ``target`` and return nvcc's report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [str(Path(tmpdir) / (s + ".o")) for s in SOURCES]
        report = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                       for s, o in zip(SOURCES, objs)])
        lib = str(Path(tmpdir) / "lib.so")
        report += _run([[_nvcc(), *ARCH_FLAGS, "-shared", "-o", lib,
                         *objs]])
        os.replace(lib, target)   # atomic: a concurrent build sees old or new
    target.with_suffix(".log").write_text(report)
    return report


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if its sources changed."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        target = BUILD_DIR / f"libecckd_kernels_{_digest()}.so"
        t0 = time.perf_counter()
        if not target.exists():
            build_log = _compile(target)
            build_seconds = time.perf_counter() - t0
        else:
            log = target.with_suffix(".log")
            build_log = log.read_text() if log.exists() else ""
            build_seconds = 0.0
        lib = ctypes.CDLL(str(target))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
