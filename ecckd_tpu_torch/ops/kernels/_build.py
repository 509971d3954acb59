"""Build and load the hand-written Hopper kernels of ``ecckd_tpu_torch/csrc``.

The ``.cu`` sources have a plain C interface.  Each is compiled by its own
``nvcc``, all at once, and the objects are linked into one shared library,
loaded with :mod:`ctypes`.  The library goes into
``build/ecckd_tpu_torch/`` at the root of the checkout, under a name that
carries a hash of the sources and flags, so it is built at first use and
rebuilt whenever a source changes.  Nothing here runs at import time.

A second library, the checked build, comes from the same sources with
``-DECCKD_CHECKED=1 -lineinfo`` (``csrc/checked.cuh``): every index that a
kernel takes from a table or an argument is held to its range, and one
outside it prints where and traps.  ``library(checked=True)`` loads it, and
the wrappers take it inside ``with checked():``, where they also validate
the tables they upload and the sizes of the buffers they hand a kernel.
"""

from __future__ import annotations

import contextlib
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
           "sweep_lw_scan.cu", "fused_sums_lw.cu", "segment_minmax.cu")
HEADERS = ("checked.cuh", "interval_stream.cuh", "lw_coeffs.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
CHECKED_FLAGS = ("-DECCKD_CHECKED=1", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# argtypes of every entry point: pointers and the stream as c_void_p, so
# ctypes never truncates a 64-bit address to an int
_SIGNATURES = {
    "ecckd_sweep_strip_size": (_I,),
    "ecckd_sweep_lw_f64": (_P,) * 9 + (_I,) * 4 + (_P,),
    "ecckd_sweep_lw_f32": (_P,) * 9 + (_I,) * 4 + (_P,),
    "ecckd_sweep_sw_f64": (_P,) * 8 + (_I,) * 4 + (ctypes.c_double, _I, _P),
    "ecckd_sweep_sw_f32": (_P,) * 8 + (_I,) * 4 + (ctypes.c_double, _I, _P),
    "ecckd_stream_chunk_size": (),
    "ecckd_interval_sum_f64": (_P,) * 5 + (_I,) * 6 + (_P,),
    "ecckd_interval_sum_f32": (_P,) * 5 + (_I,) * 6 + (_P,),
    "ecckd_scan_max_layers": (),
    "ecckd_scan_strip_size": (),
    "ecckd_sweep_lw_scan_f64": (_P,) * 9 + (_I,) * 4 + (_P,),
    "ecckd_sweep_lw_scan_f32": (_P,) * 9 + (_I,) * 4 + (_P,),
    "ecckd_fused_sums_lw_f64": (_P,) * 8 + (_I,) * 5 + (_P,),
    "ecckd_fused_sums_lw_f32": (_P,) * 8 + (_I,) * 5 + (_P,),
    "ecckd_segment_minmax_f64": (_P,) * 3 + (_I, _L, _I, _I, _P),
    "ecckd_segment_minmax_f32": (_P,) * 3 + (_I, _L, _I, _I, _P),
}

_lock = threading.Lock()
_libs = {}
_checked = threading.local()
#: Seconds the last :func:`library` or :func:`prebuild` call spent
#: compiling (0 when the libraries were already built), and the compiler's
#: resource report of the normal and of the checked build.
build_seconds = 0.0
build_log = ""
checked_build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of ecckd_tpu_torch "
                       "are built with the CUDA toolkit's nvcc")


def _flags(checked: bool):
    return NVCC_FLAGS + (CHECKED_FLAGS if checked else ())


def _target(checked: bool) -> Path:
    """The library's path: a hash of the flags and the sources."""
    h = hashlib.sha256(" ".join(_flags(checked)).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    kind = "_checked" if checked else ""
    return BUILD_DIR / f"libecckd_kernels{kind}_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands at once; return each one's output or raise with
    the first failure's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return outs


def _compile(kinds) -> None:
    """Compile each source of each build in ``kinds`` (False: normal, True:
    checked) into an object, all at once, link each build's objects into
    its library and keep nvcc's report beside it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = [(k, s, str(Path(tmpdir) / f"{int(k)}_{s}.o"))
                for k in kinds for s in SOURCES]
        reports = _run([[_nvcc(), *_flags(k), "-c", "-o", o, str(CSRC / s)]
                        for k, s, o in jobs])
        libs = [str(Path(tmpdir) / f"lib{int(k)}.so") for k in kinds]
        _run([[_nvcc(), *ARCH_FLAGS, "-shared", "-o", lib,
               *(o for k2, _, o in jobs if k2 == k)]
              for k, lib in zip(kinds, libs)])
        for k, lib in zip(kinds, libs):
            target = _target(k)
            # atomic: a concurrent build sees the old library or the new
            os.replace(lib, target)
            target.with_suffix(".log").write_text("".join(
                r for (k2, _, _), r in zip(jobs, reports) if k2 == k))


def _load(checked: bool) -> ctypes.CDLL:
    target = _target(checked)
    log = target.with_suffix(".log")
    global build_log, checked_build_log
    if checked:
        checked_build_log = log.read_text() if log.exists() else ""
    else:
        build_log = log.read_text() if log.exists() else ""
    lib = ctypes.CDLL(str(target))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    _libs[checked] = lib
    return lib


def prebuild(checked=(False, True)) -> None:
    """Build and load the libraries ``checked`` names (False: normal,
    True: checked) that are not loaded yet, compiling every source of all
    of them at once."""
    global build_seconds
    with _lock:
        todo = [k for k in checked if k not in _libs]
        missing = [k for k in todo if not _target(k).exists()]
        t0 = time.perf_counter()
        if missing:
            _compile(missing)
        build_seconds = time.perf_counter() - t0
        for k in todo:
            _load(k)


def library(checked=None) -> ctypes.CDLL:
    """The loaded kernel library, compiled first if its sources changed:
    the checked build where ``checked`` is True, or (None) inside
    :func:`checked`."""
    if checked is None:
        checked = checked_mode()
    checked = bool(checked)
    if checked not in _libs:
        prebuild((checked,))
    return _libs[checked]


@contextlib.contextmanager
def checked():
    """Launch the checked build's kernels in this thread, with the
    wrappers' host checks, until the block ends."""
    depth = getattr(_checked, "depth", 0)
    _checked.depth = depth + 1
    try:
        yield
    finally:
        _checked.depth = depth


def checked_mode() -> bool:
    """Whether this thread is inside :func:`checked`."""
    return getattr(_checked, "depth", 0) > 0


def check(err: int, what: str) -> None:
    """Raise when a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
