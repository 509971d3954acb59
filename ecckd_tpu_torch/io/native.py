"""ctypes bindings of the native shard loader (``csrc/shardloader.cpp``).

The port's own copy of ``ecckd_tpu/io/native.py``.  The library gives
synchronous and pooled asynchronous ``pread`` reads of ``.spbin`` shards,
so that a streamed profile's next wavenumber block is read while the
current one is averaged (the reference's wall clock is dominated by disk
reads, doc/ecckd_documentation.tex:225-228).

It is built with ``g++`` at first use into ``build/ecckd_tpu_torch/`` at
the root of the checkout (the kernels' build directory), under a name that
carries a hash of the source and flags, never into the source tree.  A
failed build raises with the compiler's output: nothing falls back to
Python file reads, which a caller gets only by asking,
``NativeFile(path, native=False)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..ops.kernels._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "shardloader.cpp"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """The library's path: a hash of the flags and the source."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libshardloader_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native shard loader of "
                           "ecckd_tpu_torch is built with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        out = str(Path(tmpdir) / target.name)
        cmd = [cxx, *FLAGS, "-o", out, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native shard loader failed "
                f"({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}"
                f"{proc.stderr}")
        # atomic: a concurrent build sees no library or a whole one
        os.replace(out, target)


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if its source changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            _compile(target)
        lib = ctypes.CDLL(str(target))
        lib.sl_open.restype = ctypes.c_void_p
        lib.sl_open.argtypes = [ctypes.c_char_p]
        lib.sl_size.restype = ctypes.c_int64
        lib.sl_size.argtypes = [ctypes.c_void_p]
        lib.sl_read.restype = ctypes.c_int64
        lib.sl_read.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_void_p]
        lib.sl_close.restype = None
        lib.sl_close.argtypes = [ctypes.c_void_p]
        lib.sl_pool_create.restype = ctypes.c_void_p
        lib.sl_pool_create.argtypes = [ctypes.c_int]
        lib.sl_pool_destroy.restype = None
        lib.sl_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.sl_pool_submit.restype = ctypes.c_int
        lib.sl_pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int]
        lib.sl_pool_wait.restype = ctypes.c_int64
        lib.sl_pool_wait.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_int64]
        _lib = lib
        return _lib


class NativeFile:
    """A read-only file for synchronous reads and pooled async reads:
    through the native library, or with ``native=False`` through Python's
    file object.

    Reads and :meth:`close` may come from different threads (a prefetch
    thread reads a block while the consumer, on an error, closes the
    file): close waits for a read in flight and collects the pooled reads
    submitted against the file before it frees the handle, and a read
    after close raises ``ValueError``."""

    def __init__(self, path: str, native: bool = True):
        self.path = path
        self._lib = get_lib() if native else None
        self._handle = None
        self._py_file = None
        self._io = threading.Condition()
        self._queued = set()     # (pool, tag) submitted, not yet collected
        self._collecting = 0     # pooled reads a PrefetchPool.wait collects
        if native:
            self._handle = self._lib.sl_open(os.fsencode(path))
            if not self._handle:
                self._handle = None
                if not os.path.exists(path):
                    raise FileNotFoundError(f"{path}: no such file")
                raise OSError(f"{path}: cannot be opened")
        else:
            self._py_file = open(path, "rb")

    @property
    def native(self) -> bool:
        return self._lib is not None

    def _check_open(self):
        if self._handle is None and self._py_file is None:
            raise ValueError(f"{self.path}: read on a closed file")

    @property
    def size(self) -> int:
        with self._io:
            self._check_open()
            if self.native:
                return int(self._lib.sl_size(self._handle))
            return os.fstat(self._py_file.fileno()).st_size

    def read(self, offset: int, size: int) -> np.ndarray:
        """Up to ``size`` bytes from ``offset``, as uint8."""
        buf = np.empty(size, np.uint8)
        with self._io:
            self._check_open()
            if self.native:
                n = self._lib.sl_read(self._handle, offset, size,
                                      buf.ctypes.data_as(ctypes.c_void_p))
            else:
                self._py_file.seek(offset)
                n = self._py_file.readinto(memoryview(buf))
        if n < 0:
            raise IOError(f"read failed on {self.path}")
        return buf[:n]

    def close(self):
        with self._io:
            for pool, tag in list(self._queued):
                self._queued.discard((pool, tag))
                try:
                    pool._collect(tag)
                except OSError:
                    pass     # the read failed; nobody asked for it
            self._io.wait_for(lambda: self._collecting == 0)
            if self._handle is not None:
                self._lib.sl_close(self._handle)
                self._handle = None
            if self._py_file is not None:
                self._py_file.close()
                self._py_file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PrefetchPool:
    """Asynchronous native reads: submit block k+1 while block k is being
    processed, then wait for it by its tag.  Reads only native files; a
    read whose file was closed before it was waited for raises
    ``ValueError`` at :meth:`wait`."""

    def __init__(self, nthreads: int = 4):
        self._lib = get_lib()
        self._pool = self._lib.sl_pool_create(nthreads)
        self._pending = {}       # tag -> (size, file)

    def submit(self, f: NativeFile, offset: int, size: int, tag: int):
        if not f.native:
            raise ValueError(f"{f.path} was opened with native=False; "
                             "the pool reads native files only")
        with f._io:
            f._check_open()
            rc = self._lib.sl_pool_submit(self._pool, f._handle, offset,
                                          size, tag)
            if rc != 0:
                raise IOError("sl_pool_submit failed")
            f._queued.add((self, tag))
        self._pending[tag] = (size, f)

    def _collect(self, tag: int) -> np.ndarray:
        size, _ = self._pending.pop(tag)
        buf = np.empty(size, np.uint8)
        n = self._lib.sl_pool_wait(self._pool, tag,
                                   buf.ctypes.data_as(ctypes.c_void_p), size)
        if n < 0:
            raise IOError("async read failed")
        return buf[:n]

    def wait(self, tag: int) -> np.ndarray:
        _, f = self._pending.get(tag, (None, None))
        if f is None:
            raise ValueError(f"no read {tag} in flight: never submitted, or "
                             "its file was closed before it was waited for")
        with f._io:
            if (self, tag) not in f._queued:
                raise ValueError(f"{f.path} was closed before read {tag} "
                                 "was waited for")
            f._queued.discard((self, tag))
            f._collecting += 1
        try:
            return self._collect(tag)
        finally:
            with f._io:
                f._collecting -= 1
                f._io.notify_all()

    def close(self):
        if self._pool is not None:
            # the workers finish every queued read before they stop
            self._lib.sl_pool_destroy(self._pool)
            self._pool = None
            for tag, (_, f) in self._pending.items():
                with f._io:
                    f._queued.discard((self, tag))
            self._pending.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
