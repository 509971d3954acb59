"""Leveled logging and a named-activity timer.

Functional equivalents of the reference's Logging.h streams
(src/include/Logging.h:36-155: LOG/DETAIL/DEBUG/WARNING/ERROR with a
``log_level`` config key, optional file sink and a progress stream) and
Timer.h (src/include/Timer.h:27-173: named wall-clock activities, report
on demand), and :func:`span`, the port's trace spans, kept while a
``torch.profiler`` profile runs.

The port's own copy of ``ecckd_tpu/logs.py``: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, NamedTuple, Optional, TextIO

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

_LEVELS = {"error": 0, "warning": 1, "info": 2, "progress": 2,
           "detail": 3, "debug": 4}
_current_level = 2
_log_file: Optional[TextIO] = None
_progress_open = False


def set_log_level(level: str) -> None:
    global _current_level
    key = level.lower()
    if key not in _LEVELS:
        raise ValueError(f"Unknown log level {level!r}; choose from {sorted(_LEVELS)}")
    _current_level = _LEVELS[key]


def set_log_file(path: Optional[str]) -> None:
    """Duplicate every emitted message into ``path`` (append), mirroring
    the reference's optional file output (Logging.h:36-155 /
    Logging.cpp ``set_log_file``).  ``None`` closes the sink."""
    global _log_file
    if _log_file is not None:
        _log_file.close()
        _log_file = None
    if path is not None:
        _log_file = open(path, "a")


def _end_progress(stream) -> None:
    """Terminate an open progress line before a normal message."""
    global _progress_open
    if _progress_open:
        print("", file=stream, flush=True)
        _progress_open = False


def _emit(level: int, prefix: str, *args) -> None:
    if level <= _current_level:
        msg = " ".join(str(a) for a in args)
        stream = sys.stderr if prefix else sys.stdout
        _end_progress(stream)
        print(f"{prefix}{msg}", file=stream, flush=True)
        if _log_file is not None:
            print(f"{prefix}{msg}", file=_log_file, flush=True)


def progress(*args) -> None:
    """In-place progress reporting (reference progress bar,
    Logging.h:112-125: equipartition prints one dot per cost evaluation,
    the minimizer a per-iteration line).  On a TTY the line is rewritten
    with a carriage return; otherwise each update is a plain line.  The
    file sink records every update as a full line."""
    global _progress_open
    if _LEVELS["progress"] > _current_level:
        return
    msg = " ".join(str(a) for a in args)
    if sys.stdout.isatty():
        print(f"\r{msg}", end="", file=sys.stdout, flush=True)
        _progress_open = True
    else:
        print(msg, file=sys.stdout, flush=True)
    if _log_file is not None:
        print(msg, file=_log_file, flush=True)


def log(*args) -> None:
    _emit(2, "", *args)


def detail(*args) -> None:
    _emit(3, "", *args)


def debug(*args) -> None:
    _emit(4, "", *args)


def warning(*args) -> None:
    _emit(1, "*** Warning: ", *args)


def error(*args) -> None:
    _emit(0, "*** Error: ", *args)


class Timer:
    """Accumulate wall-clock time in named activities.

    ``start(name)`` switches accumulation to that activity (ending the
    previous one); ``report()`` returns a formatted table.
    """

    def __init__(self):
        self._totals: Dict[str, float] = {}
        self._active: Optional[str] = None
        self._t0 = 0.0

    def start(self, name: str) -> None:
        now = time.perf_counter()
        if self._active is not None:
            self._totals[self._active] = (
                self._totals.get(self._active, 0.0) + now - self._t0)
        self._active = name
        self._t0 = now

    def stop(self) -> None:
        if self._active is not None:
            now = time.perf_counter()
            self._totals[self._active] = (
                self._totals.get(self._active, 0.0) + now - self._t0)
            self._active = None

    def total(self, name: str) -> float:
        return self._totals.get(name, 0.0)

    def report(self) -> str:
        self.stop()
        lines = ["Elapsed times:"]
        for name, t in self._totals.items():
            lines.append(f"  {name:30s} {t:10.3f} s")
        lines.append(f"  {'Total':30s} {sum(self._totals.values()):10.3f} s")
        return "\n".join(lines)


@contextmanager
def timed(timer: Timer, name: str):
    timer.start(name)
    try:
        yield
    finally:
        timer.stop()


class Span(NamedTuple):
    """One recorded span: its name, its start and end on
    ``time.perf_counter_ns``'s clock, the native id of its thread, its id,
    the id of its parent (the span that enclosed it on its thread, or the
    span that started its thread; 0 for none) and the id of the outermost
    span of its chain, shared by every span of one core call."""
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int
    call: int


_spans: List[Span] = []
_span_ids = itertools.count(1)
_open = threading.local()   # .stack: (id, call) of each open span


def _stack():
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Recorder:
    __slots__ = ("name", "start", "id", "parent", "call", "mark")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_span_ids)
        self.parent, self.call = stack[-1] if stack else (0, self.id)
        stack.append((self.id, self.call))
        self.mark = None
        if threading.current_thread() is threading.main_thread():
            # A user annotation (record_function) would also mark the
            # device's timeline over the kernels it launches, which a
            # reader of the trace takes for device work
            self.mark = _RecordFunctionFast(self.name)
            self.mark.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.mark is not None:
            self.mark.__exit__(*exc)
        _stack().pop()
        _spans.append(Span(self.name, self.start, end,
                           threading.get_native_id(), self.id, self.parent,
                           self.call))
        return False


_NO_SPAN = nullcontext()


def span(name: str):
    """Context manager marking one step of the port, ``ecckd.<layer>.
    <step>``.  While a ``torch.profiler`` profile runs it records the
    span (:func:`spans`) and, on the main thread, opens a profiler event of
    the same name, on the thread that holds the profile; otherwise it does
    nothing but read the profiler's flag."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Recorder(name)


def tracing() -> bool:
    """Whether spans are being recorded: a ``torch.profiler`` profile
    runs."""
    return _profiler._is_profiler_enabled


def record(name: str, start_ns: int, end_ns: int) -> None:
    """Record a span of this thread whose end it did not see itself (one
    that another thread closed, such as a wait that another thread's
    dispatch ended), from ``start_ns`` to ``end_ns`` on
    ``time.perf_counter_ns``'s clock, within the span open here.  Call it
    only where :func:`tracing`."""
    stack = _stack()
    sid = next(_span_ids)
    parent, call = stack[-1] if stack else (0, sid)
    _spans.append(Span(name, start_ns, end_ns, threading.get_native_id(),
                       sid, parent, call))


def _origin():
    """The (id, call) of the innermost span open on this thread, or None
    where none is or no profile runs."""
    stack = _stack()
    return stack[-1] if _profiler._is_profiler_enabled and stack else None


def spawned(target):
    """``target`` for a thread that the caller starts: the first spans it
    opens there take the span open here as their parent.  Without a
    profile, ``target`` itself."""
    origin = _origin()
    if origin is None:
        return target

    def run(*args, **kwargs):
        stack = _stack()
        stack.append(origin)
        try:
            return target(*args, **kwargs)
        finally:
            stack.pop()
    return run


def spawned_iter(iterable):
    """``iterable`` for a thread that iterates it (a prefetch thread): the
    spans its iteration opens there take the span open here as their
    parent.  Without a profile, ``iterable`` itself."""
    origin = _origin()
    if origin is None:
        return iterable

    def items():
        stack = _stack()    # the iterating thread's, also where it closes
        stack.append(origin)
        try:
            yield from iterable
        finally:
            stack.remove(origin)
    return items()


def spans() -> List[Span]:
    """The spans recorded so far, from every thread, in the order they
    ended."""
    return list(_spans)


def clear_spans() -> None:
    _spans.clear()
