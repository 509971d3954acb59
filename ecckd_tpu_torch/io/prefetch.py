"""Thread-ahead prefetching for blocked spectral reads.

The port's own copy of ``ecckd_tpu/io/prefetch.py``.  The reference's wall
clock is dominated by disk reads of the high-res spectra
(doc/ecckd_documentation.tex:225-228); its reads are synchronous.
Here every blocked read loop can overlap I/O with compute: a single
background thread advances the block generator (so all h5py/NetCDF calls
stay on ONE thread — h5py handles are not thread-safe for concurrent use)
while the consumer processes the previous block(s).  The native shard
loader (io/native.py) already double-buffers `.spbin` reads at the pread
level; this utility gives the same overlap to every other source
(io.spectrum.ProfileBlocks over NetCDF files or arrays), and moves the
host work of a shard block (widening, summing sources) off the consumer's
thread too.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch_iter(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``iterable`` on a background thread, ``depth`` items ahead.

    Yields exactly the same items in the same order as plain iteration
    (a test asserts bitwise equality of results).  Exceptions raised by
    the producer re-raise at the consuming ``next()`` call.  The
    background thread is a daemon and drains promptly when the consumer
    stops early (generator close / garbage collection).
    """
    if depth < 1:
        yield from iterable
        return
    q: queue.Queue = queue.Queue(maxsize=depth)

    stop = threading.Event()

    def put_stoppable(item) -> bool:
        """Bounded put that gives up when the consumer abandoned iteration
        (ADVICE r4: an unconditional blocking put would leave the daemon
        thread pinned forever holding up to ``depth`` spectral blocks)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterable:
                if not put_stoppable(item):
                    return
            put_stoppable(_SENTINEL)
        except BaseException as e:   # noqa: BLE001 — re-raised by consumer
            put_stoppable(e)

    t = threading.Thread(target=produce, daemon=True,
                         name="ecckd-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
