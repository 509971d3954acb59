"""Cross-band batching of equipartition candidate probes.

The port's copy of ``ecckd_tpu/partition/band_parallel.py``.  The
reference partitions bands one after another (find_g_points.cpp:1152), so
a gas with nband bands pays nband times the host time between probes.
Bands are independent, so their searches can run concurrently, every
kernel dispatch carrying the pending probes of all bands.

One gas-level candidate-cost kernel spans the whole rank axis: bands are
disjoint, contiguous rank ranges, so a band's probe is a global interval,
and the kernel's per-interval sums and per-wavenumber recurrences never
mix intervals.  Each band's search runs on its own thread against a
:class:`BandKernelView`; a :class:`ProbeScheduler` is a dynamic barrier
that fires a merged dispatch exactly when every live band thread is
blocked on a pending probe batch, so the batches, and with kernels whose
sums of an interval do not depend on the rest of the launch (K1, K2 and K3
on the card) every cost, are the same in every run.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np


class ProbeScheduler:
    """Dynamic barrier merging concurrent per-band probes into single
    whole-gas kernel dispatches.

    Threads :meth:`register`, call :meth:`costs` (blocking until the
    merged result arrives) as often as they search, and deregister with
    :meth:`done`; a merged dispatch fires when every registered thread has
    a pending batch, and a thread that finishes lowers the bar for the
    rest.  The dispatch runs under the scheduler's lock, so one runs at a
    time: the kernels' host state (the interval-table and row-table caches
    of :mod:`ecckd_tpu_torch.ops.kernels`) has no lock of its own, and the
    launches come from whichever band thread completes the barrier.

    Contract: one scheduler per gas.  A failed dispatch is kept in
    :attr:`error` for good: the dispatch's waiters and every later call of
    :meth:`costs` raise a RuntimeError chained to it, and the caller
    re-raises :attr:`error` itself after joining the threads."""

    def __init__(self, kernel):
        self.kernel = kernel
        self._cv = threading.Condition()
        self._active = 0
        self._pending: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._results: Dict[int, np.ndarray] = {}
        self.error: Optional[BaseException] = None
        self.dispatches = 0

    def register(self):
        with self._cv:
            self._active += 1

    def done(self):
        with self._cv:
            self._active -= 1
            self._maybe_dispatch()

    def costs(self, jband: int, i1: np.ndarray, i2: np.ndarray
              ) -> np.ndarray:
        with self._cv:
            if jband in self._pending:
                raise RuntimeError(f"band {jband} already has a pending "
                                   "probe batch")
            if self.error is None:
                self._pending[jband] = (np.asarray(i1, np.int64),
                                        np.asarray(i2, np.int64))
                self._maybe_dispatch()
            while jband not in self._results and self.error is None:
                self._cv.wait()
            if jband not in self._results:
                self._pending.pop(jband, None)
                raise RuntimeError(
                    "merged candidate-sweep dispatch failed") from self.error
            return self._results.pop(jband)

    def _maybe_dispatch(self):
        """Called with the lock held."""
        if (self.error is not None or not self._pending
                or len(self._pending) < self._active):
            return
        items = sorted(self._pending.items())   # ascending band = rank order
        self._pending = {}
        counts = [len(i1) for _, (i1, _) in items]
        i1 = np.concatenate([i1 for _, (i1, _) in items])
        i2 = np.concatenate([i2 for _, (_, i2) in items])
        try:
            out = self.kernel.costs(i1.astype(np.int32), i2.astype(np.int32))
        except BaseException as e:   # noqa: BLE001 (raised by every waiter)
            self.error = e
            self._cv.notify_all()
            return
        self.dispatches += 1
        pos = 0
        for (jband, _), n in zip(items, counts):
            self._results[jband] = out[pos:pos + n]
            pos += n
        self._cv.notify_all()


class BandKernelView:
    """Band-local facade over a gas-level candidate-cost kernel.

    Exposes the ``npoints``/``costs`` surface CkdEquipartition needs, with
    rank bounds shifted by the band's global offset.  With a scheduler the
    probes join the merged cross-band dispatches; without one they are
    evaluated at once on the gas kernel (``band_parallel="serial"``, the
    same kernel one band after another)."""

    def __init__(self, kernel, offset: int, npoints: int,
                 scheduler: Optional[ProbeScheduler] = None,
                 jband: Optional[int] = None):
        self.kernel = kernel
        self.offset = int(offset)
        self.npoints = int(npoints)
        self.scheduler = scheduler
        self.jband = jband

    def costs(self, i1, i2) -> np.ndarray:
        g1 = np.asarray(i1, np.int64) + self.offset
        g2 = np.asarray(i2, np.int64) + self.offset
        if self.scheduler is not None:
            return self.scheduler.costs(self.jband, g1, g2)
        return self.kernel.costs(g1.astype(np.int32), g2.astype(np.int32))
