"""Host side of the streaming interval-sum core of kernels K3 and E2.

``csrc/interval_stream.cuh`` cuts the wavenumber axis into fixed chunks
of :data:`CHUNK` wavenumbers.  Per launch, :func:`interval_table` resolves
the intervals into the int32 table the core reads: each distinct clamped
interval once (repeated columns such as the front-padded ``[0, 0]`` bucket
columns share its sums), the list of intervals that meet each chunk, one
partial slot per (interval, chunk) pair, and per output column its first
slot and slot count (none for an empty interval).  The table of a pair of
bound tensors is kept while they are unchanged, and
:func:`device_bounds` uploads host bounds with their host copy, so a
launch reads no bounds back from the card.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

#: Wavenumbers per chunk (``ecckd_stream_chunk_size()`` of the library).
CHUNK = 2048
#: Interval entries a block reduces per pass, one per lane of a warp
#: (``kMaxEntries`` of the core).
MAX_ENTRIES = 32
#: Chunks a launch may have (the grid's second dimension).
MAX_CHUNKS = 65535


class IntervalTable(NamedTuple):
    """``table`` is ``chunk_ptr (nchunks + 1)``, then ``(lo, hi, slot)`` per
    entry, by chunk, then ``(first slot, slot count)`` per column."""
    table: np.ndarray
    nentries: int
    cmax: int
    nslots: int


def interval_table(i1, i2, n: int) -> IntervalTable:
    """The interval table of inclusive bounds ``i1``, ``i2`` over ``n``
    wavenumbers, clamped to ``[0, n - 1]``."""
    i1 = np.asarray(i1, np.int64).reshape(-1)
    i2 = np.asarray(i2, np.int64).reshape(-1)
    nseg = len(i1)
    nchunks = -(-n // CHUNK)
    if nchunks > MAX_CHUNKS:
        raise ValueError(f"interval sums: {n} wavenumbers exceed the "
                         f"{MAX_CHUNKS * CHUNK} one launch takes")
    lo = np.maximum(i1, 0)
    hi = np.minimum(i2, n - 1)
    full = lo <= hi
    uniq, inv = np.unique(np.stack([lo[full], hi[full]], axis=1), axis=0,
                          return_inverse=True)
    inv = inv.reshape(-1)
    ulo, uhi = uniq[:, 0], uniq[:, 1]
    c_lo = ulo // CHUNK
    nch = uhi // CHUNK - c_lo + 1
    first = np.cumsum(nch) - nch
    nslots = int(nch.sum())
    # One entry per (interval, chunk) pair, slots numbered by interval
    u_of = np.repeat(np.arange(len(uniq)), nch)
    chunk = np.repeat(c_lo - first, nch) + np.arange(nslots)
    order = np.lexsort((u_of, chunk))
    counts = np.bincount(chunk, minlength=nchunks)
    chunk_ptr = np.concatenate([[0], np.cumsum(counts)])
    entry = np.stack([ulo[u_of], uhi[u_of], np.arange(nslots)],
                     axis=1)[order]
    col = np.zeros((nseg, 2), np.int64)
    col[full, 0] = first[inv]
    col[full, 1] = nch[inv]
    table = np.concatenate([chunk_ptr, entry.reshape(-1), col.reshape(-1)])
    cmax = int(min(MAX_ENTRIES, max(1, counts.max(initial=0))))
    return IntervalTable(table.astype(np.int32), len(entry), cmax, nslots)


class _Bounds:
    """Device bounds, the version counts they were seen at, their host
    copy and their tables by ``n``; holding the tensors keeps their ids
    and addresses from being reused while the entry lives."""

    def __init__(self, i1, i2, host):
        self.i1, self.i2, self.host = i1, i2, host
        self.versions = (i1._version, i2._version)
        self.tables = {}


_BOUNDS: "OrderedDict[int, _Bounds]" = OrderedDict()
_BOUNDS_KEPT = 8


def _remember(i1, i2, host):
    entry = _Bounds(i1, i2, host)
    _BOUNDS[id(i1)] = entry
    _BOUNDS.move_to_end(id(i1))
    while len(_BOUNDS) > _BOUNDS_KEPT:
        _BOUNDS.popitem(last=False)
    return entry


def device_bounds(i1, i2, device):
    """Int32 tensors on ``device`` of the host bounds ``i1``, ``i2``,
    remembered with their host copy, so that a kernel launched on them
    builds its interval table without reading them back."""
    host = (np.array(i1, np.int32).reshape(-1),
            np.array(i2, np.int32).reshape(-1))
    t1, t2 = (torch.from_numpy(h.copy()).to(device) for h in host)
    _remember(t1, t2, host)
    return t1, t2


def device_table(i1, i2, n: int, dev):
    """``(table on dev, IntervalTable)`` of the device bounds ``i1``,
    ``i2``: from the entry of these very tensors while neither was
    written to since, else built from their values read back once."""
    entry = _BOUNDS.get(id(i1))
    if (entry is None or entry.i1 is not i1 or entry.i2 is not i2
            or entry.versions != (i1._version, i2._version)):
        entry = _remember(i1, i2, None)
    else:
        _BOUNDS.move_to_end(id(i1))
    if n not in entry.tables:
        if entry.host is None:
            entry.host = (i1.cpu().numpy(), i2.cpu().numpy())
        tab = interval_table(*entry.host, n)
        entry.tables[n] = (torch.from_numpy(tab.table).to(dev), tab)
    return entry.tables[n]


def check_library(lib):
    """Raise unless the library's chunk is this module's."""
    if lib.ecckd_stream_chunk_size() != CHUNK:
        raise RuntimeError("interval sums: the library's chunk differs "
                           "from interval_stream.py's")

