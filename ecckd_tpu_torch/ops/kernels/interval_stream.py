"""Host side of the streaming interval-sum core of kernels K3, E2, K1, K2, E1.

``csrc/interval_stream.cuh`` cuts the wavenumber axis into fixed chunks:
:data:`CHUNK` wavenumbers for the sums K3 and E2, a strip (one warp's) of
``ecckd_sweep_strip_size(bytes)`` wavenumbers for the sweeps K1 and K2 and
of ``ecckd_scan_strip_size()`` for E1.  Per launch,
:func:`interval_table` resolves the intervals into the int32 table the
core reads: each distinct clamped interval once
(repeated columns such as the front-padded ``[0, 0]`` bucket columns share
its sums), the list of intervals that meet each chunk, one entry and one
partial slot per (interval, chunk) pair, and per output column its first
slot and slot count (none for an empty interval).  The tables of a pair of
bound tensors are kept, by wavenumber count and chunk, while the tensors
are unchanged, and :func:`device_bounds` uploads host bounds with their
host copy, so a launch reads no bounds back from the card: ``costs()``
hands K3 and the sweep the same tensors, and each builds its table once
per probe.  :func:`launch_sweep` is the host launcher of the sweeps.

A write that bypasses a tensor's version counter (through ``.data``, a
numpy or DLPack alias, or a raw pointer) is not seen, and the table of the
old values is kept: its sums are those of the old intervals, but every
index in it stays within the buffers a launch allocates from it, since the
kept table is taken only for tensors of its own storage and length.  Inside
``_build.checked()`` each kept table is held to the bounds' current values,
read back, and every table and launch buffer is validated before use.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from . import _build

#: Wavenumbers per chunk (``ecckd_stream_chunk_size()`` of the library).
CHUNK = 2048
#: Interval entries a block reduces per pass, one per lane of a warp
#: (``kMaxEntries`` of the core).
MAX_ENTRIES = 32
#: Chunks of :data:`CHUNK` a launch may have (K3's grid's second
#: dimension); every table-driven launch takes at most ``MAX_CHUNKS *
#: CHUNK`` wavenumbers.
MAX_CHUNKS = 65535


class IntervalTable(NamedTuple):
    """``table`` is ``chunk_ptr (nchunks + 1)``, then ``(lo, hi, slot)`` per
    entry, by chunk, then ``(first slot, slot count)`` per column; each
    entry has a slot of its own, ``nentries`` in all."""
    table: np.ndarray
    nentries: int
    cmax: int


def interval_table(i1, i2, n: int, chunk: int = CHUNK) -> IntervalTable:
    """The interval table of inclusive bounds ``i1``, ``i2`` over ``n``
    wavenumbers, clamped to ``[0, n - 1]``, in chunks of ``chunk``."""
    i1 = np.asarray(i1, np.int64).reshape(-1)
    i2 = np.asarray(i2, np.int64).reshape(-1)
    nseg = len(i1)
    if n > MAX_CHUNKS * CHUNK:
        raise ValueError(f"interval sums: {n} wavenumbers exceed the "
                         f"{MAX_CHUNKS * CHUNK} one launch takes")
    nchunks = -(-n // chunk)
    lo = np.maximum(i1, 0)
    hi = np.minimum(i2, n - 1)
    full = lo <= hi
    # Distinct intervals in (lo, hi) order, each packed into one key
    key, inv = np.unique(lo[full] * n + hi[full], return_inverse=True)
    inv = inv.reshape(-1)
    ulo, uhi = key // n, key % n
    c_lo = ulo // chunk
    nch = uhi // chunk - c_lo + 1
    first = np.cumsum(nch) - nch
    nslots = int(nch.sum())
    # One entry per (interval, chunk) pair, slots numbered by interval;
    # by chunk, then interval (a stable sort of the interval-ordered slots)
    u_of = np.repeat(np.arange(len(key)), nch)
    chunk = np.repeat(c_lo - first, nch) + np.arange(nslots)
    order = np.argsort(chunk, kind="stable")
    counts = np.bincount(chunk, minlength=nchunks)
    chunk_ptr = np.concatenate([[0], np.cumsum(counts)])
    entry = np.stack([ulo[u_of], uhi[u_of], np.arange(nslots)],
                     axis=1)[order]
    col = np.zeros((nseg, 2), np.int64)
    col[full, 0] = first[inv]
    col[full, 1] = nch[inv]
    table = np.concatenate([chunk_ptr, entry.reshape(-1), col.reshape(-1)])
    cmax = int(min(MAX_ENTRIES, max(1, counts.max(initial=0))))
    return IntervalTable(table.astype(np.int32), len(entry), cmax)


def invalid(what):
    """The error of a failed host check of the checked build."""
    return RuntimeError(f"checked build: {what}")


def validate_table(tab: IntervalTable, n: int, chunk: int, nseg: int):
    """Raise unless ``tab`` is a well-formed interval table of ``nseg``
    columns over ``n`` wavenumbers in chunks of ``chunk``: chunk pointers
    from 0, non-decreasing, to ``nentries``; each entry's lo <= hi within
    [0, n - 1], meeting its chunk, its slot < nentries; each column's slots
    within [0, nentries]; the length of all of it."""
    t = np.asarray(tab.table, np.int64)
    nchunks = -(-n // chunk)
    ne = tab.nentries
    if len(t) != nchunks + 1 + 3 * ne + 2 * nseg:
        raise invalid(f"table of {len(t)} ints; {nchunks} chunks, {ne} "
                       f"entries and {nseg} columns need "
                       f"{nchunks + 1 + 3 * ne + 2 * nseg}")
    ptr = t[:nchunks + 1]
    if ptr[0] != 0 or ptr[-1] != ne or np.any(np.diff(ptr) < 0):
        raise invalid("chunk pointers not non-decreasing from 0 to the "
                       f"{ne} entries")
    entry = t[nchunks + 1:nchunks + 1 + 3 * ne].reshape(-1, 3)
    c = np.repeat(np.arange(nchunks), np.diff(ptr))
    lo, hi, slot = entry.T
    bad = ((lo < 0) | (hi < lo) | (hi > n - 1) | (slot < 0) | (slot >= ne)
           | (lo > (c + 1) * chunk - 1) | (hi < c * chunk))
    if np.any(bad):
        k = int(np.argmax(bad))
        raise invalid(f"entry {k} (lo {lo[k]}, hi {hi[k]}, slot "
                       f"{slot[k]}) of chunk {c[k]} out of range")
    first, count = t[nchunks + 1 + 3 * ne:].reshape(-1, 2).T
    bad = (first < 0) | (count < 0) | (first + count > ne)
    if np.any(bad):
        k = int(np.argmax(bad))
        raise invalid(f"column {k}: slots {first[k]} + {count[k]} outside "
                       f"the {ne} entries")


class _Bounds:
    """Device bounds, the version counts they were seen at, their host
    copy and their tables by ``(n, chunk)``; holding the tensors keeps
    their ids and addresses from being reused while the entry lives."""

    def __init__(self, i1, i2, host):
        self.i1, self.i2, self.host = i1, i2, host
        self.versions = _state(i1, i2)
        self.tables = {}


def _state(i1, i2):
    """What a kept table is taken for: the bounds' version counts, their
    storage and their length (``.data`` assignment changes the last two
    without counting a version)."""
    return (i1._version, i2._version, i1.data_ptr(), i2.data_ptr(),
            i1.numel(), i2.numel())


_BOUNDS: "OrderedDict[int, _Bounds]" = OrderedDict()
# A sharded probe uploads its bounds once a shard, global and shifted
_BOUNDS_KEPT = 32


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


def device_table(i1, i2, n: int, dev, chunk: int = CHUNK):
    """``(table on dev, IntervalTable)`` of the device bounds ``i1``,
    ``i2`` in chunks of ``chunk``: from the entry of these very tensors
    while neither was written to since, else built from their values read
    back once."""
    entry = _BOUNDS.get(id(i1))
    if (entry is None or entry.i1 is not i1 or entry.i2 is not i2
            or entry.versions != _state(i1, i2)):
        entry = _remember(i1, i2, None)
    else:
        _BOUNDS.move_to_end(id(i1))
    checked = _build.checked_mode()
    if checked and entry.host is not None:
        now = (i1.cpu().numpy(), i2.cpu().numpy())
        if not all(np.array_equal(a, b) for a, b in zip(now, entry.host)):
            raise invalid("the bounds were written without counting a "
                           "version (.data, an alias or a raw pointer) "
                           "since their interval table was kept")
    key = (n, chunk)
    if key not in entry.tables:
        if entry.host is None:
            entry.host = (i1.cpu().numpy(), i2.cpu().numpy())
        tab = interval_table(*entry.host, n, chunk)
        if checked:
            validate_table(tab, n, chunk, i1.shape[0])
        entry.tables[key] = (torch.from_numpy(tab.table).to(dev), tab)
    elif checked:
        validate_table(entry.tables[key][1], n, chunk, i1.shape[0])
    return entry.tables[key]


def check_buffers(kernel, table_d, tab, nseg, nrows, partial, out):
    """The checked build's host check of a launch: the device table is
    the validated one, the partials hold ``nrows`` rows of every entry's
    slot and the output ``nrows`` rows of ``nseg`` columns."""
    if table_d.numel() != len(tab.table) or table_d.dtype != torch.int32:
        raise invalid(f"{kernel}: device table of {table_d.numel()} "
                       f"{table_d.dtype}, host table of {len(tab.table)}")
    if partial.numel() < nrows * tab.nentries:
        raise invalid(f"{kernel}: {partial.numel()} partials for {nrows} "
                       f"rows of {tab.nentries} slots")
    if tuple(out.shape) != (nrows, nseg) or not out.is_contiguous():
        raise invalid(f"{kernel}: output {tuple(out.shape)} for "
                       f"({nrows}, {nseg})")


def check_library(lib):
    """Raise unless the library's chunk is this module's."""
    if lib.ecckd_stream_chunk_size() != CHUNK:
        raise RuntimeError("interval sums: the library's chunk differs "
                           "from interval_stream.py's")


def check_tensor(kernel, name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and
    ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def launch_sweep(kernel, entry, operands, i1, i2, nrows, nlay, extra=(),
                 strip=None):
    """Launch the sweep K1, K2 or E1, entry point ``entry`` + ``_f64`` or
    ``_f32``, on the current stream: the tensors ``operands`` (checked by
    the caller), the interval table of ``i1``, ``i2`` at ``strip``
    wavenumbers (by default the library's ``ecckd_sweep_strip_size``: 128
    in float64, 256 in float32), the partials and the (nrows, nseg)
    output, the counts, then ``extra``.  The first operand's last axis is the wavenumbers'.
    Returns the output."""
    first = operands[0]
    dtype, dev = first.dtype, first.device
    n, nseg = first.shape[-1], i1.shape[0]
    lib = _build.library()
    fn = getattr(lib, entry + ("_f64" if dtype == torch.float64 else "_f32"))
    if strip is None:
        strip = lib.ecckd_sweep_strip_size(first.element_size())
    with torch.cuda.device(dev):
        table_d, tab = device_table(i1, i2, n, dev, strip)
        out = torch.empty((nrows, nseg), dtype=dtype, device=dev)
        partial = torch.empty(max(1, tab.nentries * nrows), dtype=dtype,
                              device=dev)
        if _build.checked_mode():
            check_buffers(kernel, table_d, tab, nseg, nrows, partial, out)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in operands), table_d.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), nlay, n, nseg,
                 tab.nentries, *extra, stream)
    _build.check(err, kernel)
    return out

