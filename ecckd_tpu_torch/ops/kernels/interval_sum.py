"""Kernel K3: fused multi-row interval sums.

Wrapper of ``csrc/interval_sum.cu`` (CUDA C++ for sm_90a), which replaces
the Pallas TPU kernel ``ecckd_tpu/ops/segments.py:_isum_pallas_kernel``.
For tensors on the CPU the wrapper runs the plain version
:func:`ecckd_tpu_torch.ops.segments.interval_sum_fused`; for CUDA tensors
it launches the kernel or raises.

The kernel reads one descriptor per output row (:func:`row_table`): the
addresses of the operand rows whose product the row is.  The table depends
only on the operands' addresses, shapes and dtype and on the parts'
structure, so it is built and uploaded once per parts list and kept.  The
key holds all of that, so a kept table is right for any operands that
match it, whatever became of those it was built for.  A launch adds the
interval table of its bounds (:mod:`.interval_stream`), kept per bound
tensors.  Inside ``_build.checked()`` the row table is validated against
the operands at every launch.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..segments import fused_groups, interval_sum_fused
from . import _build
from .interval_stream import (check_buffers, check_library, device_table,
                              invalid)


class RowTable(NamedTuple):
    """``desc`` is (rows, 3) int64 per output row: the addresses of its
    first two operand rows (0 for none) and ``extra_at | nextra << 32``,
    its further operand rows' addresses in ``extra``; ``desc_d`` and
    ``extra_d`` are the same on the device."""
    desc: np.ndarray
    extra: np.ndarray
    desc_d: torch.Tensor
    extra_d: torch.Tensor


_ROW_TABLES: "OrderedDict[tuple, RowTable]" = OrderedDict()
# Every shard of a sharded kernel has row tables of its own
_ROW_TABLES_KEPT = 32


def _operand_device(parts, i1):
    for p in parts:
        for a in getattr(p, "arrays", ()):
            return a.device
    return i1.device


def row_table(meta, unique, n: int) -> RowTable:
    """The descriptor table of ``fused_groups``' ``(meta, unique)``, from
    the cache when the same operands (addresses, shapes, dtype, device)
    form the same parts."""
    key = (n, meta, tuple((a.data_ptr(), tuple(a.shape), a.dtype, a.device)
                          for a in unique))
    hit = _ROW_TABLES.get(key)
    if hit is not None:
        _ROW_TABLES.move_to_end(key)
        return hit
    desc = []
    extra = []
    for idxs, rows in meta:
        for j in range(rows):
            addr = [unique[k].data_ptr() + (0 if unique[k].shape[0] == 1
                                            else j * n)
                    * unique[k].element_size() for k in idxs]
            word = len(extra) | (len(addr[2:]) << 32)
            extra.extend(addr[2:])
            desc.append((addr[0], addr[1] if len(addr) > 1 else 0, word))
    desc = np.asarray(desc, np.int64).reshape(-1, 3)
    extra = np.asarray(extra, np.int64)
    dev = unique[0].device
    table = RowTable(desc, extra, torch.from_numpy(desc).to(dev),
                     torch.from_numpy(np.r_[extra, 0]).to(dev))
    _ROW_TABLES[key] = table
    while len(_ROW_TABLES) > _ROW_TABLES_KEPT:
        _ROW_TABLES.popitem(last=False)
    return table


def validate_row_table(table: RowTable, unique, n: int, nrows: int):
    """Raise unless ``table`` has ``nrows`` descriptors whose every operand
    address is the start of a whole row of one of ``unique`` (the only
    row of a broadcast operand), with its further operands inside
    ``extra``, and the device copies are the host arrays' sizes."""
    spans = [(a.data_ptr(), a.numel() * a.element_size(),
              n * a.element_size()) for a in unique]

    def row_ok(addr):
        for start, size, row in spans:
            off = int(addr) - start
            if 0 <= off and off + row <= size and off % row == 0:
                return True
        return False

    desc, extra = table.desc, table.extra
    if desc.shape != (nrows, 3) or table.desc_d.numel() != 3 * nrows:
        raise invalid(f"interval_sum: {desc.shape} descriptors for {nrows} "
                      "rows")
    if table.extra_d.numel() != len(extra) + 1:
        raise invalid("interval_sum: device list of further operands of "
                      f"{table.extra_d.numel()}, host list of {len(extra)}")
    for r, (a, b, word) in enumerate(desc):
        at, count = int(word) & 0xFFFFFFFF, int(word) >> 32
        if at + count > len(extra):
            raise invalid(f"interval_sum: row {r} takes further operands "
                          f"{at} .. {at + count - 1} of {len(extra)}")
        for addr in [a] + ([b] if b else []) + list(extra[at:at + count]):
            if not row_ok(addr):
                raise invalid(f"interval_sum: row {r} reads {int(addr):#x}, "
                              "no row of an operand")


def rows_from_table(table: RowTable, unique, n: int):
    """Plain reading of a row table: the (rows, n) products it describes,
    each address mapped back to a row of the operands ``unique``."""
    def row_at(addr):
        for a in unique:
            es = a.element_size()
            off = int(addr) - a.data_ptr()
            if 0 <= off < a.numel() * es:
                return a.reshape(-1)[off // es:off // es + n]
        raise ValueError(f"address {addr:#x} is in no operand")

    out = []
    for a_addr, b_addr, word in table.desc:
        at, count = int(word) & 0xFFFFFFFF, int(word) >> 32
        v = row_at(a_addr)
        for addr in ([b_addr] if b_addr else []) + list(
                table.extra[at:at + count]):
            v = v * row_at(addr)
        out.append(v)
    return torch.stack(out)


def fused_interval_sum(parts, n: int, i1, i2, dtype=None):
    """Stacked sums of ``parts`` over inclusive [i1, i2]: (sum rows, nseg).

    On the card every part must be a :func:`~ecckd_tpu_torch.ops.segments.
    part_of` product of contiguous (rows, n) or (n,) tensors of one float
    dtype.
    """
    dev = _operand_device(parts, i1)
    if dev.type == "cpu":
        return interval_sum_fused(parts, n, i1, i2, dtype=dtype)
    if dev.type != "cuda":
        raise ValueError(f"interval_sum: no kernel for device {dev}")
    grouped = fused_groups(parts, n)
    if grouped is None:
        raise ValueError("interval_sum: the kernel takes part_of products "
                         f"of (rows, {n}) or ({n},) tensors only")
    meta, unique = grouped
    if dtype is None:
        dtype = unique[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"interval_sum: unsupported dtype {dtype}")
    for k, a in enumerate(unique):
        if a.device != dev or a.dtype != dtype or not a.is_contiguous():
            raise ValueError(
                f"interval_sum: operand {k} is {a.dtype} on {a.device} "
                f"(contiguous={a.is_contiguous()}); expected contiguous "
                f"{dtype} on {dev}")
    for idxs, rows in meta:
        if any(unique[k].shape[0] not in (1, rows) for k in idxs):
            raise ValueError("interval_sum: the operands of a part must "
                             f"have {rows} rows or 1")
    nseg = i1.shape[0]
    for name, b in (("i1", i1), ("i2", i2)):
        if (b.device != dev or b.dtype != torch.int32 or b.ndim != 1
                or b.shape[0] != nseg or not b.is_contiguous()):
            raise ValueError(f"interval_sum: {name} must be a contiguous "
                             f"int32 ({nseg},) tensor on {dev}")
    rows = row_table(meta, unique, n)
    nrows = rows.desc.shape[0]
    checked = _build.checked_mode()
    if checked:
        validate_row_table(rows, unique, n, sum(r for _, r in meta))
    lib = _build.library()
    check_library(lib)
    with torch.cuda.device(dev):
        table_d, tab = device_table(i1, i2, n, dev)
        out = torch.empty((nrows, nseg), dtype=dtype, device=dev)
        partial = torch.empty(max(1, tab.nentries * nrows), dtype=dtype,
                              device=dev)
        if checked:
            check_buffers("interval_sum", table_d, tab, nseg, nrows, partial,
                          out)
        fn = (lib.ecckd_interval_sum_f64 if dtype == torch.float64
              else lib.ecckd_interval_sum_f32)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.desc_d.data_ptr(), rows.extra_d.data_ptr(),
                 table_d.data_ptr(), partial.data_ptr(), out.data_ptr(),
                 nrows, n, nseg, tab.nentries, tab.cmax, len(rows.extra),
                 stream)
    _build.check(err, "interval_sum")
    fused_interval_sum.launches += 1
    return out


fused_interval_sum.launches = 0
