"""The checked build's host side, and the safety of the two table caches.

The checked build (``ecckd_tpu_torch.ops.kernels._build``: a second
library with ``-DECCKD_CHECKED=1``, its kernels' index checks trapping) is
selected by an argument or by ``_build.checked()``, never by the
environment; inside that context the wrappers validate every interval
table and row table before use and the buffers they hand a kernel.  The
card runs of the checked build are in tests/test_torch_kernels.py
(``test_checked_build``) and chip_smoke.py.

The caches: ``interval_stream.device_table`` keeps a table per bound
tensors while their version count, storage and length are unchanged, so a
write through ``out=`` or a ``.data`` assignment gives a new table.  A
write that counts no version (through ``.data``, a numpy alias) keeps the
old table, whose indices still fit the buffers of the launch; the checked
build reads the bounds back and refuses it.  ``interval_sum.row_table``
keys on everything its descriptors depend on, so a kept table is right
for any operands that match its key.
"""

import threading

import numpy as np
import pytest
import torch

from ecckd_tpu_torch.ops.kernels import _build
from ecckd_tpu_torch.ops.kernels.interval_stream import (CHUNK,
                                                         IntervalTable,
                                                         check_buffers,
                                                         device_bounds,
                                                         device_table,
                                                         interval_table,
                                                         validate_table)
from ecckd_tpu_torch.ops.kernels.interval_sum import (row_table,
                                                      rows_from_table,
                                                      validate_row_table)
from ecckd_tpu_torch.ops.segments import fused_groups, part_of

N = 10000
I1, I2 = [0, 0, 5, 4000], [0, 4, 3999, 9999]


def test_checked_selected_by_context_not_environment(monkeypatch):
    """Off by default and after the block, on inside it and in nested
    blocks, per thread; no environment variable turns it on."""
    monkeypatch.setenv("ECCKD_CHECKED", "1")
    assert not _build.checked_mode()
    seen = []
    with _build.checked():
        with _build.checked():
            assert _build.checked_mode()
        assert _build.checked_mode()
        t = threading.Thread(target=lambda: seen.append(
            _build.checked_mode()))
        t.start()
        t.join()
    assert seen == [False]
    assert not _build.checked_mode()


def test_checked_library_is_its_own_build():
    """Another library name from the same sources, with the checks'
    define and line info; the normal flags carry neither."""
    normal, checked = _build._target(False), _build._target(True)
    assert normal != checked and "checked" in checked.name
    assert normal.parent == checked.parent == _build.BUILD_DIR
    assert "-DECCKD_CHECKED=1" in _build._flags(True)
    assert "-lineinfo" in _build._flags(True)
    assert not any("CHECKED" in f or f == "-lineinfo"
                   for f in _build._flags(False))
    assert "checked.cuh" in _build.HEADERS
    assert not (_build.CSRC / "interval_reduce.cuh").exists()
    for name in _build.SOURCES + _build.HEADERS:
        assert "interval_reduce" not in (_build.CSRC / name).read_text()


@pytest.mark.parametrize("chunk", [CHUNK, 128, 16])
def test_interval_tables_validate(chunk):
    for i1, i2 in ((I1, I2), ([-40, 9990, 0, -7], [10, 20000, 9999, -1]),
                   (list(range(80)), list(range(80)))):
        validate_table(interval_table(i1, i2, N, chunk), N, chunk, len(i1))


def _corrupt(kind):
    tab = interval_table(I1, I2, N, 128)
    t = tab.table.copy()
    nchunks = -(-N // 128)
    ent = nchunks + 1
    if kind == "pointer":
        t[3] = t[4] + 1                 # decreasing chunk pointers
    elif kind == "slot":
        t[ent + 2] = tab.nentries       # a slot past the partials
    elif kind == "bounds":
        t[ent], t[ent + 1] = 50, 10     # lo > hi
    elif kind == "outside":
        t[ent + 1] = N                  # hi past n - 1
    elif kind == "chunk":
        t[ent] = t[ent + 1] = N - 1     # an entry that misses its chunk
    elif kind == "column":
        t[-1] = tab.nentries            # a column's slots past the end
    elif kind == "length":
        t = t[:-2]
    return IntervalTable(t, tab.nentries, tab.cmax)


@pytest.mark.parametrize("kind", ["pointer", "slot", "bounds", "outside",
                                  "chunk", "column", "length"])
def test_corrupt_interval_tables_raise(kind):
    with pytest.raises(RuntimeError, match="checked build"):
        validate_table(_corrupt(kind), N, 128, len(I1))


def test_interval_table_cache_sees_out_writes():
    """A write through ``out=`` counts a version: the table is built anew
    from the new values."""
    i1, i2 = device_bounds(I1, I2, "cpu")
    first = device_table(i1, i2, N, i1.device)
    torch.add(i2, 1000, out=i2)          # every bound moves, in place
    changed = device_table(i1, i2, N, i1.device)
    assert changed is not first
    want = interval_table(I1, np.minimum(np.add(I2, 1000), N - 1), N)
    assert np.array_equal(changed[1].table, want.table)


def test_interval_table_cache_sees_data_assignment():
    """``.data`` assignment swaps the storage and the length without
    counting a version; the kept table is not taken for the new tensor,
    so a launch never reads a column section of another length."""
    i1, i2 = device_bounds(I1, I2, "cpu")
    first = device_table(i1, i2, N, i1.device)
    version = (i1._version, i2._version)
    i1.data = torch.tensor([0, 10, 20, 30, 40], dtype=torch.int32)
    i2.data = torch.tensor([9, 19, 29, 39, 9999], dtype=torch.int32)
    assert (i1._version, i2._version) == version
    table_d, tab = device_table(i1, i2, N, i1.device)
    assert tab is not first[1]
    validate_table(tab, N, CHUNK, 5)
    assert np.array_equal(tab.table, interval_table(
        [0, 10, 20, 30, 40], [9, 19, 29, 39, 9999], N).table)


def test_hidden_writes_keep_the_table_and_the_checked_build_refuses():
    """A write through ``.data`` or a numpy alias counts no version: the
    normal path keeps the table of the old values (within the buffers it
    sizes for the same length), the checked path reads the bounds back
    and raises."""
    i1, i2 = device_bounds(I1, I2, "cpu")
    first = device_table(i1, i2, N, i1.device)
    i2.data[1] = 9                       # no version counted
    assert device_table(i1, i2, N, i1.device) is first
    validate_table(first[1], N, CHUNK, len(I1))
    with _build.checked():
        with pytest.raises(RuntimeError, match="without counting"):
            device_table(i1, i2, N, i1.device)
    i2.numpy()[1] = 4                    # back to the values of the table
    with _build.checked():
        assert device_table(i1, i2, N, i1.device) is first


def test_check_buffers():
    tab = interval_table(I1, I2, N, 128)
    table_d = torch.from_numpy(tab.table)
    out = torch.empty(6, len(I1), dtype=torch.float64)
    check_buffers("k", table_d, tab, len(I1), 6,
                  torch.empty(6 * tab.nentries), out)
    with pytest.raises(RuntimeError, match="partials"):
        check_buffers("k", table_d, tab, len(I1), 6,
                      torch.empty(6 * tab.nentries - 1), out)
    with pytest.raises(RuntimeError, match="output"):
        check_buffers("k", table_d, tab, len(I1) + 1, 6,
                      torch.empty(6 * tab.nentries), out)
    with pytest.raises(RuntimeError, match="device table"):
        check_buffers("k", table_d[:-1], tab, len(I1), 6,
                      torch.empty(6 * tab.nentries), out)


def test_row_table_is_a_function_of_its_key():
    """Two tensor objects over the same storage, shape and dtype share a
    table, which rebuilds the rows of the one now used; the same address
    read as another dtype, or another length, gets its own table."""
    buf = torch.arange(800, dtype=torch.float64)
    v = torch.full((100,), 2.0, dtype=torch.float64)
    a = buf[:300].view(3, 100)
    first = row_table(*fused_groups([part_of(a, v)], 100), 100)
    b = buf[:300].view(3, 100)           # another tensor, same storage
    again = row_table(*fused_groups([part_of(b, v)], 100), 100)
    assert again is first
    meta, unique = fused_groups([part_of(b, v)], 100)
    assert torch.equal(rows_from_table(again, unique, 100), b * v)
    validate_row_table(again, unique, 100, 3)
    as_long = buf.view(torch.int64)[:300].view(3, 100)
    other = row_table(*fused_groups([part_of(as_long)], 100), 100)
    assert other is not first
    longer = buf[:400].view(4, 100)
    assert row_table(*fused_groups([part_of(longer, v)], 100),
                     100) is not first


def test_row_table_validation_refuses_foreign_rows():
    """A descriptor must name the start of a whole operand row, and its
    further operands must lie in the list."""
    a = torch.ones(3, 100, dtype=torch.float64)
    v = torch.ones(100, dtype=torch.float64)
    w = torch.ones(3, 100, dtype=torch.float64)
    meta, unique = fused_groups([part_of(a, v, w)], 100)
    table = row_table(meta, unique, 100)
    validate_row_table(table, unique, 100, 3)
    with pytest.raises(RuntimeError, match="rows"):
        validate_row_table(table, unique, 100, 4)
    # the table's operands, without one of them
    with pytest.raises(RuntimeError, match="no row of an operand"):
        validate_row_table(table, unique[:2], 100, 3)
    shifted = table._replace(desc=table.desc + np.array([8, 0, 0]))
    with pytest.raises(RuntimeError, match="no row of an operand"):
        validate_row_table(shifted, unique, 100, 3)
    short = table._replace(extra=table.extra[:1],
                           extra_d=table.extra_d[:2])
    with pytest.raises(RuntimeError, match="further operands"):
        validate_row_table(short, unique, 100, 3)
