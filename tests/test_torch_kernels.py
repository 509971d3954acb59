"""Kernels K1 (LW sweep), K2 (SW sweep), K3 (fused interval sum), E1 (LW
sweep by scans across layers) and E2 (fused LW fit and truth sums) of
ecckd_tpu_torch, and the device default of the array cores.

This file imports no jax, so its card tests run on a machine without it:
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
Without a card those tests skip; the CPU tests check the wrappers' plain
path and the tables they hand to the kernels.  On the card each kernel is
held against its plain version, normwise per output row: rtol 1e-10 in
float64 and 1e-5 in float32 (the kernels sum in another order than the
membership matmuls).
"""

import numpy as np
import pytest
import torch

from ecckd_tpu_torch.ops.average import (fit_parts_lw, fit_parts_sw,
                                         total_trans_fit_parts)
from ecckd_tpu_torch.ops.kernels import _build
from ecckd_tpu_torch.ops.kernels import (fused_interval_sum,
                                         fused_sums_lw_intervals,
                                         fused_sums_lw_plain,
                                         reset_launch_counts,
                                         sweep_lw_intervals, sweep_lw_plain,
                                         sweep_lw_scan_intervals,
                                         sweep_lw_scan_plain,
                                         sweep_sw_intervals, sweep_sw_plain)
from ecckd_tpu_torch.ops.kernels.interval_stream import (CHUNK,
                                                         MAX_ENTRIES,
                                                         device_bounds,
                                                         device_table,
                                                         interval_table)
from ecckd_tpu_torch.ops.kernels.interval_sum import (row_table,
                                                      rows_from_table)
from ecckd_tpu_torch.ops.segments import (fused_groups, interval_sum_fused,
                                          part_of)

RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(nlay, nwav, i1, i2, seed, seg_outside=0):
    """Sweep operands with the partition map costs() derives from i1."""
    rng = np.random.default_rng(seed)
    i1 = np.asarray(i1, np.int32)
    i2 = np.asarray(i2, np.int32)
    planck = np.abs(rng.normal(5, 1, (nlay + 1, nwav)))
    bg_od = rng.gamma(0.5, 0.4, (nlay, nwav))
    od_fit = rng.gamma(0.5, 0.4, (nlay, len(i1)))
    emis = rng.uniform(0.9, 1.0, nwav)
    surfp = np.abs(rng.normal(8, 1, nwav))
    seg = np.maximum(0, np.searchsorted(i1, np.arange(nwav), side="right")
                     - 1).astype(np.int32)
    if seg_outside:
        seg[-seg_outside:] = -1
    return planck, bg_od, od_fit, seg, emis, surfp, i1, i2


def _to(arrays, device, dtype):
    return tuple(torch.as_tensor(a, device=device,
                                 dtype=dtype if a.dtype == np.float64
                                 else torch.int32).contiguous()
                 for a in arrays)


def _row_err(got, want):
    """Largest normwise relative error over the output rows (absolute for
    an all-zero row, such as the downward flux at the top)."""
    num = (got - want).double().norm(dim=1)
    den = want.double().norm(dim=1)
    return float(torch.where(den > 0, num / den.clamp(min=1e-300), num).max())


def _fit_parts(planck, bg_od, emis):
    # The LW transmission-fit layout: a product part, a part sharing its
    # operand, a 1-row broadcast operand
    w = planck[1:]
    return [part_of(bg_od, w), part_of(w), part_of(bg_od), part_of(emis)]


def _sw_args(args, with_up=True):
    """K2's arguments from the sweep operands of :func:`_inputs`: ssi from
    the surface Planck row, albedo from the emissivity."""
    planck, bg_od, od_fit, seg, emis, surfp, i1, i2 = args
    return (surfp, bg_od, od_fit, seg, i1, i2, 0.5,
            (1.0 - emis) if with_up else 0.0, with_up)


def test_cpu_tensors_take_plain_path():
    reset_launch_counts()
    args = _to(_inputs(6, 700, [0, 300], [299, 699], seed=9), "cpu",
               torch.float64)
    for g, w in zip(sweep_lw_intervals(*args), sweep_lw_plain(*args)):
        assert torch.equal(g, w)
    for with_up in (True, False):
        sw = _sw_args(args, with_up)
        for g, w in zip(sweep_sw_intervals(*sw), sweep_sw_plain(*sw)):
            assert torch.equal(g, w)
    parts = _fit_parts(args[0], args[1], args[4])
    assert torch.equal(fused_interval_sum(parts, 700, args[6], args[7]),
                       interval_sum_fused(parts, 700, args[6], args[7]))
    assert sweep_lw_intervals.launches == 0
    assert sweep_sw_intervals.launches == 0
    assert fused_interval_sum.launches == 0


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA card has no kernel: the
    wrappers raise instead of computing somewhere else."""
    args = _to(_inputs(4, 300, [0], [299], seed=2), "meta", torch.float64)
    with pytest.raises(ValueError, match="no kernel"):
        sweep_lw_intervals(*args)
    with pytest.raises(ValueError, match="no kernel"):
        sweep_sw_intervals(*_sw_args(args))
    with pytest.raises(ValueError, match="no kernel"):
        fused_interval_sum([part_of(args[1])], 300, args[6], args[7])


def test_groups_dedup_and_row_table():
    """An operand used by several parts is deduplicated; the kernel's row
    table gives each output row the addresses of its operand rows (a
    broadcast operand's only row), further operands in a list."""
    w = torch.ones(4, 64, dtype=torch.float64)
    m = torch.ones(4, 64, dtype=torch.float64)
    v = torch.ones(64, dtype=torch.float64)
    meta, unique = fused_groups([part_of(m, w), part_of(w), part_of(v, w),
                                 part_of(m, w, v)], 64)
    assert len(unique) == 3
    assert meta == (((0, 1), 4), ((1,), 4), ((2, 1), 4), ((0, 1, 2), 4))
    t = row_table(meta, unique, 64)
    assert t.desc.shape == (16, 3)
    row = lambda a, j: a.data_ptr() + 8 * 64 * j
    for j in range(4):
        assert tuple(t.desc[j]) == (row(m, j), row(w, j), 0)
        assert tuple(t.desc[4 + j]) == (row(w, j), 0, 0)
        assert tuple(t.desc[8 + j]) == (v.data_ptr(), row(w, j), 0)
        assert tuple(t.desc[12 + j]) == (row(m, j), row(w, j),
                                         j | (1 << 32))
    assert t.extra.tolist() == [v.data_ptr()] * 4
    assert fused_groups([lambda s, n: None], 64) is None


def _table_parts(kind, n, rng):
    """Parts of the candidate costs' K3 launches (LW transmission and
    logarithmic fits with the truth rows, SW linear and
    total-transmission fits with two truth sets, as ops/average.py and
    partition/cost_kernel.py build them), a 3-operand part and a part of
    (n,) operands only, from seeded data."""
    nlay = 5
    f = lambda *shape: torch.from_numpy(rng.uniform(0.5, 2.0, shape))
    planck, metric, hr = f(nlay + 1, n), f(nlay, n), f(nlay, n)
    ssi, fd, fu = f(n), f(n), f(n)
    metric[:, ::7] = 0.0        # zeros for the logarithmic fit's mask
    if kind in ("lw_transmission", "lw_logarithmic"):
        return fit_parts_lw(kind[3:], planck, metric)[0] + [
            part_of(hr), part_of(fd), part_of(fu)]
    if kind == "sw_linear":
        return fit_parts_sw("linear", ssi, metric)[0]
    if kind == "sw_total_transmission":
        truth = [p for _ in range(2) for p in (part_of(f(nlay, n)),
                                               part_of(f(n)), part_of(f(n)))]
        return total_trans_fit_parts(ssi, f(nlay, n), metric)[0] + truth
    if kind == "three_operands":
        return [part_of(metric, hr, ssi), part_of(ssi, metric, planck[1:])]
    return [part_of(ssi, fd), part_of(fd, fu, ssi), part_of(fu)]


@pytest.mark.parametrize("kind", ["lw_transmission", "lw_logarithmic",
                                  "sw_linear", "sw_total_transmission",
                                  "three_operands", "vectors_only"])
def test_row_table_rebuilds_the_rows(kind):
    """The rows the kernel reads through its row table are exactly those
    interval_sum_fused forms from the parts."""
    n = 301
    parts = _table_parts(kind, n, np.random.default_rng(len(kind)))
    meta, unique = fused_groups(parts, n)
    want = torch.cat([p(0, n) for p in parts])
    got = rows_from_table(row_table(meta, unique, n), unique, n)
    assert got.shape == want.shape
    assert torch.equal(got, want)


def test_row_table_cache():
    """The same operands forming the same parts give the same table
    object; a new tensor, or the same shape at another address, a new
    one."""
    a = torch.ones(3, 100, dtype=torch.float64)
    b = torch.ones(100, dtype=torch.float64)
    first = row_table(*fused_groups([part_of(a, b), part_of(b)], 100), 100)
    again = row_table(*fused_groups([part_of(a, b), part_of(b)], 100), 100)
    assert again is first
    c = a.clone()
    other = row_table(*fused_groups([part_of(c, b), part_of(b)], 100), 100)
    assert other is not first
    assert other.desc[0, 0] == c.data_ptr() != first.desc[0, 0]
    moved = torch.ones(2, 3, 100, dtype=torch.float64)[1]
    assert row_table(*fused_groups([part_of(moved, b), part_of(b)], 100),
                     100) is not first
    assert row_table(*fused_groups([part_of(b), part_of(a, b)], 100),
                     100) is not first


def _sums_from_table(rows, tab, n, nseg, chunk=CHUNK):
    """Plain reading of an interval table: per entry, the row sums over the
    entry's interval within its chunk into its slot; per column, its slots
    added in order."""
    nchunks = -(-n // chunk)
    t = tab.table
    chunk_ptr = t[:nchunks + 1]
    entry = t[nchunks + 1:nchunks + 1 + 3 * tab.nentries].reshape(-1, 3)
    col = t[nchunks + 1 + 3 * tab.nentries:].reshape(-1, 2)
    assert len(col) == nseg and chunk_ptr[-1] == tab.nentries
    slots = torch.full((tab.nentries, rows.shape[0]), float("nan"),
                       dtype=rows.dtype)
    for c in range(nchunks):
        for lo, hi, slot in entry[chunk_ptr[c]:chunk_ptr[c + 1]]:
            a, b = max(lo, c * chunk), min(hi, (c + 1) * chunk - 1)
            assert a <= b
            slots[slot] = rows[:, a:b + 1].sum(dim=1)
    out = torch.zeros((rows.shape[0], nseg), dtype=rows.dtype)
    for j, (first, count) in enumerate(col):
        for k in range(first, first + count):
            out[:, j] += slots[k]
    return out


_TABLE_LAYOUTS = [
    # front-padded [0, 0] bucket columns, a shared boundary index
    ([0, 0, 0, 0, 100, 2047, 5000], [0, 0, 0, 99, 2047, 4999, 9999]),
    # repeats out of order, overlaps, an empty and a reversed interval
    ([5000, 0, 5000, 3, 700, 9000], [6000, 9999, 6000, 2, 699, 9100]),
    # bounds outside [0, n - 1], clamped; one interval over every chunk
    ([-40, 9990, 0, -7], [10, 20000, 9999, -1]),
    # more intervals in one chunk than a block takes per pass
    (list(range(0, 80)), list(range(0, 80))),
]


@pytest.mark.parametrize("i1,i2", _TABLE_LAYOUTS)
def test_interval_table_layout(i1, i2):
    """The interval table (each distinct clamped interval once, a slot
    per interval and chunk, a column gather) gives every column its own
    interval's sums, in the original order, for pads, repeats, shared
    boundary indices, empty and clamped intervals."""
    n = 10000
    rows = torch.from_numpy(np.random.default_rng(4).integers(
        -50, 50, (3, n)).astype(np.float64))
    tab = interval_table(i1, i2, n)
    lo = np.maximum(np.asarray(i1), 0)
    hi = np.minimum(np.asarray(i2), n - 1)
    distinct = {(a, b) for a, b in zip(lo, hi) if a <= b}
    assert tab.nentries == sum(b // CHUNK - a // CHUNK + 1
                             for a, b in distinct)
    got = _sums_from_table(rows, tab, n, len(i1))
    want = interval_sum_fused([part_of(rows)], n,
                              torch.tensor(i1, dtype=torch.int32),
                              torch.tensor(i2, dtype=torch.int32))
    assert torch.equal(got, want)    # integer-valued: exact in any order
    assert 1 <= tab.cmax <= MAX_ENTRIES


# The sweeps' strips in float64 and float32 (ecckd_sweep_strip_size(8)
# and (4) of the library)
STRIPS = (128, 256)
STRIP = 256


@pytest.mark.parametrize("i1,i2", _TABLE_LAYOUTS + [
    # single-wavenumber intervals, 40 of them in one strip, beside a long
    # one over every strip
    (list(range(300, 340)) + [0], list(range(300, 340)) + [9999]),
    # the main path's equipartition-like layout (built in the test)
    ("cube", "cube"),
])
@pytest.mark.parametrize("strip", STRIPS)
def test_strip_table_layout(i1, i2, strip):
    """The sweeps' interval table, at strip granularity: every column gets
    its own interval's sums in the original order, with any number of
    entries in one strip and one slot per (interval, strip)."""
    n = 10000
    if i1 == "cube":
        i1, i2 = (b.tolist() for b in _cube_bounds(n))
    rows = torch.from_numpy(np.random.default_rng(6).integers(
        -50, 50, (4, n)).astype(np.float64))
    tab = interval_table(i1, i2, n, strip)
    lo = np.maximum(np.asarray(i1), 0)
    hi = np.minimum(np.asarray(i2), n - 1)
    distinct = {(a, b) for a, b in zip(lo, hi) if a <= b}
    assert tab.nentries == sum(b // strip - a // strip + 1
                             for a, b in distinct)
    nstrips = -(-n // strip)
    assert len(tab.table) == nstrips + 1 + 3 * tab.nentries + 2 * len(i1)
    got = _sums_from_table(rows, tab, n, len(i1), strip)
    want = interval_sum_fused([part_of(rows)], n,
                              torch.tensor(i1, dtype=torch.int32),
                              torch.tensor(i2, dtype=torch.int32))
    assert torch.equal(got, want)    # integer-valued: exact in any order


def test_interval_table_kept_per_bounds():
    """Bounds uploaded with their host copy, or read back once, keep their
    table while unchanged; a write to them, or other tensors with the
    same values, give a table built anew from the values."""
    i1, i2 = device_bounds([0, 0, 5, 4000], [0, 4, 3999, 9999], "cpu")
    first = device_table(i1, i2, 10000, i1.device)
    assert device_table(i1, i2, 10000, i1.device) is first
    want = interval_table([0, 0, 5, 4000], [0, 4, 3999, 9999], 10000)
    assert np.array_equal(first[1].table, want.table)
    assert torch.equal(first[0], torch.from_numpy(want.table))
    other = device_table(i1.clone(), i2.clone(), 10000, i1.device)
    assert other is not first
    assert np.array_equal(other[1].table, want.table)
    i2[3] = 5000                                    # a write: read again
    changed = device_table(i1, i2, 10000, i1.device)
    assert np.array_equal(changed[1].table, interval_table(
        [0, 0, 5, 4000], [0, 4, 3999, 5000], 10000).table)


def test_interval_table_kept_per_n_and_chunk():
    """One pair of bound tensors keeps a table per (n, chunk): K3's chunks
    and the sweeps' strips side by side, each built once and equal to the
    table built from the values."""
    i1, i2 = device_bounds([0, 0, 5, 4000], [0, 4, 3999, 9999], "cpu")
    sums = device_table(i1, i2, 10000, i1.device)
    strips = device_table(i1, i2, 10000, i1.device, STRIP)
    assert strips is not sums
    assert device_table(i1, i2, 10000, i1.device, STRIP) is strips
    assert device_table(i1, i2, 10000, i1.device, CHUNK) is sums
    for (table_d, tab), chunk in ((sums, CHUNK), (strips, STRIP)):
        want = interval_table([0, 0, 5, 4000], [0, 4, 3999, 9999], 10000,
                              chunk)
        assert np.array_equal(tab.table, want.table)
        assert torch.equal(table_d, torch.from_numpy(want.table))
    other_n = device_table(i1, i2, 9000, i1.device, STRIP)
    assert other_n is not strips
    assert np.array_equal(other_n[1].table, interval_table(
        [0, 0, 5, 4000], [0, 4, 3999, 9999], 9000, STRIP).table)


# Interval layouts of the main path: front-padded [0, 0] bucket columns,
# shared boundary indices, unequal lengths spanning many kernel chunks,
# a ragged last chunk, and padded ranks outside every fit
_CASES = {
    "bucket_padded": dict(nlay=50, nwav=70001,
                          i1=[0, 0, 0, 100, 5000, 20000, 20000, 69999],
                          i2=[0, 0, 99, 4999, 20000, 45000, 69998, 70000]),
    "equal": dict(nlay=15, nwav=4096, i1=np.arange(0, 4096, 256),
                  i2=np.arange(255, 4096, 256)),
    "one_interval": dict(nlay=12, nwav=9999, i1=[0], i2=[9998]),
    "seg_outside": dict(nlay=12, nwav=5000, i1=[0, 1000], i2=[999, 4900],
                        seg_outside=99),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_kernels_match_plain(cuda, case, dtype):
    c = dict(_CASES[case])
    args = _to(_inputs(c.pop("nlay"), c.pop("nwav"), c.pop("i1"),
                       c.pop("i2"), seed=12, **c), cuda, dtype)
    n = args[0].shape[1]
    reset_launch_counts()
    got = sweep_lw_intervals(*args)
    torch.cuda.synchronize()
    assert sweep_lw_intervals.launches == 1
    for g, w in zip(got, sweep_lw_plain(*args)):
        assert _row_err(g, w) <= RTOL[dtype]
    for with_up in (True, False):
        sw = _sw_args(args, with_up)
        got = sweep_sw_intervals(*sw)
        torch.cuda.synchronize()
        for g, w in zip(got, sweep_sw_plain(*sw)):
            assert _row_err(g, w) <= RTOL[dtype]
    assert sweep_sw_intervals.launches == 2
    parts = _fit_parts(args[0], args[1], args[4])
    g = fused_interval_sum(parts, n, args[6], args[7])
    assert fused_interval_sum.launches == 1
    w = interval_sum_fused(parts, n, args[6], args[7])
    assert _row_err(g, w) <= RTOL[dtype]


def _cube_bounds(n, nreal=58, npad=6):
    """Front-padded [0, 0] bucket columns, then intervals whose lengths
    grow as the cube of their index, one pair sharing a boundary index
    (chip_smoke.py's phase-3 layout)."""
    edges = np.round(np.linspace(0.0, 1.0, nreal + 1) ** 3 * n)
    lo, hi = edges[:-1].astype(np.int64), edges[1:].astype(np.int64) - 1
    hi[nreal // 2] = lo[nreal // 2 + 1]
    return np.r_[np.zeros(npad, np.int64), lo], np.r_[np.zeros(npad,
                                                                np.int64), hi]


def _sum_layout(name, n):
    """(i1, i2) of the interval-sum card cases."""
    if name == "nseg_1":
        return [0], [n - 1]
    if name == "nseg_64":
        return _cube_bounds(n)
    if name == "nseg_256":
        edges = np.linspace(0, n, 257).astype(np.int64)
        return edges[:-1], edges[1:] - 1
    if name == "long":         # longer than ten chunks, overlapping
        return [0, 100, 5000], [n - 1, 100 + 12 * CHUNK, 5000 + 11 * CHUNK]
    # outside [0, n - 1]: clamped, or empty
    return [-100, n - 10, -5, n + 3, 7], [500, n + 1000, -1, n + 7, 7]


def _misaligned(a):
    """A copy of ``a`` whose first element is not 16-byte aligned."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    out = buf[1:].view(a.shape)
    out.copy_(a)
    assert out.data_ptr() % 16 != 0
    return out


def _sum_parts(kind, args):
    """K3 parts on the sweep operands: the LW transmission fit and truth
    rows (E2's five parts, optionally from misaligned copies) or the SW
    total-transmission launch (2*nlay+1 levels, od*ssi, two truth sets)."""
    planck, bg_od, _, _, emis, surfp, _, _ = args
    if kind == "sw_total_transmission":
        nlay = bg_od.shape[0]
        truth = [p for s in (0.5, 2.5) for p in (
            part_of(bg_od * s), part_of(emis * s), part_of(planck[0] * s))]
        parts = total_trans_fit_parts(surfp, bg_od, bg_od)[0] + truth
        assert sum(p(0, 1).shape[0] for p in parts) == 5 * nlay + 5
        return parts
    metric, p, hr, fd, fu, _, _ = _sum_args(args, seed=1)
    if kind == "lw_misaligned":
        metric, p, hr, fd, fu = map(_misaligned, (metric, p, hr, fd, fu))
    return [part_of(metric, p[1:]), part_of(p[1:]), part_of(hr),
            part_of(fd), part_of(fu)]


_SUM_LAYOUTS = ["nseg_1", "nseg_64", "nseg_256", "long", "outside"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["lw", "lw_misaligned",
                                  "sw_total_transmission"])
@pytest.mark.parametrize("layout", _SUM_LAYOUTS)
def test_interval_sums_match_plain(cuda, layout, kind, dtype):
    """K3 (and E2 on the LW rows) against the plain version at odd n,
    for 1, 64 and 256 intervals, intervals over more than ten chunks and
    bounds outside [0, n - 1]; E2's sums equal K3's bit for bit."""
    n = 70001
    i1, i2 = _sum_layout(layout, n)
    args = _to(_inputs(12, n, i1, i2, seed=21), cuda, dtype)
    parts = _sum_parts(kind, args)
    reset_launch_counts()
    got = fused_interval_sum(parts, n, args[6], args[7])
    assert fused_interval_sum.launches == 1
    want = interval_sum_fused(parts, n, args[6], args[7])
    assert got.shape == want.shape
    assert _row_err(got, want) <= RTOL[dtype]
    if kind != "sw_total_transmission":
        m, w_num = parts[0].arrays
        e2 = fused_sums_lw_intervals(
            m, torch.cat([w_num[:1], w_num]), parts[2].arrays[0],
            parts[3].arrays[0], parts[4].arrays[0], args[6], args[7])
        assert torch.equal(e2, got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_interval_sums_batch_independent(cuda, dtype):
    """An interval's K3 sums are the same bits launched with the others,
    alone, and in a launch with the intervals reversed and the pads
    removed; two launches are bit-identical."""
    n = 300001
    i1, i2 = _cube_bounds(n)
    args = _to(_inputs(12, n, i1, i2, seed=5), cuda, dtype)
    parts = _sum_parts("lw", args)
    whole = fused_interval_sum(parts, n, args[6], args[7])
    assert torch.equal(whole, fused_interval_sum(parts, n, args[6],
                                                 args[7]))
    rev = torch.arange(len(i1) - 1, 5, -1, device=cuda)   # without pads
    flipped = fused_interval_sum(parts, n, args[6][rev], args[7][rev])
    assert torch.equal(flipped, whole[:, rev])
    for j in range(0, len(i1), 7):
        alone = fused_interval_sum(parts, n, args[6][j:j + 1],
                                   args[7][j:j + 1])
        assert torch.equal(alone, whole[:, j:j + 1])


def _sweep_layout(name, n):
    """(i1, i2) of the sweep card cases: the interval-sum layouts, and
    single-wavenumber intervals (more than 32 entries in one strip) beside
    one interval over the whole axis."""
    if name == "single":
        return list(range(300, 340)) + [0], list(range(300, 340)) + [n - 1]
    return _sum_layout(name, n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("layout,n", [(lay, 70001) for lay in _SUM_LAYOUTS]
                         + [("nseg_256", 3001), ("single", 70001)])
def test_sweeps_match_plain(cuda, layout, n, misaligned, dtype):
    """K1 and K2 (with and without the reflected beam) against their plain
    versions: 1, 64 and 256 intervals (256 on a small n: many entries a
    strip), intervals over more than ten chunks, bounds outside [0, n - 1],
    more than 32 intervals in one strip; a ragged last strip, ranks outside
    every fit and, optionally, operands whose rows are not 16-byte
    aligned."""
    i1, i2 = _sweep_layout(layout, n)
    args = list(_to(_inputs(12, n, i1, i2, seed=31, seg_outside=77), cuda,
                    dtype))
    if misaligned:
        for k in (0, 1, 4, 5):
            args[k] = _misaligned(args[k])
    reset_launch_counts()
    got = sweep_lw_intervals(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, sweep_lw_plain(*args)):
        assert g.shape == w.shape
        assert _row_err(g, w) <= RTOL[dtype]
    for with_up in (True, False):
        sw = _sw_args(args, with_up)
        got = sweep_sw_intervals(*sw)
        torch.cuda.synchronize()
        for g, w in zip(got, sweep_sw_plain(*sw)):
            assert g.shape == w.shape
            assert _row_err(g, w) <= RTOL[dtype]
    assert sweep_lw_intervals.launches == 1
    assert sweep_sw_intervals.launches == 2
    assert sweep_sw_intervals.upwelling_launches == 1


def _permuted(args, perm):
    """The sweep operands with the intervals in the order ``perm``: the
    bounds and od_fit's columns permuted, seg remapped to the new columns
    (ranks outside every fit stay outside)."""
    planck, bg_od, od_fit, seg, emis, surfp, i1, i2 = args
    perm = torch.as_tensor(perm, device=i1.device)
    new_of = torch.empty_like(perm)
    new_of[perm] = torch.arange(len(perm), device=i1.device)
    inside = (seg >= 0) & (seg < len(perm))
    seg = torch.where(inside, new_of[seg.long().clamp(0, len(perm) - 1)]
                      .to(torch.int32), seg)
    return (planck, bg_od, od_fit[:, perm].contiguous(), seg, emis, surfp,
            i1[perm].contiguous(), i2[perm].contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sweeps_repeat_and_permute(cuda, dtype):
    """K1's, K2's and E1's sums of an interval do not depend on the other
    intervals of the launch: a repeat gives the same bits, and a launch
    with the intervals permuted (od_fit's columns with them, seg
    remapped) the same bits permuted."""
    n = 300001
    i1, i2 = _cube_bounds(n)
    args = _to(_inputs(12, n, i1, i2, seed=8, seg_outside=31), cuda, dtype)
    perm = np.random.default_rng(2).permutation(len(i1))
    moved = _permuted(args, perm)
    runs = [lambda a: sweep_lw_intervals(*a),
            lambda a: sweep_lw_scan_intervals(*a)] + [
        lambda a, up=up: sweep_sw_intervals(*_sw_args(a, up))
        for up in (True, False)]
    for run in runs:
        first = run(args)
        for a, b in zip(first, run(args)):
            assert torch.equal(a, b)
        for a, b in zip(first, run(moved)):
            assert torch.equal(a[:, perm], b)


def _sum_args(args, seed):
    """E2's arguments beside the sweep operands of :func:`_inputs`."""
    planck, bg_od, _, _, emis, surfp, i1, i2 = args
    rng = np.random.default_rng(seed)
    nlay, nwav = bg_od.shape
    metric = torch.as_tensor(-np.expm1(-1.66 * rng.gamma(0.5, 1.0,
                                                          (nlay, nwav))),
                             dtype=bg_od.dtype, device=bg_od.device)
    return metric, planck, bg_od * 1e-5, surfp, emis, i1, i2


# (nlay, nwav): E1 from one layer a lane to eight, its groups of 4, 8 and
# 16 lanes a wavenumber, up to its 128 layers; no nwav is a multiple of
# E1's 16-wavenumber strip
_EXP_SHAPES = [(1, 5003), (15, 9001), (50, 70001), (64, 4099), (100, 12345),
               (128, 3001)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nlay,nwav", _EXP_SHAPES)
def test_experiment_kernels_match_plain(cuda, nlay, nwav, dtype):
    """E1 and E2 against their plain versions, with front-padded bucket
    columns, a shared boundary index and ranks outside every fit."""
    i1 = [0, 0, 0, 1000, 3000, 3000]
    i2 = [0, 0, 1000, 2999, nwav - 1, nwav - 50]
    args = _to(_inputs(nlay, nwav, i1, i2, seed=nlay, seg_outside=77),
               cuda, dtype)
    reset_launch_counts()
    got = sweep_lw_scan_intervals(*args)
    torch.cuda.synchronize()
    assert sweep_lw_scan_intervals.launches == 1
    for g, w in zip(got, sweep_lw_scan_plain(*args)):
        assert _row_err(g, w) <= RTOL[dtype]
    sums = _sum_args(args, seed=nlay)
    got = fused_sums_lw_intervals(*sums)
    torch.cuda.synchronize()
    assert fused_sums_lw_intervals.launches == 1
    assert got.shape == (3 * nlay + 2, len(i1))
    assert _row_err(got, fused_sums_lw_plain(*sums)) <= RTOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_checked_build(cuda, dtype):
    """The card checks of K1, K2, K3, E1 and E2 against their plain
    versions, and of the sweeps' repeats and permuted launches, run again
    on the checked build: an index outside its range traps, and a failed
    host check raises."""
    with _build.checked():
        for case in sorted(_CASES):
            test_kernels_match_plain(cuda, case, dtype)
        for layout in ("outside", "single"):
            test_sweeps_match_plain(cuda, layout, 70001, True, dtype)
        test_interval_sums_match_plain(cuda, "outside", "lw", dtype)
        test_interval_sums_match_plain(cuda, "nseg_64",
                                       "sw_total_transmission", dtype)
        test_sweeps_repeat_and_permute(cuda, dtype)
        for nlay, nwav in _EXP_SHAPES:
            test_experiment_kernels_match_plain(cuda, nlay, nwav, dtype)
        torch.cuda.synchronize()
    assert not _build.checked_mode()


@pytest.mark.gpu
def test_experiment_kernels_deterministic_and_bounded(cuda):
    """Bit-identical repeats; E1 refuses more layers than it takes."""
    args = _to(_inputs(50, 300001, [0, 0, 10, 150000], [0, 9, 150000,
                                                         300000], seed=3),
               cuda, torch.float64)
    sums = _sum_args(args, seed=3)
    run = lambda: (*sweep_lw_scan_intervals(*args),
                   fused_sums_lw_intervals(*sums))
    first = run()
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, run()))
    deep = _to(_inputs(129, 700, [0], [699], seed=5), cuda, torch.float64)
    with pytest.raises(ValueError, match="layers"):
        sweep_lw_scan_intervals(*deep)


@pytest.mark.gpu
def test_kernels_deterministic(cuda):
    """No floating-point atomics: repeated launches are bit-identical."""
    args = _to(_inputs(50, 300001, [0, 0, 10, 150000], [0, 9, 150000,
                                                         300000], seed=3),
               cuda, torch.float64)
    parts = _fit_parts(args[0], args[1], args[4])
    run = lambda: (*sweep_lw_intervals(*args), *sweep_sw_intervals(
        *_sw_args(args)), fused_interval_sum(parts, 300001, args[6],
                                             args[7]))
    first = run()
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, run()))


@pytest.mark.gpu
def test_wrappers_reject_what_kernels_do_not_take(cuda):
    args = list(_to(_inputs(4, 512, [0], [511], seed=1), cuda,
                    torch.float64))
    bad = list(args)
    bad[3] = bad[3].long()                       # seg must be int32
    with pytest.raises(TypeError):
        sweep_lw_intervals(*bad)
    bad = list(args)
    bad[1] = args[1].t().contiguous().t()        # not contiguous
    with pytest.raises(ValueError):
        sweep_lw_intervals(*bad)
    with pytest.raises(ValueError):
        fused_interval_sum([lambda s, n: args[1][:, s:s + n]], 512,
                           args[6], args[7])
    sw = list(_sw_args(args))
    for k, bad_arg, err in (
            (0, sw[0].float(), TypeError),                 # dtype
            (1, sw[1].cpu(), ValueError),                  # device
            (2, sw[2][:, :0].contiguous(), ValueError),    # shape
            (1, sw[1].t().contiguous().t(), ValueError),   # not contiguous
            (7, sw[7][:-1], ValueError)):                  # albedo shape
        bad = list(sw)
        bad[k] = bad_arg
        with pytest.raises(err):
            sweep_sw_intervals(*bad)


@pytest.mark.parametrize("core", ["reorder_spectrum.reorder_core",
                                  "reorder_spectrum.compute_sorting_variable",
                                  "find_g_points.find_g_points_core",
                                  "create_lut.create_lut_core"])
def test_cores_default_to_the_card(core):
    """The array cores, like the file tools, compute on the card unless
    asked for the CPU; without a card they raise, naming device="cpu",
    and never fall back."""
    import importlib
    import inspect
    module, name = core.split(".")
    fn = getattr(importlib.import_module(f"ecckd_tpu_torch.tools.{module}"),
                 name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        from ecckd_tpu_torch.tools.common import resolve_device
        assert resolve_device() == torch.device("cuda")
    else:
        nargs = sum(p.default is inspect.Parameter.empty
                    for p in inspect.signature(fn).parameters.values())
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn(*([None] * nargs))


def test_setup_device_and_dtype():
    from ecckd_tpu_torch.config import Config
    from ecckd_tpu_torch.tools.common import setup
    assert setup(Config({"device": "cpu"})) == (torch.device("cpu"),
                                                torch.float64)
    assert setup(Config({"device": "cpu", "precision": "float32"}))[1] \
        == torch.float32
    assert not torch.backends.cuda.matmul.allow_tf32
    with pytest.raises(ValueError):
        setup(Config({"device": "cpu", "precision": "bfloat16"}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):    # the default is the card
            setup(Config({}))


@pytest.mark.parametrize("tool,keys", [
    ("find_g_points", {"sharded": "1"}),
    ("create_lut", {"streaming": "1"}),
    ("create_lut", {"sharded": "1"}),
])
def test_unported_options_raise(tool, keys):
    """Options of the JAX tools that the port does not have yet raise
    before any file is read."""
    import importlib
    from ecckd_tpu_torch.config import Config
    mod = importlib.import_module(f"ecckd_tpu_torch.tools.{tool}")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(mod, tool)(Config({"device": "cpu", "output": "x.h5",
                                   **keys}))


def _rig_profile(nwav=1024, nlay=15):
    """The 1024 x 15 h2o rig of tests/synth.py, profile 0."""
    rng = np.random.default_rng(3)
    p = np.exp(np.linspace(np.log(100.0), np.log(1.013e5), nlay + 1))
    t = np.linspace(210.0, 284.0, nlay + 1)
    wav = np.linspace(1.0, 2000.0, nwav)
    k = np.full(nwav, 1e-4)
    for c0, s, wd in zip(rng.uniform(wav[0], wav[-1], 60),
                         10.0 ** rng.uniform(-1, 3.5, 60),
                         rng.uniform(2, 30, 60) * (wav[-1] - wav[0]) / 2000):
        k = k + s / (1.0 + ((wav - c0) / wd) ** 2)
    tfact = np.exp(0.02 * (t[1:, None] - 250.0))
    od = 0.01 * (np.diff(p) / 9.80665 / 0.02897)[:, None] * 1e-3 * k * tfact
    return p, t, wav, np.gradient(wav), od.astype(np.float32).astype(float)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["transmission", "logarithmic"])
def test_candidate_costs_card_vs_cpu(cuda, method):
    """The whole candidate cost (K3, fit, K1, cost) on the card against the
    CPU path: 1e-11 of the largest cost, as between the JAX and CPU
    paths.  The band's layers stay below od 3, away from opaque intervals
    whose transmission fit sits at the clamp and has no such accuracy
    (ROADMAP.md, faults)."""
    from ecckd_tpu_torch.convert import lw_band_state
    from ecckd_tpu_torch.ops import heating_rate, planck_function, rt_lw
    from ecckd_tpu_torch.partition import CandidateCostLw
    p, t, wav, dwav, od = _rig_profile()
    rng = np.random.default_rng(8)
    col = np.sort(10.0 ** rng.uniform(-3, 0.5, od.shape[1]))
    od = col[None, :] * rng.dirichlet(np.ones(od.shape[0]), od.shape[1]).T
    T = torch.from_numpy
    planck = planck_function(T(t), T(wav), T(dwav))
    fd, fu = rt_lw(planck, T(od), torch.ones(len(wav), dtype=torch.float64),
                   planck[-1])
    lw = np.diff(np.sqrt(p))
    arrays = dict(layer_weight=lw / lw.sum(), pressure_hl=p,
                  surf_emissivity=np.ones(len(wav)),
                  surf_planck=planck[-1].numpy(), flux_dn_surf=fd[-1].numpy(),
                  flux_up_toa=fu[0].numpy(), planck_hl=planck.numpy(),
                  bg_od=np.zeros_like(od),
                  metric=(-np.expm1(-1.66 * od) if method == "transmission"
                          else od),
                  hr=heating_rate(T(p), fd, fu).numpy())
    costs = [CandidateCostLw(method, 0.02, **lw_band_state(arrays, d,
                                                           torch.float64))
             for d in ("cpu", cuda)]
    for i1, i2 in (([0, 300, 700], [299, 699, 1023]), ([5, 6], [5, 900]),
                   ([0, 100, 100, 1000], [99, 100, 999, 1023])):
        i1 = np.asarray(i1, np.int32)
        i2 = np.asarray(i2, np.int32)
        want, got = (c.costs(i1, i2) for c in costs)
        assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["transmission", "total-transmission"])
def test_sw_candidate_costs_card_vs_cpu(cuda, method):
    """The SW candidate cost (K3, fit, K2, cost) on the card against the
    CPU path, to 1e-11 of the largest cost; the reflected beam runs for
    transmission (albedo 0.15), not for total-transmission."""
    from ecckd_tpu_torch.convert import sw_band_state
    from ecckd_tpu_torch.ops import (heating_rate, rt_direct_sw,
                                     rt_norayleigh_sw)
    from ecckd_tpu_torch.partition import CandidateCostSw
    p, _, _, _, od = _rig_profile()
    rng = np.random.default_rng(5)
    col = np.sort(10.0 ** rng.uniform(-3, 0.5, od.shape[1]))
    od = col[None, :] * rng.dirichlet(np.ones(od.shape[0]), od.shape[1]).T
    ssi = np.abs(rng.normal(1.0, 0.3, od.shape[1]))
    T = torch.from_numpy
    fd = rt_direct_sw(0.5, T(ssi), T(od))
    lw = np.diff(np.sqrt(p))
    albedo = 0.15 if method == "transmission" else 0.0
    arrays = dict(layer_weight=lw / lw.sum(), pressure_hl=p, ssi=ssi,
                  surf_albedo=albedo, flux_dn_surf=fd[-1].numpy(),
                  flux_up_toa=np.zeros(len(ssi)), bg_od=np.zeros_like(od),
                  metric=(-np.expm1(-1.66 * od) if method == "transmission"
                          else od), hr=heating_rate(T(p), fd).numpy())
    extras = None
    if method == "total-transmission":
        extras = dict(min_scaling=0.5, max_scaling=2.5)
        for tag, scale in (("low", 0.5), ("high", 2.5)):
            fds, fus = rt_norayleigh_sw(0.5, T(ssi), T(scale * od),
                                        torch.full((len(ssi),), 0.15,
                                                   dtype=torch.float64))
            extras.update({f"hr_{tag}": heating_rate(T(p), fds).numpy(),
                           f"flux_dn_surf_{tag}": fds[-1].numpy(),
                           f"flux_up_toa_{tag}": fus[0].numpy()})
    costs = [CandidateCostSw(method, 0.02, cos_sza=0.5,
                             **sw_band_state(arrays, extras, d,
                                             torch.float64))
             for d in ("cpu", cuda)]
    reset_launch_counts()
    for i1, i2 in (([0, 300, 700], [299, 699, 1023]), ([5, 6], [5, 900]),
                   ([0, 100, 100, 1000], [99, 100, 999, 1023])):
        i1 = np.asarray(i1, np.int32)
        i2 = np.asarray(i2, np.int32)
        want, got = (c.costs(i1, i2) for c in costs)
        assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()
    assert sweep_sw_intervals.launches == 3 * (
        2 if method == "total-transmission" else 1)


@pytest.mark.gpu
def test_chain_core_float32_on_card(cuda):
    """precision=float32 runs the chain on the card: contiguous ranks,
    errors of the order of the tolerance, a finite positive LUT."""
    from types import SimpleNamespace
    from ecckd_tpu_torch.models import ConcDependence
    from ecckd_tpu_torch.tools.create_lut import LutGas, create_lut_core
    from ecckd_tpu_torch.tools.find_g_points import (GasInput,
                                                     find_g_points_core)
    from ecckd_tpu_torch.tools.reorder_spectrum import reorder_core
    p, t, wav, dwav, od = _rig_profile()
    f32 = torch.float32
    o = reorder_core(p, wav, dwav, od, device=cuda, dtype=f32)
    gp = find_g_points_core(
        [GasInput("h2o", o["rank"], o["band_number"], o["wavenumber1_band"],
                    o["wavenumber2_band"], o["sorting_variable"], p, t, wav,
                    dwav, od)], 0.4, averaging_method="transmission",
        device=cuda, dtype=f32)
    g = gp.gases[0]
    assert g.rank1[0] == 0 and np.all(g.rank1[1:] == g.rank2[:-1] + 1)
    assert g.error.max() < 0.8
    sp = SimpleNamespace(pressure_hl=p, temperature_hl=t, wavenumber=wav,
                         d_wavenumber=dwav, optical_depth=od, ncol=1)
    model = create_lut_core(gp.g_point, gp.wavenumber1_band,
                               gp.wavenumber2_band, gp.band_number,
                               [LutGas("h2o", ConcDependence.LINEAR,
                                       [lambda i: (sp, 0.01)])],
                               device=cuda, dtype=f32)
    k = model.single_gas_data[0].molar_abs
    assert np.all(np.isfinite(k)) and np.all(k > 0)


@pytest.mark.parametrize("variant", ["no-reduce", "no-scan", "no-fit",
                                     "no-common", "lanes-swap", "strip-32",
                                     "strip-8", "lpl-16"])
def test_ablation_edits_apply(variant):
    """Every line the ablation script edits is in its source exactly
    once, so each variant switches off what it names."""
    from ecckd_tpu_torch.ops.kernels._build import CSRC
    from ecckd_tpu_torch.scripts.ablate_kernels import EDITS
    for name, old, new in EDITS[variant]:
        text = (CSRC / name).read_text()
        assert text.count(old) == 1 and new not in text


@pytest.mark.parametrize("bytes_,regs,warps", [
    (8, 96, 16), (4, 64, 30), (8, 255, 8), (4, 128, 16)])
def test_ablation_resident_warps(bytes_, regs, warps):
    """E1's resident warps a SM at 50 layers from nvcc's register report
    and the level buffers: shared memory holds 8 blocks of 2 warps in
    float64 and 15 in float32, unless the registers hold fewer."""
    from ecckd_tpu_torch.scripts.ablate_kernels import e1_resident_warps
    name = f"_ZN5ecckd20sweep_lw_scan_kernelI{'d' if bytes_ == 8 else 'f'}" \
        "Li8ELi7EEEvPKT_"
    log = (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
           "ptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           f"loads\nptxas info    : Used {regs} registers, 384 bytes cmem[0]\n")
    assert e1_resident_warps(50, bytes_, log) == warps
