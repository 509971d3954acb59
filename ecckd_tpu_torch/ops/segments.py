"""Contiguous-interval reductions over the rank-ordered wavenumber axis.

PyTorch counterpart of ``ecckd_tpu/ops/segments.py``.  A "part" is a
callable ``part(start, size) -> (rows, size)`` giving a block of operand
rows; :func:`part_of` builds the common case, an elementwise product of
bound arrays, and exposes them as ``part.arrays`` so that kernel K3
(:mod:`ecckd_tpu_torch.ops.kernels.interval_sum`) can rebuild the product
itself.  :func:`interval_sum_fused` here is K3's plain version: per tile,
the stacked part rows times a 0/1 membership matrix.  Matmuls against
membership matrices must be exact, so the port keeps TF32 off
(:func:`ecckd_tpu_torch.tools.common.setup`).

The prefix path (:func:`build_prefix_sums`, :func:`interval_sum_from_prefix`)
replaces K3 where the same rows are reduced over many interval sets: the
rows' double-float prefix sums are built once, and each interval sum is
then two gathers.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def part_of(*arrays):
    """Fused-reduction part: the elementwise product of ``arrays`` (each
    (rows, n) or (n,); 1-D arrays broadcast across rows), sliced per tile.
    With one array this is a plain row block."""
    def part(start, size):
        out = None
        for a in arrays:
            sl = a.narrow(a.ndim - 1, start, size)
            if a.ndim == 1:
                sl = sl[None, :]
            out = sl if out is None else out * sl
        return out
    part.arrays = arrays
    return part


def _membership(start, size, i1, i2, dtype):
    idx = torch.arange(start, start + size, device=i1.device,
                       dtype=i1.dtype)[:, None]
    return ((idx >= i1[None, :]) & (idx <= i2[None, :])).to(dtype)


def interval_sum_fused(parts: Sequence[Callable], n: int, i1, i2,
                       dtype=None, tile: int = 8192):
    """Stacked interval sums of ``parts`` over inclusive [i1, i2].

    The plain version of kernel K3 (and the reduction inside the plain
    version of K1): per wavenumber tile, the concatenated part rows are
    multiplied by a (tile, nseg) 0/1 membership matrix, and the tiles are
    added in order, as the XLA form of the JAX package does.

    Args:
      parts: callables producing (rows_k, size) blocks.
      n: length of the reduced axis.
      i1, i2: (nseg,) integer tensors of inclusive bounds.
      dtype: accumulation dtype (default: that of the first block).

    Returns:
      (sum(rows_k), nseg) tensor, parts in order.
    """
    def block(start, size):
        rows = [p(start, size) for p in parts]
        return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]

    def reduce_tile(start, size):
        b = block(start, size)
        b = b.to(dtype if dtype is not None else b.dtype)
        return b @ _membership(start, size, i1, i2, b.dtype)

    nfull = n // tile
    rem = n - nfull * tile
    if nfull == 1 and rem == 0:
        return reduce_tile(0, n)
    acc = None
    for k in range(nfull):
        t = reduce_tile(k * tile, tile)
        acc = t if acc is None else acc + t
    if rem:
        t = reduce_tile(nfull * tile, rem)
        acc = t if acc is None else acc + t
    return acc


def _two_sum(a, b):
    """Error-free addition (Knuth): s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _df_add(x, y):
    """Double-float addition of (hi, lo) pairs: ~2x-precision accumulate."""
    xh, xl = x
    yh, yl = y
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def _df_cumsum(v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive double-float prefix sums of ``v`` along the last axis.

    The port of ``ecckd_tpu/ops/segments.py:_df_cumsum``, an XLA
    ``associative_scan``: here a doubling (Hillis-Steele) scan whose every
    combine is :func:`_df_add`, so hi + lo is the prefix sum to ~2x working
    precision, the error after n elements O(log n * eps^2) of the prefix.
    The combines pair other elements than XLA's tree, so the two agree to
    that order, not bit for bit."""
    hi = v.clone()
    lo = torch.zeros_like(v)
    n = v.shape[-1]
    shift = 1
    while shift < n:
        h, l = _df_add((hi[..., :-shift], lo[..., :-shift]),
                       (hi[..., shift:], lo[..., shift:]))
        hi[..., shift:] = h
        lo[..., shift:] = l
        del h, l
        shift *= 2
    return hi, lo


def build_prefix_sums(parts: Sequence[Callable], n: int, row_chunk: int = 64):
    """Double-float prefix sums of the rows of ``parts``.

    Port of ``ecckd_tpu/ops/segments.py:build_prefix_sums``: when the same
    operand rows are reduced over many interval sets (a band's candidate
    search probes hundreds), the O(rows * n) reduction is paid once and
    every interval sum is a pair of gathers
    (:func:`interval_sum_from_prefix`).  Each part is formed whole with
    plain tensor products, not with kernel K3, and scanned ``row_chunk``
    rows at a time to bound the scan's temporaries.

    Returns (hi, lo), each (total_rows, n + 1) with a leading zero column,
    so the sum over inclusive [i1, i2] is C[i2 + 1] - C[i1]."""
    his, los = [], []
    for p in parts:
        block = p(0, n)
        for r0 in range(0, block.shape[0], row_chunk):
            hi, lo = _df_cumsum(block[r0:r0 + row_chunk])
            zero = hi.new_zeros((hi.shape[0], 1))
            his.append(torch.cat([zero, hi], dim=1))
            los.append(torch.cat([zero, lo], dim=1))
            del hi, lo
        del block
    hi = torch.cat(his) if len(his) > 1 else his[0]
    del his
    lo = torch.cat(los) if len(los) > 1 else los[0]
    return hi, lo


def interval_sum_from_prefix(hi, lo, i1, i2):
    """Interval sums over inclusive [i1, i2] from the prefix sums of
    :func:`build_prefix_sums`: (rows, nseg).  The hi difference of nearby
    prefixes is exact (Sterbenz) or correctly rounded; the lo difference
    restores the compensated tail."""
    j1 = i1.long()
    j2 = i2.long() + 1
    h = hi.index_select(1, j2) - hi.index_select(1, j1)
    l = lo.index_select(1, j2) - lo.index_select(1, j1)
    return h + l


def fused_groups(parts, n: int):
    """``(meta, unique)`` when every part is a :func:`part_of` product of
    tensors over the full axis, else None.

    ``unique`` holds each distinct operand tensor once (by object identity),
    as a 2-D (rows, n) tensor; each ``meta`` entry is ``(operand_indices,
    rows)`` for one part, so an array used by several parts is read once
    per wavenumber (port of ``_pallas_groups``)."""
    meta = []
    unique = []
    index_of = {}
    for p in parts:
        arrs = getattr(p, "arrays", None)
        if arrs is None:
            return None
        idxs = []
        rows = 1
        for orig in arrs:
            a = orig[None, :] if orig.ndim == 1 else orig
            if a.ndim != 2 or a.shape[-1] != n:
                return None
            key = id(orig)
            if key not in index_of:
                index_of[key] = len(unique)
                unique.append(a)
            idxs.append(index_of[key])
            rows = max(rows, a.shape[0])
        meta.append((tuple(idxs), rows))
    return tuple(meta), tuple(unique)


def interval_sum(values, i1, i2):
    """Sum ``values`` (..., n) over inclusive intervals of the last axis,
    through kernel K3 on the card."""
    from .kernels.interval_sum import fused_interval_sum
    n = values.shape[-1]
    lead = values.shape[:-1]
    v2 = values.reshape(-1, n)
    out = fused_interval_sum([part_of(v2)], n, i1, i2, dtype=values.dtype)
    return out.reshape(lead + (out.shape[-1],))


def interval_count(mask, i1, i2, dtype=torch.float64):
    """Count of True values in each interval of the last axis."""
    return interval_sum(mask.to(dtype), i1, i2)


def gpoint_onehot(g_point, ng: int, dtype=torch.float64):
    """One-hot (nwav, ng) membership matrix from a per-wavenumber g-point
    map; entries with g_point < 0 (unassigned) belong to no g-point."""
    g_range = torch.arange(ng, device=g_point.device)
    return (g_point[:, None] == g_range[None, :]).to(dtype)
