"""Kernel K3 (fused_interval_sum) against its roofline: the least time of
each probe's launch from its shapes, the rows of the LW fit and truth or
of the SW total-transmission fit and its two scaled truths
(ckd_bench/roofline.py), summed, over K3's device time in the trace (with
its sum_slots kernel).  Layer: ops/kernels.  Moves search_s."""

from ckd_bench.roofline import k3_rows, row_sums


def read(ctx):
    probes = ctx.job.probes()
    secs, count = ctx.port_kernel_seconds()
    if not probes or count.get("K3") != len(probes):
        return None
    least = 0.0
    for p in probes:
        rows, nprod = k3_rows(p.nlay, p.kind == "sw")
        least += row_sums(rows, p.n, nprod, p.i1, p.i2, p.elem)
    return 100.0 * least / secs["K3"]
