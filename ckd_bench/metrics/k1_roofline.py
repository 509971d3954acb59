"""Kernel K1 (sweep_lw_intervals) against its roofline: the least time of
each launch's work, from its shapes (ckd_bench/roofline.py), summed, over
K1's device time in the trace (with its sum_slots kernel).  Layer:
ops/kernels.  Moves search_s."""

from ckd_bench.roofline import lw_sweep


def read(ctx):
    probes = [p for p in ctx.job.probes() if p.kind == "lw"]
    secs, count = ctx.port_kernel_seconds()
    if not probes or count.get("K1") != len(probes):
        return None
    least = sum(lw_sweep(p.nlay, p.n, p.i1, p.i2, p.elem) for p in probes)
    return 100.0 * least / secs["K1"]
