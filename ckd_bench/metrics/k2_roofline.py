"""Kernel K2 (sweep_sw_intervals) against its roofline: the least time of
each launch's work from its shapes, launches with and without the
reflected beam each by their own count (ckd_bench/roofline.py), summed,
over K2's device time in the trace (with its sum_slots kernel).  Layer:
ops/kernels.  Moves search_s."""

from ckd_bench.roofline import sw_sweep


def read(ctx):
    probes = [p for p in ctx.job.probes() if p.kind == "sw"]
    secs, count = ctx.port_kernel_seconds()
    launches = sum(p.sweeps for p in probes)
    if not probes or count.get("K2") != launches:
        return None
    least = sum(p.sweeps * sw_sweep(p.nlay, p.n, p.i1, p.i2, p.elem,
                                    p.upwelling) for p in probes)
    return 100.0 * least / secs["K2"]
