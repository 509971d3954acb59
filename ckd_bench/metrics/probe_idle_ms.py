"""Card-idle milliseconds per probe of the equipartition search: the
card's idle time inside the union of the port's
``ecckd.find_g_points.search`` spans (one a band, on the band threads in
the SW), over the number of ``ecckd.partition.probe`` spans (one a
kernel dispatch) in them (ckd_bench/spans.py).  Layer: partition/ on the
host.  Moves search_s."""

from ckd_bench import spans


def read(ctx):
    within = spans.intervals(ctx, {"ecckd.find_g_points.search"})
    probes = sum(1 for n, a, b, _ in spans.mapped(ctx)
                 if n == "ecckd.partition.probe"
                 and any(lo <= a and b <= hi for lo, hi in within))
    if not probes or ctx.busy_s is None:
        return None
    return spans.idle_us(ctx, within) / 1e3 / probes
