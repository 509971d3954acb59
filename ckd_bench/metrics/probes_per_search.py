"""Probes of the equipartition search per search: launches of kernel K3
(one per probe on the main path) counted by the port over the traced
searches.  Layer: partition/ (equipartition, band_parallel, cost_kernel).
Moves search_s."""


def read(ctx):
    launches = ctx.job.launches().get("fused_interval_sum")
    if not launches:
        return None
    return launches / len(ctx.durations)
