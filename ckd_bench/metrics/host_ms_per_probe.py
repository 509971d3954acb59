"""Host milliseconds between probes: the traced searches' wall time less
the card's busy time (torch.profiler), over the probes (K3 launches).
Layer: partition/ on the host.  Moves search_s."""


def read(ctx):
    probes = ctx.job.launches().get("fused_interval_sum")
    if not probes or ctx.busy_s is None:
        return None
    return 1e3 * (ctx.window_s - ctx.busy_s) / probes
