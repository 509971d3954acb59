"""Share of the traced window in which nothing ran on the card
(torch.profiler: kernels, copies and fills).  Layer: device.  Read for
``idle_share.<kind>``, which moves the end-to-end metric of its cells'
jobs (``idle_share.search`` search_s, ``idle_share.lut`` lut_s)."""


def read(ctx):
    if ctx.busy_s is None:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
