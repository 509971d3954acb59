"""Device milliseconds per table of create_lut's least and largest od per
g-point: the scatter_reduce kernels (amin, amax), found by name in the
trace.  Layer: ops/ create_lut averaging.  Moves lut_s."""


def read(ctx):
    secs = ctx.device_seconds(lambda n: "scatter" in n.lower())
    if secs == 0.0:
        return None
    return 1e3 * secs / len(ctx.durations)
