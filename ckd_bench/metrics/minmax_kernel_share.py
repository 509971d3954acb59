"""Share in % of the blocks that create_lut's streamed loop reduced whose
least and largest od per (layer, g-point) went through the port's
min/max kernel K4, of all the blocks it reduced in the run (set-up's table
and the window's): the port's counters ``segment_min_max.launches`` over
``ops.streaming.transfer_counts()``, pinned and pageable.  None where the
port has no such counter.  Layer: ops: create_lut averaging.  Moves
lut_s."""


def read(ctx):
    try:
        from ecckd_tpu_torch.ops.kernels.segment_minmax import segment_min_max
        from ecckd_tpu_torch.ops.streaming import transfer_counts
    except ImportError:
        return None
    launches = getattr(segment_min_max, "launches", None)
    counts = transfer_counts()
    total = counts["pinned"] + counts["pageable"]
    if launches is None or total == 0:
        return None
    return 100.0 * launches / total
