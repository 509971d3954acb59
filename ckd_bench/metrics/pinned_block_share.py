"""Share in % of the blocks that create_lut's streamed loop staged in
page-locked memory and copied to the card one block ahead of their
reduction, of all the blocks it reduced in the run (set-up's table and the
window's): the port's counter ``ops.streaming.transfer_counts()``.  None
where the port has no such counter.  Layer: ops and io: copies to the
card.  Moves lut_s."""


def read(ctx):
    try:
        from ecckd_tpu_torch.ops.streaming import transfer_counts
    except ImportError:
        return None
    counts = transfer_counts()
    total = counts["pinned"] + counts["pageable"]
    if total == 0:
        return None
    return 100.0 * counts["pinned"] / total
