"""Card-idle milliseconds a table while create_lut waits for the prefetch
thread's next block, inside the port's ``ecckd.create_lut.wait_block``
spans (ckd_bench/spans.py).  Layer: io: block reads and prefetch.
Moves lut_s."""

from ckd_bench import spans


def read(ctx):
    return spans.idle_ms_per_job(ctx, {"ecckd.create_lut.wait_block"})
