"""Card-idle milliseconds a table inside create_lut's core, the port's
``ecckd.create_lut.core`` spans, outside its waits for the next block
(``ecckd.create_lut.wait_block``, read by block_wait_ms): the consumer's
own host work, its copies' host side and the read-backs
(ckd_bench/spans.py).  Layer: tools cores.  Moves lut_s."""

from ckd_bench import spans


def read(ctx):
    core = spans.idle_ms_per_job(ctx, {"ecckd.create_lut.core"})
    if core is None:
        return None
    wait = spans.idle_ms_per_job(ctx, {"ecckd.create_lut.wait_block"}) or 0.0
    return core - wait
