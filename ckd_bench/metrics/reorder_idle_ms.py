"""Card-idle milliseconds a search inside reorder_spectrum's core, the
port's ``ecckd.reorder.core`` spans (the sorting variable's blocks to the
card and back, the per-band stable argsort; ckd_bench/spans.py).  Layer:
tools cores.  Moves search_s."""

from ckd_bench import spans


def read(ctx):
    return spans.idle_ms_per_job(ctx, {"ecckd.reorder.core"})
