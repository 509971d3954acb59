"""Card-idle milliseconds a search while a band thread waits at
band_parallel's barrier for the other bands' batches: inside the union of
the port's ``ecckd.partition.barrier`` spans, each from a band thread's
post of its probe batch to the firing of the merged dispatch that carries
it, the dispatch left out (ckd_bench/spans.py).  None where the port
records no such span.  Layer: partition: equipartition, band_parallel,
cost_kernel.  Moves search_s."""

from ckd_bench import spans


def read(ctx):
    return spans.idle_ms_per_job(ctx, {"ecckd.partition.barrier"})
