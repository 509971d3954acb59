"""Band batches merged into each of band_parallel's dispatches: the port's
counter ``partition.band_parallel.dispatch_counts()``, its band batches
over its merged dispatches, over the run (set-up's search and the
window's).  Between the number of bands, while every band still searches,
and 1, where one band searches on alone.  None where the port has no such
counter or merged no dispatch.  Layer: partition: equipartition,
band_parallel, cost_kernel.  Moves search_s."""


def read(ctx):
    try:
        from ecckd_tpu_torch.partition.band_parallel import dispatch_counts
    except ImportError:
        return None
    counts = dispatch_counts()
    if not counts["dispatches"]:
        return None
    return counts["batches"] / counts["dispatches"]
