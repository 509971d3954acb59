"""Card-idle milliseconds a search while find_g_points builds its
per-wavenumber g-point maps: inside the union of the port's
``ecckd.find_g_points.overlap.map`` (the merged map) and
``ecckd.find_g_points.store.map`` (each gas's map) spans
(ckd_bench/spans.py).  None where the port records no such span.  Layer:
partition: gas_data overlap and per-wavenumber maps.  Moves search_s."""

from ckd_bench import spans

STEPS = {"ecckd.find_g_points.overlap.map", "ecckd.find_g_points.store.map"}


def read(ctx):
    return spans.idle_ms_per_job(ctx, STEPS)
