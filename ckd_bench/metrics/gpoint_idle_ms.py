"""Card-idle milliseconds a search in find_g_points' host steps around
each gas's search: inside the port's ``ecckd.find_g_points.prepare``,
``.truth``, ``.split`` and ``.store`` spans and the gases' ``.overlap``
(ckd_bench/spans.py).  Layer: tools cores.  Moves
search_s."""

from ckd_bench import spans

STEPS = {f"ecckd.find_g_points.{step}"
         for step in ("prepare", "truth", "split", "store", "overlap")}


def read(ctx):
    return spans.idle_ms_per_job(ctx, STEPS)
