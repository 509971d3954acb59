"""The port's spans on the traced window's clock, and the card's idle time
inside them.

The port records its spans (``ecckd_tpu_torch.logs.span``,
``ecckd.<layer>.<step>``) from every thread on ``time.perf_counter_ns``'s
clock while a profile runs, and on the main thread also marks each as a
profiler event of the same name.  The offset between the two clocks is the
median, over the main thread's spans that both hold, of the profiler's
start less the recorded start, the k-th recorded span of a name against
the k-th profiler event of that name.  Every recorded span of the window,
from any thread, is mapped with it onto the trace's timeline (us) and
clipped to the window.  Reads only what ``trace.Trace`` and
``trace.Context`` keep, and fits the offset here rather than take the
port's (``tools.common.maybe_profile`` fits its own for a tool's trace),
so that the yardstick does not move with the program.  A program without
spans gives no spans, and the readers then give no metric.
"""

from __future__ import annotations

import statistics
import threading

from .trace import merged

PREFIX = "ecckd."


def recorded(tr):
    """The port's spans recorded within the traced window's host clock,
    or [] where the port records none."""
    try:
        from ecckd_tpu_torch.logs import spans
    except ImportError:
        return []
    lo = tr.t0 * 1e9
    hi = (tr.t0 + tr.wall_s) * 1e9
    return [s for s in spans() if s.start_ns >= lo and s.end_ns <= hi]


def offset_us(tr, spans):
    """Trace us minus recorded us, the median over the main thread's
    spans, or None where no span pairs with a profiler event."""
    events = {}
    for name, start, _ in sorted(tr.cpu_events, key=lambda e: e[1]):
        if name.startswith(PREFIX):
            events.setdefault(name, []).append(start)
    main = threading.main_thread().native_id
    starts = {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        if s.thread == main:
            starts.setdefault(s.name, []).append(s.start_ns / 1e3)
    pairs = [t - r for name, ts in events.items()
             for t, r in zip(ts, starts.get(name, ()))]
    return statistics.median(pairs) if pairs else None


def mapped(ctx):
    """Every recorded span of the window as (name, start, end, span) in
    trace us, clipped to the window; [] without spans.  Kept on ``ctx``,
    so the readers of one run map them once."""
    cached = getattr(ctx, "_ecckd_spans", None)
    if cached is not None:
        return cached
    tr = ctx.trace
    spans = recorded(tr)
    off = offset_us(tr, spans)
    out = []
    if off is not None:
        lo, hi = tr.window
        for s in spans:
            a = max(s.start_ns / 1e3 + off, lo)
            b = min(s.end_ns / 1e3 + off, hi)
            if b > a:
                out.append((s.name, a, b, s))
    ctx._ecckd_spans = out
    return out


def intervals(ctx, names):
    """The merged (start, end) intervals of the spans named in
    ``names``."""
    lo, hi = ctx.trace.window
    return merged([(a, b) for n, a, b, _ in mapped(ctx) if n in names],
                  lo, hi)


def idle_us(ctx, within):
    """Microseconds of ``within`` (merged, sorted intervals) in which the
    card was idle: the complement of ``ctx.busy``."""
    busy = ctx.busy
    idle, k = 0.0, 0
    for a, b in within:
        covered = 0.0
        while k < len(busy) and busy[k][1] <= a:
            k += 1
        j = k
        while j < len(busy) and busy[j][0] < b:
            covered += min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
        idle += (b - a) - covered
    return idle


def idle_ms_per_job(ctx, names):
    """Card-idle ms a job inside the union of the spans named in
    ``names``, or None where no such span was recorded (a program without
    spans)."""
    within = intervals(ctx, names)
    if not within or ctx.busy_s is None:
        return None
    return idle_us(ctx, within) / 1e3 / len(ctx.durations)
