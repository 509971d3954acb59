"""The traced window: ``torch.profiler`` over CPU and CUDA, reduced to what
the per-layer metrics read.

Device time is the union of the intervals in which a kernel, a copy or a
fill ran on the card, clipped to the window; the benchmark's own spans
(``ckd_bench.*``), which the profiler also marks on the device's
timeline, are no device work and are left out.  Kernels of the port are
found by name: K1 ``sweep_lw_kernel``, K2 ``sweep_sw_kernel``, K3
``stream_kernel``; the ``sum_slots`` kernel that each of them launches
after it is counted with the kernel before it.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

PORT_KERNELS = {"sweep_lw_kernel": "K1", "sweep_sw_kernel": "K2",
                "stream_kernel": "K3"}
TAIL_KERNEL = "sum_slots"
SPAN_PREFIX = "ckd_bench."
WINDOW_SPAN = SPAN_PREFIX + "window"


class Trace:
    """Profiles the block; afterwards holds the device events (name,
    start, end in us), the CPU events and the window's span."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        from torch.autograd import DeviceType
        self.device_events, self.cpu_events = [], []
        self.window = (0.0, self.wall_s * 1e6)
        for e in self._prof.events():
            tr = e.time_range
            if e.name.startswith(SPAN_PREFIX):
                if e.name == WINDOW_SPAN and e.device_type != DeviceType.CUDA:
                    self.window = (tr.start, tr.end)
                if e.device_type != DeviceType.CUDA:
                    self.cpu_events.append((e.name, tr.start, tr.end))
            elif e.device_type == DeviceType.CUDA:
                self.device_events.append((e.name, tr.start, tr.end))
            else:
                self.cpu_events.append((e.name, tr.start, tr.end))
        self.device_events.sort(key=lambda x: x[1])
        self._prof = None
        return False


def merged(intervals, lo, hi):
    """Union of (start, end) intervals clipped to [lo, hi], sorted."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Context:
    """What a per-layer metric's reader gets: the job (its counters and
    logs of the traced window), the trace, the jobs' durations and the
    window's seconds."""

    def __init__(self, job, tr, durations, window_s):
        self.job, self.trace = job, tr
        self.durations, self.window_s = durations, window_s
        lo, hi = tr.window
        self.busy = merged([(s, e) for _, s, e in tr.device_events], lo, hi)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6
        if tr.cuda and not tr.device_events:
            self.busy_s = None
        self.window_s = (hi - lo) / 1e6 if hi > lo else window_s

    def device_seconds(self, match):
        """Seconds of device events whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.trace.device_events
                   if match(n)) / 1e6

    def port_kernel_seconds(self):
        """Device seconds and launches of K1, K2 and K3, each with the
        ``sum_slots`` kernel that follows its launches."""
        secs, count = defaultdict(float), defaultdict(int)
        owner = None
        for n, s, e in self.trace.device_events:
            key = next((k for sub, k in PORT_KERNELS.items() if sub in n),
                       None)
            if key is not None:
                owner = key
                count[key] += 1
                secs[key] += (e - s) / 1e6
            elif TAIL_KERNEL in n and owner is not None:
                secs[owner] += (e - s) / 1e6
        return dict(secs), dict(count)

    def breakdown(self):
        """The ten device operations that took most time, and the ten
        longest idle gaps of the card by what the host was doing (the
        innermost benchmark span and the innermost operation there)."""
        ops = defaultdict(float)
        for n, s, e in self.trace.device_events:
            ops[n[:120]] += (e - s) / 1e6
        top = sorted(ops.items(), key=lambda x: -x[1])[:10]
        lo, hi = self.trace.window
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:10]
        idle = []
        for length, start in gaps:
            mid = start + 0.5 * length
            inside = [(s, e, n) for n, s, e in self.trace.cpu_events
                      if s <= mid <= e]
            span = [n for s, e, n in sorted(inside, key=lambda x: x[0])
                    if n.startswith(SPAN_PREFIX)]
            op = [n for s, e, n in sorted(inside, key=lambda x: x[0])
                  if not n.startswith(SPAN_PREFIX)]
            name = (span[-1] if span else "host") + "/" + (
                op[-1] if op else "python")
            idle.append([name[:120], length / 1e6])
        return {"device_ops": [[n, v] for n, v in top], "idle_gaps": idle}
