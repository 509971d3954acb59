"""Shared prologue of the port's pipeline tools.

``find_file``, the search path, ``tool_prologue`` and ``read_string_list``
are the port's own copy of ``ecckd_tpu/tools/common.py:21-69`` (the port
imports nothing of the JAX package); :func:`setup` replaces its
``setup_jax`` and fixes the device and dtype a tool computes in;
:func:`netcdf_format` reads the container a tool writes;
:func:`device_tensor` puts a tool's host arrays on its device;
:class:`maybe_profile` traces with ``torch.profiler`` where the JAX one
traces with ``jax.profiler``.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import logs
from ..config import Config
from ..io.ncio import FORMATS

_DTYPES = {"float64": torch.float64, "float32": torch.float32}
_search_path: List[str] = []


def prepend_search_directory(path: str):
    _search_path.insert(0, path)


def append_search_directory(path: str):
    _search_path.append(path)


def find_file(name: str) -> str:
    """Resolve a file name against the search path (ref file_manager.cpp)."""
    if os.path.isabs(name) or os.path.exists(name):
        return name
    for d in _search_path:
        candidate = os.path.join(d, name)
        if os.path.exists(candidate):
            return candidate
    return name


def tool_prologue(argv: Sequence[str]) -> Config:
    """Parse CLI args into a Config and apply log level / search path."""
    cfg = Config.from_args(list(argv))
    level = cfg.read_string("log_level", default=None)
    if level:
        logs.set_log_level(level)
    log_file = cfg.read_string("log_file", default=None)
    if log_file:
        logs.set_log_file(log_file)
    pp = cfg.read_string("prepend_path", default=None)
    if pp:
        prepend_search_directory(pp)
    ap = cfg.read_string("append_path", default=None)
    if ap:
        append_search_directory(ap)
    return cfg


def read_string_list(cfg: Config, key: str) -> List[str]:
    """Iterate a space-separated list the reference way (index until None)."""
    out = []
    i = 0
    while True:
        val = cfg.read_string(key, i, default=None)
        if val is None:
            break
        out.append(val)
        i += 1
    return out


class maybe_profile:
    """Context manager: when the ``profile_dir`` config key is set, trace
    the CPU and (with a card) CUDA activity with ``torch.profiler`` and
    write a Chrome trace to ``profile_dir/trace.json`` (the counterpart of
    the JAX tools' ``jax.profiler`` trace, SURVEY.md §5), with the port's
    spans (:func:`~ecckd_tpu_torch.logs.span`) of every thread added as
    the process "ecckd spans", one ``tid`` per thread, on the trace's
    clock: the band threads' and the prefetch thread's too, which the
    profiler does not see."""

    def __init__(self, cfg: Optional[Config]):
        self.trace_dir = (cfg.read_string("profile_dir", default=None)
                          if cfg is not None else None)
        self.prof = None

    def __enter__(self):
        if self.trace_dir:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            logs.clear_spans()
            self.prof = profile(activities=activities)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir, "trace.json")
            self.prof.export_chrome_trace(path)
            _add_spans(path, logs.spans())
            logs.clear_spans()
            logs.log(f"Profile written to {path}")


def _add_spans(path: str, spans) -> None:
    """Add ``spans`` (:func:`ecckd_tpu_torch.logs.spans`) to the Chrome
    trace at ``path`` as complete events of the process "ecckd spans", one
    ``tid`` per thread (its native id), each with its id, its parent's and
    its core call's.  Their clock is put on the trace's by the median, over
    the main thread's spans, of the profiler's start of a span less the
    recorded start: the k-th span of a name against the profiler's k-th
    event of that name."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    profiled = {}
    for e in sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") == "cpu_op"
                     and e["name"].startswith("ecckd.")),
                    key=lambda e: e["ts"]):
        profiled.setdefault(e["name"], []).append(e["ts"])
    main = threading.main_thread().native_id
    recorded = {}
    for sp in sorted(spans, key=lambda sp: sp.start_ns):
        if sp.thread == main:
            recorded.setdefault(sp.name, []).append(sp.start_ns / 1e3)
    offsets = [t - r for name, ts in profiled.items()
               for t, r in zip(ts, recorded.get(name, ()))]
    if not offsets:
        return
    offset = statistics.median(offsets)
    pid = "ecckd spans"
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": pid}})
    for thread in sorted({sp.thread for sp in spans}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": thread, "args": {
                           "name": f"thread {thread}"
                           + (" (main)" if thread == main else "")}})
    events.extend({"ph": "X", "cat": "ecckd_span", "name": sp.name,
                   "pid": pid, "tid": sp.thread,
                   "ts": sp.start_ns / 1e3 + offset,
                   "dur": (sp.end_ns - sp.start_ns) / 1e3,
                   "args": {"id": sp.id, "parent": sp.parent,
                            "call": sp.call}} for sp in spans)
    with open(path, "w") as f:
        json.dump(trace, f)


def netcdf_format(cfg: Optional[Config]) -> str:
    """The NetCDF container a tool writes, from the ``netcdf_format`` key:
    ``netcdf4`` (the default, through h5py) or ``classic`` (CDF-2, through
    scipy, for a machine without h5py).  No tool picks classic by itself:
    writing NetCDF-4 without h5py raises."""
    fmt = "netcdf4" if cfg is None else cfg.read_string(
        "netcdf_format", default="netcdf4")
    if fmt not in FORMATS:
        raise ValueError(f"netcdf_format={fmt!r} not understood; choose "
                         f"from {list(FORMATS)}")
    return fmt


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`.  The tools and their array
    cores compute on the card unless asked for the CPU: asking for CUDA
    without a card raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but no CUDA "
                           "device is available (pass device=\"cpu\" to run "
                           "on the CPU)")
    return dev


def device_tensor(a, device, dtype) -> torch.Tensor:
    """``a`` (numpy, a sequence or a CPU tensor) as a ``dtype`` tensor on
    ``device``, converted on the host."""
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def setup(cfg: Optional[Config] = None) -> Tuple[torch.device, torch.dtype]:
    """(device, dtype) of a tool run, from the ``device`` key (default
    ``cuda``) and the ``precision`` key (``float64`` by default, as the
    JAX tools; ``float32`` on request).

    TF32 is switched off for matmuls and cuDNN: every membership and
    one-hot matmul of the port must be exact (a TF32 product keeps ten
    mantissa bits, the GPU twin of the bf16 split-dot fault of the JAX
    package).  Asking for CUDA without a card raises instead of running
    on the CPU."""
    device = "cuda"
    precision = "float64"
    if cfg is not None:
        device = cfg.read_string("device", default="cuda")
        precision = cfg.read_string("precision", default="float64")
    if precision not in _DTYPES:
        raise ValueError(f"precision={precision!r} not understood; choose "
                         f"from {sorted(_DTYPES)}")
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev, _DTYPES[precision]


def sharded_mesh(value, device: torch.device, tool: str):
    """The spectral mesh of a tool's ``sharded`` key, or None (the JAX
    tools' rule, ``ecckd_tpu/tools/find_g_points.py:301-316`` and
    ``create_lut.py:88-97``, with cards for its devices): "0"/"no"/"false"
    never; "auto" (the default) a mesh over every visible card where that
    makes more than one shard, never on the CPU; "1"/"yes"/"true" a mesh
    over the visible cards, one shard with one card.  On the CPU
    ``sharded=1`` raises: a mesh of logical CPU shards is given to the
    array cores (``mesh=make_mesh(devices=[...])``).  Under
    ``torch.distributed`` the mesh spans every process's card."""
    from ..parallel.mesh import make_mesh
    key = str(value).lower()
    if key in ("0", "no", "false"):
        return None
    if key not in ("1", "yes", "true", "auto"):
        raise ValueError(f"{tool}: sharded={value!r} not understood; choose "
                         "auto, 1 or 0")
    if device.type != "cuda":
        if key == "auto":
            return None
        raise ValueError(f"{tool}: sharded=1 shards over cards, and device "
                         f"is {device}; on the CPU pass a mesh of logical "
                         "shards to the array core instead")
    mesh = make_mesh(data_parallel=1)
    if key == "auto" and mesh.size < 2:
        return None
    logs.log(f"Sharding over {mesh.shape['spectral']} spectral shards "
             f"({mesh.size} in the mesh, {mesh.process_count} processes)")
    return mesh

