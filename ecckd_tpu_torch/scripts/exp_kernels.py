"""The round-5 kernel experiment of ``scripts/exp_kernels.py``, on a card.

Times the experimental kernels of the candidate sweep against the kernels
of the main path, on the inputs of ``bench.py``:

  sweep-v0     K1, the LW sweep with a serial recurrence per wavenumber
               (:func:`~ecckd_tpu_torch.ops.kernels.sweep_lw_intervals`)
  sweep-scan   E1, the same function by affine scans across the layers
               (:func:`~ecckd_tpu_torch.ops.kernels.sweep_lw_scan_intervals`),
               and its error against K1 on the same inputs
  isum-pallas  E2, the LW fit and truth interval sums in one specialised
               pass (:func:`~ecckd_tpu_torch.ops.kernels.
               fused_sums_lw_intervals`), its error against the general
               fused sums K3 on the same five parts, and K3's time

Usage::

  python -m ecckd_tpu_torch.scripts.exp_kernels [variants...] [device=cpu]
      [precision=float64]

The command line reads ``EX_NWAV`` (wavenumbers, default 2^20) and
``EX_ITERS`` (timed launches, default 20) from the environment; :func:`main`
takes them as arguments.  The dtype is float32 unless
``precision=float64``.  On the card each time is the mean over back-to-back
launches by CUDA events; with ``device=cpu`` the wrappers run their plain
versions and the times are the host clock's.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..constants import LW_DIFFUSIVITY
from ..ops.average import fit_optical_depth_lw
from ..ops.kernels import (fused_interval_sum, fused_sums_lw_intervals,
                           sweep_lw_intervals, sweep_lw_scan_intervals)
from ..ops.planck import planck_function
from ..ops.segments import part_of
from ..tools.common import resolve_device

VARIANTS = ("sweep-v0", "sweep-scan", "isum-pallas")
NLAY = 50
NSEG = 64
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_inputs(nlay, nwav, nseg, dtype, device):
    """The benchmark's synthetic LW band (``bench.py:build_inputs``): the
    same numpy draws from ``default_rng(0)``, the Planck function computed
    in float64 on ``device``, every float cast to ``dtype`` and the
    interval tables to int32, as tensors on ``device``."""
    rng = np.random.default_rng(0)
    pressure_hl = np.exp(np.linspace(np.log(100.0), np.log(1.0e5),
                                     nlay + 1))
    wav = np.linspace(10.0, 3000.0, nwav)
    k = np.sort(10.0 ** rng.uniform(-4, 2, nwav))
    col = (pressure_hl[1:] - pressure_hl[:-1]) / pressure_hl[-1]
    od = np.outer(col, k)
    bg_od = 0.05 * col[:, None] * np.ones((1, nwav))
    t_hl = np.linspace(210.0, 290.0, nlay + 1)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    planck_hl = planck_function(f64(t_hl), f64(wav),
                                f64(np.full(nwav, wav[1] - wav[0])))
    metric = -np.expm1(-LW_DIFFUSIVITY * od)
    hr = rng.normal(0.0, 1e-5, (nlay, nwav))
    layer_weight = np.sqrt(pressure_hl[1:]) - np.sqrt(pressure_hl[:-1])
    layer_weight /= layer_weight.sum()
    edges = np.linspace(0, nwav, nseg + 1).astype(np.int32)
    seg_of_wav = np.repeat(np.arange(nseg, dtype=np.int32), np.diff(edges))
    cast = lambda a: torch.as_tensor(a, device=device).to(dtype)
    ints = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return dict(
        layer_weight=cast(layer_weight), pressure_hl=cast(pressure_hl),
        surf_emissivity=cast(np.ones(nwav)),
        surf_planck=cast(planck_hl[-1] * 1.05),
        flux_dn_surf=cast(planck_hl[-1] * 0.5),
        flux_up_toa=cast(planck_hl[0] * 0.8), planck_hl=cast(planck_hl),
        bg_od=cast(bg_od), metric=cast(metric), hr=cast(hr),
        i1=ints(edges[:-1]), i2=ints(edges[1:] - 1),
        seg_of_wav=ints(seg_of_wav))


def time_ms(fn, iters, device):
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls after
    one warm-up call: CUDA events on a card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def max_rel_err(got, want):
    """The script's measure: largest absolute difference over the largest
    magnitude of the reference, worst over the outputs."""
    return max(float((g - w).abs().max() / (w.abs().max() + 1e-30))
               for g, w in zip(got, want))


def main(variants=VARIANTS, device="cuda", dtype=torch.float32,
         nwav=1 << 20, iters=20, out=print):
    """Run the variants and print one line each; return the inputs and,
    per variant, its outputs, its reference's, the error and the times."""
    device = resolve_device(device)
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}; choose from "
                         f"{list(VARIANTS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    d = build_inputs(NLAY, nwav, NSEG, dtype, device)
    clock = ("CUDA events" if device.type == "cuda"
             else "host clock, plain versions")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    out(f"device={device.type} ({name}) nwav={nwav} nlay={NLAY} "
        f"nseg={NSEG} dtype={str(dtype).removeprefix('torch.')} "
        f"iters={iters}")
    planck, i1, i2 = d["planck_hl"], d["i1"], d["i2"]
    od_fit = fit_optical_depth_lw("transmission", planck, d["metric"], i1, i2)
    sweep_args = (planck, d["bg_od"], od_fit, d["seg_of_wav"],
                  d["surf_emissivity"], d["surf_planck"], i1, i2)
    res = {"inputs": d, "od_fit": od_fit}

    if "sweep-v0" in variants:
        ms = time_ms(lambda: sweep_lw_intervals(*sweep_args), iters, device)
        out(f"sweep-v0 (K1, serial recurrence per wavenumber): {ms:.4f} ms "
            f"({clock})")
        res["sweep-v0"] = dict(ms=ms)

    if "sweep-scan" in variants:
        ref = sweep_lw_intervals(*sweep_args)
        got = sweep_lw_scan_intervals(*sweep_args)
        err = max_rel_err(got, ref)
        out(f"sweep-scan max rel err vs sweep-v0: {err:.3e}")
        ms = time_ms(lambda: sweep_lw_scan_intervals(*sweep_args), iters,
                     device)
        out(f"sweep-scan (E1, affine scans across layers): {ms:.4f} ms "
            f"({clock})")
        res["sweep-scan"] = dict(got=got, ref=ref, err=err, ms=ms)

    if "isum-pallas" in variants:
        m, hr = d["metric"], d["hr"]
        fds, fut = d["flux_dn_surf"], d["flux_up_toa"]
        w_num = planck[1:]
        k3 = lambda: fused_interval_sum(
            [part_of(m, w_num), part_of(w_num), part_of(hr), part_of(fds),
             part_of(fut)], nwav, i1, i2, dtype=dtype)
        e2 = lambda: fused_sums_lw_intervals(m, planck, hr, fds, fut, i1, i2)
        ref, got = k3(), e2()
        err = max_rel_err((got,), (ref,))
        out(f"isum-pallas max rel err vs K3: {err:.3e}")
        ms = time_ms(e2, iters, device)
        out(f"isum-pallas (E2, fused LW fit+truth sums): {ms:.4f} ms "
            f"({clock})")
        k3_ms = time_ms(k3, iters, device)
        out(f"isum-K3 same rows (general fused sums): {k3_ms:.4f} ms "
            f"({clock})")
        res["isum-pallas"] = dict(got=got, ref=ref, err=err, ms=ms,
                                  k3_ms=k3_ms)
    return res


def _cli(argv):
    keys = dict(a.split("=", 1) for a in argv if "=" in a)
    variants = [a for a in argv if "=" not in a] or list(VARIANTS)
    precision = keys.get("precision", "float32")
    if precision not in _DTYPES:
        raise ValueError(f"precision={precision!r} not understood; choose "
                         f"from {sorted(_DTYPES)}")
    main(variants, device=keys.get("device", "cuda"),
         dtype=_DTYPES[precision],
         nwav=int(os.environ.get("EX_NWAV", 1 << 20)),
         iters=int(os.environ.get("EX_ITERS", 20)))
    return 0


if __name__ == "__main__":
    sys.exit(_cli(sys.argv[1:]))
