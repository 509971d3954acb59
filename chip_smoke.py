"""Drive the PyTorch/CUDA port's generation chains, and the optimisation
and evaluation of their models, on one GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout,
on a machine with one NVIDIA Hopper card.  It needs neither jax nor h5py,
and builds the port's CUDA kernels from ``ecckd_tpu_torch/csrc`` at first
use.

Phases (every failed check raises; nothing is caught):
  1. the card's name and power limit;
  2. the kernel build, the normal library and the checked one (index
     checks that trap, ``_build.checked()``) from one parallel nvcc run,
     with each kernel's registers and spills (none in the sweeps K1, K2
     and E1 of the normal build);
  3. kernels K1 (LW sweep), K2 (SW sweep, with and without the reflected
     beam) and K3 (fused interval sum, on the LW fit and truth rows and on
     the 255 rows of the SW total-transmission launch) against their plain
     PyTorch versions at pipeline shapes (2^20 wavenumbers, 50 layers, 64
     intervals), float64 and float32, with CUDA-event times; K3's sums of
     each interval bit-identical launched alone, in a launch with the
     intervals reversed and the pads removed, and in a repeat; K1's,
     K2's and E1's sums bit-identical in a repeat and, permuted, in a
     launch with the intervals permuted;
  4. the small test rigs (1024 wavenumbers, 15 layers; LW, and SW over two
     bands) through the array cores of reorder -> find_g_points ->
     create_lut on the CPU (plain versions) and twice on the card
     (kernels): identical g-point ranks, bit-identical repeats; and the
     card's float32 chain held against its float64 chain
     (``ecckd_tpu_torch.scripts.precision``, as tests/test_torch_precision.py
     does on the CPU);
  5. the LW main path at full size: a CKDMIP-shaped synthetic LW spectrum
     of 2^20 wavenumbers x 50 layers (5 temperature profiles) through the
     same cores, with the checks of tests/test_find_g_points.py and the
     host time of the interval tables (K3's and the sweeps');
  6. the SW main path at full size: a synthetic SW spectrum of 2^20
     wavenumbers x 50 layers over 250-50000 cm-1 (5 profiles) and a solar
     spectrum, two bands (the lower reflects the direct beam), the
     total-transmission search and a transmission-averaged LUT;
  7. each main path once more under ``torch.profiler``: wall and device
     seconds, the device time of the costliest kernels and copies and the
     host time of the costliest operators;
  8. create_lut -> optimize_lut -> run_ckd on the card: LW training
     fluxes from the LW main path's profiles (the port's Planck function
     and ``rt_lw`` over the spectrum, summed per g-point), then
     ``optimize_lut_core`` (scipy L-BFGS-B, at most 60 iterations, prior
     error 4) on its model and ``run_ckd_core`` before and after: the cost
     and the heating-rate and surface-downwelling errors must fall; the
     training step at bench.py's production size (ng 64, nt 6, np 53, 48
     columns, 50 layers, an o3 gas in LUT mode added) and the SW main
     path's model with Rayleigh active: value and gradient on the card
     within 1e-10 of the CPU (float64) and bit-identical in a repeat,
     float32 within PARITY.md's 1e-3, with milliseconds, kernel launches
     and the device's idle share per evaluation;
  9. the experiment path of ``scripts/exp_kernels.py`` as ported
     (``ecckd_tpu_torch.scripts.exp_kernels.main``, all three variants, at
     2^20 x 50 x 64 in float32 and float64): E1 (LW sweep by scans across
     layers) against K1, E2 (fused LW fit and truth sums) bit-identical
     to K3, both against their plain versions, with kernel, plain,
     yardstick and library times;
  10. phases 3, 4 and 9 again on the checked build: any index outside its
      range traps and fails the run; the kernel times beside the normal
      build's.
Launch counts are set to 0 just before each main path and read just after.
No module of jax or of the JAX package ``ecckd_tpu`` may be imported.  The
last line is a JSON object with "ok" and the device; the line before it
lists each kernel with its launches on the main paths, error, times and
the bound of its work on the card (K2 twice: ``sweep_sw`` with the
reflected beam, ``sweep_sw_noup`` without, each with its own launches).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

NWAV_FULL = 1 << 20
NLAY_FULL = 50
NCOL_FULL = 5
HR_TOL = 0.2
# SW heating-rate tolerance (K/day): 4-16 g-points in each band of the SW
# main path's spectrum
HR_TOL_SW = 0.5
SW_BANDS = ([250.0, 10000.0], [10000.0, 50000.0])
BARS = {torch.float64: 1e-10, torch.float32: 1e-5}
# The least time of a kernel's work: its bytes (each input read once, each
# output written once) over the H100 SXM's device memory rate, or its
# operations over the peak rate outside the tensor cores (float32 and float64
# from NVIDIA's H100 SXM data sheet), whichever is longer.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
# Operations per layer and wavenumber of the LW sweep (od, emissivity and
# factor with their clamps, two sources, two recurrences), of the SW
# direct beam (od, running sum, product by the secant, exp, product) and
# of the SW sweep with its reflected beam (two running sums, two exps and
# products).
LW_LAYER_OPS = 21
SW_DOWN_LAYER_OPS = 5
SW_LAYER_OPS = 9


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def row_err(got, want):
    """(normwise relative error, absolute error), worst over output rows;
    an all-zero row counts by its absolute error."""
    diff = (got - want).double()
    num = diff.norm(dim=1)
    den = want.double().norm(dim=1)
    rel = torch.where(den > 0, num / den.clamp(min=1e-300), num)
    return float(rel.max()), float(diff.abs().max())


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def memberships(i1, i2, n):
    """Wavenumbers summed over all intervals, each counted once for every
    interval that holds it."""
    lo = np.maximum(np.asarray(i1, np.int64), 0)
    hi = np.minimum(np.asarray(i2, np.int64), n - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def bound(nbytes, ops, dtype):
    """(bound_ms, bound_by) of ``nbytes`` moved and ``ops`` done."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / PEAK_OPS_PER_S[dtype]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def lw_sweep_bound(args):
    """Bound of K1 and E1 on (planck, bg_od, od_fit, seg, emis, surfp, i1,
    i2): one read of every input, the two flux rows per level written."""
    planck, bg_od, od_fit, seg, emis, surfp, i1, i2 = args
    nlay, n = bg_od.shape
    nseg = i1.shape[0]
    es = planck.element_size()
    nbytes = (es * (planck.numel() + bg_od.numel() + od_fit.numel() + 2 * n
                    + 2 * (nlay + 1) * nseg) + 4 * (n + 2 * nseg))
    ops = (LW_LAYER_OPS * nlay * n
           + 2 * (nlay + 1) * memberships(i1.cpu(), i2.cpu(), n))
    return bound(nbytes, ops, planck.dtype)


def row_sums_bound(rows, nwav, nprod, i1, i2, dtype):
    """Bound of K3 and E2: ``rows`` operand rows read once, ``nprod``
    products per wavenumber, each output row summed per interval."""
    es = torch.empty((), dtype=dtype).element_size()
    nseg = len(i1)
    nbytes = es * (rows * nwav + rows * nseg) + 4 * 2 * nseg
    ops = nprod * nwav + rows * memberships(i1, i2, nwav)
    return bound(nbytes, ops, dtype)


def membership_matmul_ms(rows, i1, i2):
    """One ``torch.matmul`` of stacked rows by the 0/1 (nwav, nseg)
    membership, built outside the timed region: the contraction the Pallas
    sum kernels perform, without forming the rows."""
    idx = torch.arange(rows.shape[1], device=rows.device)[:, None]
    member = ((idx >= i1.long()[None, :]) & (idx <= i2.long()[None, :])
              ).to(rows.dtype)
    ms = cuda_ms(lambda: torch.matmul(rows, member), 10)
    del member
    return ms


# ---------------------------------------------------------------- inputs

def equipartition_like_bounds(n, nreal, npad):
    """Front-padded [0, 0] bucket columns, then ``nreal`` contiguous
    intervals whose lengths grow as the cube of their index (a few
    wavenumbers at the transparent end, tens of thousands at the opaque
    end), one pair sharing a boundary index."""
    edges = np.round(np.linspace(0.0, 1.0, nreal + 1) ** 3 * n)
    edges = edges.astype(np.int64)
    i1 = edges[:-1].copy()
    i2 = edges[1:] - 1
    k = nreal // 2
    i2[k] = i1[k + 1]                       # a shared boundary index
    pad = np.zeros(npad, np.int64)
    return (np.r_[pad, i1].astype(np.int32),
            np.r_[pad, i2].astype(np.int32))


def lw_spectrum(nwav, nlay, ncol, seed, nlines, width, wav_max,
                wav_min=1.0, width_unit=None):
    """Synthetic spectrum as tests/synth.py and bench.py write it (lines of
    varying strength on a continuum; od stored as float32 and read back
    as float64), one profile per column with warmer columns.  Line widths
    are drawn from ``width`` in units of ``width_unit`` cm-1 (by default
    the span over ``wav_max``, as bench.py has it)."""
    rng = np.random.default_rng(seed)
    p_hl = np.exp(np.linspace(np.log(100.0), np.log(1.013e5), nlay + 1))
    wav = np.linspace(wav_min, wav_max, nwav)
    dwav = np.gradient(wav)
    k = np.full(nwav, 1e-4)
    span = wav[-1] - wav[0]
    centres = rng.uniform(wav[0], wav[-1], nlines)
    strengths = 10.0 ** rng.uniform(-1, 3.5, nlines)
    unit = span / wav_max if width_unit is None else width_unit
    widths = rng.uniform(*width, nlines) * unit
    for c0, s, wd in zip(centres, strengths, widths):
        k += s / (1.0 + ((wav - c0) / wd) ** 2)
    col_mass = np.diff(p_hl) / 9.80665 / 0.02897
    profiles = []
    for icol in range(ncol):
        t_hl = np.linspace(210.0 + 8 * icol, 284.0 + 8 * icol, nlay + 1)
        tfact = np.exp(0.02 * (t_hl[1:, None] - 250.0))
        od = (0.01 * col_mass[:, None] * 1e-3 * k[None, :] * tfact)
        profiles.append(SimpleNamespace(
            pressure_hl=p_hl, temperature_hl=t_hl, wavenumber=wav,
            d_wavenumber=dwav, optical_depth=od.astype(np.float32)
            .astype(np.float64), ncol=ncol))
    return profiles


def sw_spectrum(nwav, nlay, ncol, seed, nlines=60):
    """Synthetic SW spectrum as tests/synth.py writes it with is_sw (250 to
    50000 cm-1, line widths scaled to the span) and the solar spectrum of
    its synth_ssi_file, normalised to 1361 W m-2."""
    profiles = lw_spectrum(nwav, nlay, ncol, seed, nlines, (2.0, 30.0),
                           50000.0, wav_min=250.0,
                           width_unit=(50000.0 - 250.0) / 2000.0)
    wav = profiles[0].wavenumber
    ssi = 20.0 * np.exp(-((wav - 20000.0) / 15000.0) ** 2) + 0.5
    return profiles, ssi * (1361.0 / ssi.sum())


# ---------------------------------------------------------------- phases

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi


def kernel_resources(build_log):
    """(mangled name, registers, spill stores + loads in bytes) of each
    kernel in nvcc's ``-Xptxas -v`` report."""
    out = []
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        name = line.split("'")[1]
        regs = spill = None
        for nxt in lines[i + 1:i + 5]:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          nxt)
            if m:
                spill = int(m[1]) + int(m[2])
            m = re.search(r"Used (\d+) registers", nxt)
            if m:
                regs = int(m[1])
        out.append((name, regs, spill))
    return out


def phase_build():
    from ecckd_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.prebuild()
    log(f"[build] normal and checked libraries {time.perf_counter() - t0:.2f}"
        f" s (nvcc {_build.build_seconds:.2f} s)")
    for tag, build_log in (("", _build.build_log),
                           ("checked ", _build.checked_build_log)):
        for name, regs, spill in kernel_resources(build_log):
            log(f"[build]   {tag}{name[:72]}: {regs} registers, {spill} "
                "bytes spilled")
            if not tag and any(k in name for k in (
                    "sweep_lw_kernel", "sweep_sw_kernel",
                    "sweep_lw_scan_kernel")):
                check(spill == 0, f"no spills in {name}")


def sw_total_trans_parts(ssi, bg_od, od, h, fd, up):
    """The parts of the SW main path's K3 launch with total-transmission
    (ops/average.py:total_trans_fit_parts and partition/cost_kernel.py):
    the 2*nlay+1 direct-flux levels, od*ssi, and the LOW and HIGH truth
    sets (heating rates and two boundary fluxes, scaled 0.5 and 2.5):
    5*nlay + 5 output rows from 5*nlay + 6 operand rows."""
    from ecckd_tpu_torch.ops.average import total_trans_fit_parts
    from ecckd_tpu_torch.ops.segments import part_of
    fit = total_trans_fit_parts(ssi, bg_od, od)[0]
    return fit + [part_of(a * scale) for scale in (0.5, 2.5)
                  for a in (h, fd, up)]


def check_batch_independent(parts, n, i1, i2, npad, tag):
    """K3's sums of every interval are the same bits in the launch of all
    of them, alone, in a launch with the intervals reversed and the pads
    removed, and in a repeat."""
    from ecckd_tpu_torch.ops.kernels import fused_interval_sum
    whole = fused_interval_sum(parts, n, i1, i2)
    check(torch.equal(whole, fused_interval_sum(parts, n, i1, i2)),
          f"interval_sum {tag}: repeats bit-identical")
    rev = torch.arange(len(i1) - 1, npad - 1, -1, device=i1.device)
    flipped = fused_interval_sum(parts, n, i1[rev], i2[rev])
    check(torch.equal(flipped, whole[:, rev]),
          f"interval_sum {tag}: reversed launch without pads bit-identical")
    for j in range(len(i1)):
        alone = fused_interval_sum(parts, n, i1[j:j + 1], i2[j:j + 1])
        check(torch.equal(alone, whole[:, j:j + 1]),
              f"interval_sum {tag}: interval {j} alone bit-identical")
    log(f"[kernels] interval_sum {tag}: each of {len(i1)} intervals "
        "bit-identical alone, reversed without pads and repeated")


def permute_intervals(od_fit, seg, i1, i2, perm):
    """The intervals in the order ``perm``: the bounds and od_fit's
    columns permuted, seg remapped to the new columns (ranks outside every
    fit stay outside)."""
    nseg = len(perm)
    perm = torch.as_tensor(perm, device=i1.device)
    new_of = torch.empty_like(perm)
    new_of[perm] = torch.arange(nseg, device=i1.device)
    inside = (seg >= 0) & (seg < nseg)
    seg = torch.where(inside, new_of[seg.long().clamp(0, nseg - 1)]
                      .to(torch.int32), seg)
    return (od_fit[:, perm].contiguous(), seg, i1[perm].contiguous(),
            i2[perm].contiguous())


def check_sweeps_batch_independent(sweep_args, sw_args, tag):
    """K1's, K2's and E1's sums of every interval do not depend on the
    other intervals of the launch: a repeat gives the same bits, and a
    launch with the intervals permuted the same bits permuted."""
    from ecckd_tpu_torch.ops.kernels import (sweep_lw_intervals,
                                             sweep_lw_scan_intervals,
                                             sweep_sw_intervals)
    perm = np.random.default_rng(3).permutation(len(sweep_args[6]))
    lw = list(sweep_args)
    lw[2], lw[3], lw[6], lw[7] = permute_intervals(
        sweep_args[2], sweep_args[3], sweep_args[6], sweep_args[7], perm)
    sw = list(sw_args)
    sw[2], sw[3], sw[4], sw[5] = permute_intervals(*sw_args[2:6], perm)
    for name, run, moved, args in (
            ("sweep_lw", lambda a: sweep_lw_intervals(*a), lw, sweep_args),
            ("sweep_lw_scan", lambda a: sweep_lw_scan_intervals(*a), lw,
             sweep_args),
            ("sweep_sw_up", lambda a: sweep_sw_intervals(*a, True), sw,
             sw_args),
            ("sweep_sw_noup", lambda a: sweep_sw_intervals(*a, False), sw,
             sw_args)):
        first = run(args)
        check(all(torch.equal(a, b) for a, b in zip(first, run(args))),
              f"{name} {tag}: repeats bit-identical")
        check(all(torch.equal(a[:, perm], b)
                  for a, b in zip(first, run(moved))),
              f"{name} {tag}: permuted launch gives the permuted sums "
              "bit for bit")
    log(f"[kernels] sweep_lw, sweep_lw_scan, sweep_sw_up, sweep_sw_noup "
        f"{tag}: repeats "
        f"and a launch with the {len(perm)} intervals permuted "
        "bit-identical")


def phase_kernels(dev, checked=False):
    """K1, K2 (both variants) and K3 (LW and SW rows) against their plain
    versions at pipeline shapes; ``checked``: on the checked build, with
    the kernels' times only."""
    from ecckd_tpu_torch.ops.kernels import (fused_interval_sum,
                                             sweep_lw_intervals,
                                             sweep_lw_plain,
                                             sweep_sw_intervals,
                                             sweep_sw_plain)
    from ecckd_tpu_torch.ops.segments import interval_sum_fused, part_of

    n, nlay = NWAV_FULL, NLAY_FULL
    i1, i2 = equipartition_like_bounds(n, 58, 6)
    check(len(i1) == 64, f"64 intervals (got {len(i1)})")
    rng = np.random.default_rng(17)
    planck = np.abs(rng.normal(5, 1, (nlay + 1, n)))
    bg_od = rng.gamma(0.5, 0.4, (nlay, n))
    od_fit = rng.gamma(0.5, 0.4, (nlay, len(i1)))
    metric = -np.expm1(-1.66 * rng.gamma(0.5, 1.0, (nlay, n)))
    hr = rng.normal(0.0, 1e-5, (nlay, n))
    emis = rng.uniform(0.9, 1.0, n)
    surfp = np.abs(rng.normal(8, 1, n))
    fd = np.abs(rng.normal(1, 0.2, n))
    # SW: direct beam through a thinner column, so the surface fluxes that
    # the reflected beam starts from are not all negligible
    ssi = np.abs(rng.normal(1.0, 0.3, n))
    sw_bg_od = rng.gamma(0.5, 0.02, (nlay, n))
    sw_od_fit = rng.gamma(0.5, 0.02, (nlay, len(i1)))
    albedo = np.where(np.arange(n) < n // 2, 0.15, 0.0)
    seg = np.maximum(0, np.searchsorted(i1, np.arange(n), side="right")
                     - 1).astype(np.int32)
    out = {}
    for dtype in (torch.float64, torch.float32):
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        it = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
        sweep_args = (f(planck), f(bg_od), f(od_fit), it(seg), f(emis),
                      f(surfp), it(i1), it(i2))
        sw_args = (f(ssi), f(sw_bg_od), f(sw_od_fit), it(seg), it(i1),
                   it(i2), 0.5, f(albedo))
        w_num = sweep_args[0][1:]
        m, h, fdt = f(metric), f(hr), f(fd)
        parts = [part_of(m, w_num), part_of(w_num), part_of(h),
                 part_of(fdt), part_of(sweep_args[4])]
        sw_parts = sw_total_trans_parts(sw_args[0], sw_args[1], f(metric),
                                        h, fdt, sweep_args[4])
        tag = "f64" if dtype == torch.float64 else "f32"
        res = {}
        for name, kern, plain in (
                ("sweep_lw", lambda: sweep_lw_intervals(*sweep_args),
                 lambda: sweep_lw_plain(*sweep_args)),
                ("sweep_sw_up", lambda: sweep_sw_intervals(*sw_args, True),
                 lambda: sweep_sw_plain(*sw_args, True)),
                ("sweep_sw_noup", lambda: sweep_sw_intervals(*sw_args, False),
                 lambda: sweep_sw_plain(*sw_args, False)),
                ("interval_sum",
                 lambda: (fused_interval_sum(parts, n, sweep_args[6],
                                             sweep_args[7]),),
                 lambda: (interval_sum_fused(parts, n, sweep_args[6],
                                             sweep_args[7]),)),
                ("interval_sum_sw",
                 lambda: (fused_interval_sum(sw_parts, n, sweep_args[6],
                                             sweep_args[7]),),
                 lambda: (interval_sum_fused(sw_parts, n, sweep_args[6],
                                             sweep_args[7]),))):
            got, want = kern(), plain()
            torch.cuda.synchronize()
            errs = [row_err(g, w) for g, w in zip(got, want)]
            rel = max(e[0] for e in errs)
            absolute = max(e[1] for e in errs)
            ms = cuda_ms(kern, 10)
            plain_ms = None if checked else cuda_ms(plain, 3)
            log(f"[kernels] {name} {tag}: max rel err (normwise per row) "
                f"{rel:.3e} (bar {BARS[dtype]:.0e}), max abs err "
                f"{absolute:.3e}; kernel {ms:.3f} ms, plain {plain_ms} "
                f"ms (CUDA events)")
            check(rel <= BARS[dtype], f"{name} {tag} within {BARS[dtype]}")
            res[name] = dict(max_abs_err=absolute, max_rel_err=rel, ms=ms,
                             plain_ms=plain_ms, library_ms=None)
        check_batch_independent(parts, n, sweep_args[6], sweep_args[7], 6,
                                f"LW rows {tag}")
        check_sweeps_batch_independent(sweep_args, sw_args, tag)
        out[tag] = res
        if checked:
            continue
        rows = torch.cat([m * w_num, w_num, h, fdt[None], sweep_args[4][None]])
        res["interval_sum"]["library_ms"] = membership_matmul_ms(
            rows, sweep_args[6], sweep_args[7])
        del rows
        rows = torch.cat([p(0, n) for p in sw_parts])
        check(rows.shape[0] == 5 * nlay + 5, "255 SW rows")
        res["interval_sum_sw"]["library_ms"] = membership_matmul_ms(
            rows, sweep_args[6], sweep_args[7])
        del rows
        nseg = len(i1)
        es = torch.finfo(dtype).bits // 8
        # K2 with the reflected beam: ssi, bg_od, od_fit, albedo and the two
        # flux rows per level; without: ssi, bg_od, od_fit and one row
        sw_bytes = (es * (2 * n + nlay * n + nlay * nseg
                          + 2 * (nlay + 1) * nseg) + 4 * (n + 2 * nseg))
        sw_down_bytes = (es * (n + nlay * n + nlay * nseg + (nlay + 1) * nseg)
                         + 4 * (n + 2 * nseg))
        for name, (b, by) in (
                ("sweep_lw", lw_sweep_bound(sweep_args)),
                ("sweep_sw_up", bound(
                    sw_bytes, SW_LAYER_OPS * nlay * n
                    + 2 * (nlay + 1) * memberships(i1, i2, n), dtype)),
                ("sweep_sw_noup", bound(
                    sw_down_bytes, SW_DOWN_LAYER_OPS * nlay * n
                    + (nlay + 1) * memberships(i1, i2, n), dtype)),
                ("interval_sum", row_sums_bound(3 * nlay + 2, n, nlay, i1,
                                                i2, dtype)),
                ("interval_sum_sw", row_sums_bound(5 * nlay + 6, n, nlay, i1,
                                                   i2, dtype))):
            res[name].update(bound_ms=b, bound_by=by)
            log(f"[kernels] {name} {tag}: bound {b:.4f} ms ({by}), kernel "
                f"{res[name]['ms'] / b:.1f}x the bound; library "
                f"{res[name]['library_ms']}")
        del sw_parts
    return out


def run_chain(profiles, device, hr_tol, lut_profiles=None, ssi=None,
              bands=(None, None)):
    """reorder -> find_g_points -> create_lut through the array cores;
    returns (order, g-points, model, seconds per stage).  LW: transmission
    search and LUT.  SW (``ssi`` given): total-transmission search with
    the h2o scalings 0.5 and 2.5, transmission-averaged LUT."""
    from ecckd_tpu_torch.config import Config
    from ecckd_tpu_torch.models import ConcDependence
    from ecckd_tpu_torch.tools.common import setup
    from ecckd_tpu_torch.tools.create_lut import (LutGas, SolarSpectrum,
                                                  create_lut_core)
    from ecckd_tpu_torch.tools.find_g_points import (GasInput,
                                                     find_g_points_core)
    from ecckd_tpu_torch.tools.reorder_spectrum import reorder_core

    dev, dtype = setup(Config({"device": device}))
    sw = ssi is not None
    sp = profiles[0]
    secs = {}

    def timed(stage, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs[stage] = time.perf_counter() - t0
        return out

    order = timed("reorder", lambda: reorder_core(
        sp.pressure_hl, sp.wavenumber, sp.d_wavenumber, sp.optical_depth,
        *bands, threshold_optical_depth=0.25 if sw else 0.5, device=dev,
        dtype=dtype, do_sw=sw))
    gas = GasInput("h2o", order["rank"], order["band_number"],
                   order["wavenumber1_band"], order["wavenumber2_band"],
                   order["sorting_variable"], sp.pressure_hl,
                   sp.temperature_hl, sp.wavenumber, sp.d_wavenumber,
                   sp.optical_depth, min_scaling=0.5, max_scaling=2.5)
    gp = timed("find_g_points", lambda: find_g_points_core(
        [gas], hr_tol,
        averaging_method="total-transmission" if sw else "transmission",
        device=dev, dtype=dtype, ssi=ssi))
    lut_profiles = profiles if lut_profiles is None else lut_profiles
    lut_gas = LutGas("h2o", ConcDependence.LINEAR,
                     [lambda icol: (lut_profiles[icol], 0.01)])
    solar = (SolarSpectrum(ssi, float(ssi.sum()), sp.wavenumber) if sw
             else None)
    model = timed("create_lut", lambda: create_lut_core(
        gp.g_point, gp.wavenumber1_band, gp.wavenumber2_band,
        gp.band_number, [lut_gas], averaging_method="transmission",
        device=dev, dtype=dtype, solar=solar,
        solar_irradiance=gp.solar_irradiance))
    return order, gp, model, secs


def check_same_runs(cpu, gpu, gpu2, what):
    """Identical order and g-point ranks on the CPU and the card, and
    bit-identical card repeats."""
    check(np.array_equal(cpu[0]["rank"], gpu[0]["rank"]),
          f"{what}: identical order ranks on CPU and card")
    for a, b, pair in ((cpu, gpu, "CPU and card"), (gpu, gpu2, "repeats")):
        ga, gb = a[1].gases[0], b[1].gases[0]
        check(np.array_equal(ga.rank1, gb.rank1)
              and np.array_equal(ga.rank2, gb.rank2)
              and np.array_equal(a[1].g_point, b[1].g_point),
              f"{what}: identical g-point ranks ({pair})")
    ga, gb = gpu[1].gases[0], gpu2[1].gases[0]
    check(np.array_equal(ga.error, gb.error)
          and np.array_equal(gpu[2].single_gas_data[0].molar_abs,
                             gpu2[2].single_gas_data[0].molar_abs),
          f"{what}: bit-identical repeat on the card")
    log(f"[small rig] {what}: ng {len(gpu[1].band_number)}, rank1 "
        f"{ga.rank1.tolist()}; CPU and card ranks identical, card repeats "
        "bit-identical")


def phase_small_rig():
    """The 1024 x 15 h2o rigs of tests/synth.py on the CPU and the card:
    LW as tests/test_torch_pipeline.py, SW over two bands as
    tests/test_torch_sw_pipeline.py; then the card's float32 chain against
    its float64 chain on both."""
    from ecckd_tpu_torch.scripts import precision
    profiles = lw_spectrum(1024, 15, 5, seed=3, nlines=60, width=(2, 30),
                           wav_max=2000.0)
    check_same_runs(*(run_chain(profiles, dev, 0.4)
                      for dev in ("cpu", "cuda", "cuda")), "LW")
    profiles, ssi = sw_spectrum(1024, 15, 6, seed=11)
    check_same_runs(*(run_chain(profiles, dev, 0.5, ssi=ssi,
                                bands=SW_BANDS)
                      for dev in ("cpu", "cuda", "cuda")), "SW two bands")
    for kind in ("lw", "sw"):
        lev, fail = precision.compare(kind, "cuda")
        log(f"[small rig] float32 against float64 on the card, {kind}: "
            f"{json.dumps(lev)}")
        check(not fail, f"float32 chain within PARITY.md's bounds ({kind}):"
              f" {fail}")


def chain_checks(what, gp, model, nwav, ncol, nlay, hr_tol):
    """The checks of tests/test_find_g_points.py on a main path's result,
    band by band."""
    g = gp.gases[0]
    ng = len(gp.band_number)
    check(g.rank1[0] == 0 and np.all(g.rank1[1:] == g.rank2[:-1] + 1)
          and np.all(g.rank2 >= g.rank1), f"{what}: contiguous g-point ranks")
    check(g.rank2[-1] == nwav - 1, f"{what}: ranks cover the spectrum")
    check(gp.g_point.min() >= 0
          and set(np.unique(gp.g_point)) == set(range(ng)),
          f"{what}: every wavenumber assigned, every g-point occupied")
    check(np.all(g.error >= 0) and g.error.max() < 2.0 * hr_tol,
          f"{what}: errors below twice the tolerance (max "
          f"{g.error.max():.4f})")
    k = model.single_gas_data[0].molar_abs
    check(k.shape == (ncol, nlay, ng), f"{what}: LUT shape {k.shape}")
    check(np.all(np.isfinite(k)) and np.all(k > 0),
          f"{what}: LUT finite, positive")
    log(f"[{what}] ng {ng} (per band {np.asarray(g.n_g_points).tolist()}); "
        f"errors {np.round(g.error, 4).tolist()}; LUT "
        f"{k.min():.3e}..{k.max():.3e}")
    return g


def timing_tables():
    """Wrap ``device_table`` where the kernels' wrappers call it, and the
    ``interval_table`` it builds with, so that their calls and host
    seconds add up by chunk (K3's 2048-wavenumber chunks, the sweeps'
    strips); returns (stats, undo)."""
    from ecckd_tpu_torch.ops.kernels import (fused_sums_lw, interval_stream,
                                             interval_sum)
    stats = {}
    real_table = interval_stream.device_table
    real_build = interval_stream.interval_table

    def add(chunk, key, t0):
        s = stats.setdefault(chunk, {"table": [0, 0.0], "build": [0, 0.0]})
        s[key][0] += 1
        s[key][1] += time.perf_counter() - t0

    def table(i1, i2, n, dev, chunk=interval_stream.CHUNK):
        t0 = time.perf_counter()
        out = real_table(i1, i2, n, dev, chunk)
        add(chunk, "table", t0)
        return out

    def build(i1, i2, n, chunk=interval_stream.CHUNK):
        t0 = time.perf_counter()
        out = real_build(i1, i2, n, chunk)
        add(chunk, "build", t0)
        return out

    mods = (interval_stream, interval_sum, fused_sums_lw)
    for m in mods:
        m.device_table = table
    interval_stream.interval_table = build

    def undo():
        for m in mods:
            m.device_table = real_table
        interval_stream.interval_table = real_build
    return stats, undo


def drive(what, profiles, hr_tol, ssi=None, bands=(None, None)):
    """One main path with the launch counts set to 0 just before it and
    read just after, and the host time of its interval tables; returns
    (g-points, model, seconds, launches)."""
    from ecckd_tpu_torch.ops.kernels import (KERNELS, reset_launch_counts,
                                             sweep_sw_intervals)
    stats, undo = timing_tables()
    reset_launch_counts()
    try:
        _, gp, model, secs = run_chain(profiles, "cuda", hr_tol, ssi=ssi,
                                       bands=bands)
    finally:
        undo()
    launches = {k.__name__: k.launches for k in KERNELS}
    launches["sweep_sw_with_upwelling"] = \
        sweep_sw_intervals.upwelling_launches
    log(f"[{what}] seconds: reorder {secs['reorder']:.2f}, find_g_points "
        f"{secs['find_g_points']:.2f}, create_lut {secs['create_lut']:.2f}, "
        f"total {sum(secs.values()):.2f}")
    log(f"[{what}] launches {launches}")
    for chunk, s in sorted(stats.items()):
        (calls, secs_all), (builds, secs_build) = s["table"], s["build"]
        log(f"[{what}] interval tables of chunk {chunk} (host clock): "
            f"{calls} calls, {builds} built; {1e3 * secs_all:.2f} ms in "
            f"all, {1e3 * secs_build:.2f} ms of it building; "
            f"{100 * secs_all / secs['find_g_points']:.2f}% of "
            "find_g_points")
    return gp, model, secs, launches


def phase_lw_main_path():
    t0 = time.perf_counter()
    profiles = lw_spectrum(NWAV_FULL, NLAY_FULL, NCOL_FULL, seed=0,
                           nlines=120, width=(2.0, 40.0), wav_max=2500.0)
    log(f"[LW main] spectrum {NWAV_FULL} x {NLAY_FULL}, {NCOL_FULL} "
        f"profiles built on the host in {time.perf_counter() - t0:.1f} s")
    gp, model, secs, launches = drive("LW main", profiles, HR_TOL)
    for name in ("sweep_lw_intervals", "fused_interval_sum"):
        check(launches[name] > 0, f"{name} launched on the LW main path")
    chain_checks("LW main", gp, model, NWAV_FULL, NCOL_FULL, NLAY_FULL,
                 HR_TOL)
    check(np.all(np.isfinite(model.planck_function))
          and np.all(model.planck_function > 0), "Planck LUT positive")
    return profiles, gp, model, launches


def phase_sw_main_path():
    t0 = time.perf_counter()
    profiles, ssi = sw_spectrum(NWAV_FULL, NLAY_FULL, NCOL_FULL, seed=11,
                                nlines=120)
    log(f"[SW main] spectrum {NWAV_FULL} x {NLAY_FULL} over 250-50000 "
        f"cm-1, {NCOL_FULL} profiles built on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    gp, model, secs, launches = drive("SW main", profiles, HR_TOL_SW,
                                      ssi=ssi, bands=SW_BANDS)
    nup = launches["sweep_sw_with_upwelling"]
    check(0 < nup < launches["sweep_sw_intervals"],
          "K2 launched with and without the reflected beam on the SW main "
          "path")
    check(launches["fused_interval_sum"] > 0,
          "fused_interval_sum launched on the SW main path")
    g = chain_checks("SW main", gp, model, NWAV_FULL, NCOL_FULL, NLAY_FULL,
                     HR_TOL_SW)
    per_band = np.asarray(g.n_g_points)
    check(len(per_band) == 2 and np.all((per_band >= 4) & (per_band <= 16)),
          f"4-16 g-points in each band (got {per_band.tolist()})")
    check(abs(gp.solar_irradiance.sum() / ssi.sum() - 1.0) < 0.02
          and abs(model.solar_irradiance.sum() / ssi.sum() - 1.0) < 0.02,
          "per-g solar irradiance sums to the SSI total within 2%")
    ray = model.rayleigh_molar_scat
    check(np.all(np.isfinite(ray)) and np.all(ray >= 0),
          "Rayleigh coefficients finite and >= 0")
    return profiles, ssi, gp, model, launches


def phase_profile(lw_profiles, sw_profiles, ssi):
    """Each main path once more under torch.profiler: wall and device
    seconds, the device time of the costliest kernels and copies, and the
    host time of the costliest operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for what, args in (("LW", (lw_profiles, "cuda", HR_TOL)),
                       ("SW", (sw_profiles, "cuda", HR_TOL_SW))):
        kw = dict(ssi=ssi, bands=SW_BANDS) if what == "SW" else {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            secs = run_chain(*args, **kw)[3]
            wall = time.perf_counter() - t0
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        device_us = sum(e.self_device_time_total for e in rows)
        log(f"[profile {what}] wall {wall:.3f} s, stages "
            f"{ {k: round(v, 3) for k, v in secs.items()} }, device time "
            f"{device_us / 1e6:.3f} s")
        for e in rows[:12]:
            log(f"[profile {what}]   {e.self_device_time_total / 1e3:9.3f} "
                f"ms {e.count:6d} x  {e.key[:90]}")
        host = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)
        for e in host[:8]:
            log(f"[profile {what}]   host {e.self_cpu_time_total / 1e3:9.3f} "
                f"ms {e.count:6d} x  {e.key[:90]}")


def training_fluxes(profiles, g_point, ng, dev, ssi=None):
    """LblFluxes of a main path's profiles (h2o at vmr 0.01), computed on
    the card as tests/synth.py:195-347 computes its training files: each
    profile's spectrum through the port's ``planck_function`` and ``rt_lw``
    (SW: ``rt_norayleigh_sw`` at the zenith angles of
    ``SW_SZA_INDICES`` with a surface albedo of 0.15), the fluxes summed
    over the spectrum and over each g-point of the merged map."""
    from ecckd_tpu_torch.io.lbl_fluxes import SW_SZA_INDICES, LblFluxes
    from ecckd_tpu_torch.ops import planck_function, rt_lw, rt_norayleigh_sw
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                  device=dev)
    gp = torch.as_tensor(np.asarray(g_point), dtype=torch.int64, device=dev)
    onehot = (gp[:, None] == torch.arange(ng, device=dev)[None, :]).double()
    mu0_all = np.array([0.9, 0.7, 0.5, 0.3, 0.1])[list(SW_SZA_INDICES)]
    rows = {k: [] for k in ("p", "t", "fd", "fu", "sfd", "sfu", "mu0")}
    for sp in profiles:
        od = f(sp.optical_depth)
        if ssi is None:
            planck = planck_function(f(sp.temperature_hl), f(sp.wavenumber),
                                     f(sp.d_wavenumber))
            fluxes = [rt_lw(planck, od, torch.ones_like(planck[0]),
                            planck[-1])]
            del planck
        else:
            albedo = torch.full_like(od[0], 0.15)
            fluxes = [rt_norayleigh_sw(float(mu0), f(ssi), od, albedo)
                      for mu0 in mu0_all]
            rows["mu0"].extend(mu0_all)
        for fd, fu in fluxes:
            rows["p"].append(sp.pressure_hl)
            rows["t"].append(sp.temperature_hl)
            for key, flux in (("fd", fd), ("fu", fu)):
                rows[key].append(flux.sum(-1).cpu().numpy())
                rows["s" + key].append((flux @ onehot).cpu().numpy())
        del od, fluxes
    nlay = profiles[0].optical_depth.shape[0]
    lbl = LblFluxes()
    lbl.is_sw = ssi is not None
    lbl.pressure_hl = np.stack(rows["p"])
    lbl.temperature_hl = np.stack(rows["t"])
    lbl.vmr_fl = np.full((len(rows["p"]), 1, nlay), 0.01)
    lbl.molecules = ["h2o"]
    lbl.flux_dn, lbl.flux_up = np.stack(rows["fd"]), np.stack(rows["fu"])
    lbl.spectral_flux_dn = np.stack(rows["sfd"])
    lbl.spectral_flux_up = np.stack(rows["sfu"])
    lbl.have_spectral_fluxes = True
    if lbl.is_sw:
        lbl.mu0 = np.asarray(rows["mu0"])
        lbl.tsi = lbl.flux_dn[0, 0] / lbl.mu0[0]
        lbl._update_albedo()
    lbl.calc_heating_rates()
    lbl.surf_emissivity = np.ones((lbl.ncol, ng))
    return lbl


def flux_errors(model, lbl, device="cuda"):
    """RMS errors of a LW model against the training fluxes through
    ``run_ckd_core``: (heating rate in K/day, surface downwelling flux in
    W m-2)."""
    from ecckd_tpu_torch import constants as c
    from ecckd_tpu_torch.tools.run_ckd import run_ckd_core
    out = run_ckd_core(model, lbl.pressure_hl, lbl.temperature_hl,
                       {"h2o": lbl.vmr_fl[:, 0]}, device=device)
    fd, fu = out["flux_dn_lw"], out["flux_up_lw"]
    conv = (-(c.ACCEL_GRAVITY / c.SPECIFIC_HEAT_AIR)
            / np.diff(lbl.pressure_hl, axis=1))
    hr = conv * (np.diff(fd, axis=1) - np.diff(fu, axis=1))
    err_hr = c.HR_WEIGHT * np.sqrt(np.mean((hr - lbl.heating_rate) ** 2))
    err_dn = np.sqrt(np.mean((fd[:, -1] - lbl.flux_dn[:, -1]) ** 2))
    return float(err_hr), float(err_dn)


def card_against_cpu(what, cost_of, x0, card="cuda"):
    """The value and gradient of one training cost on the card against the
    same code on the CPU (float64, normwise 1e-10), and a repeat on the
    card bit for bit.  ``cost_of(device)`` builds the TrainingCost."""
    card, cpu = cost_of(card), cost_of("cpu")
    v, g = card.value_and_grad(card.tensor(x0))
    v2, g2 = card.value_and_grad(card.tensor(x0))
    vc, gc = cpu.value_and_grad(cpu.tensor(x0))
    rel_v = abs(float(v) - float(vc)) / abs(float(vc))
    rel_g = float((g.cpu() - gc).norm() / gc.norm())
    same = torch.equal(v, v2) and torch.equal(g, g2)
    log(f"[optimize] {what}: {g.numel()} state variables; card against CPU "
        f"value {rel_v:.3e}, gradient {rel_g:.3e} (normwise, bar 1e-10); "
        f"repeat on the card bit-identical {same}")
    check(rel_v <= 1e-10 and rel_g <= 1e-10,
          f"{what}: card within 1e-10 of the CPU")
    check(same, f"{what}: value and gradient bit-identical in a repeat")
    return card


def step_launches(cost, x, reps):
    """(kernels and copies launched per value and gradient, the device's
    busy milliseconds per evaluation) from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cost.value_and_grad(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            cost.value_and_grad(x)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    copies = sum(e.count for e in rows if e.key.startswith(("Memcpy",
                                                             "Memset")))
    kernels = sum(e.count for e in rows) - copies
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return kernels / reps, copies / reps, busy_ms / reps


def phase_optimize(lw_profiles, lw_gp, lw_model, sw_profiles, ssi, sw_gp,
                   sw_model):
    """create_lut -> optimize_lut -> run_ckd on the LW main path's model,
    the training step at bench.py's production size, and the SW step with
    Rayleigh active, all on the card."""
    import copy
    import scipy
    from ecckd_tpu_torch.ops.cost import CostWeights
    from ecckd_tpu_torch.optimize.solver import (TrainingCost, log_state_tree,
                                                 ravel_tree)
    from ecckd_tpu_torch.scripts import train_step
    from ecckd_tpu_torch.tools.optimize_lut import (optimize_lut_core,
                                                    prepare_lbl)
    dev = torch.device("cuda")
    say = lambda line: log(f"[optimize] {line}")
    say(f"scipy {scipy.__version__}")
    t_phase = time.perf_counter()

    # the chain: training fluxes, optimisation, evaluation before and after
    t0 = time.perf_counter()
    lbl = training_fluxes(lw_profiles, lw_gp.g_point, lw_model.ng, dev)
    say(f"LW training fluxes of {lbl.ncol} profiles x "
        f"{lw_profiles[0].optical_depth.shape[1]} wavenumbers, "
        f"{lw_model.ng} g-points, on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    before = flux_errors(lw_model, lbl)
    model = copy.deepcopy(lw_model)
    res = optimize_lut_core(model, [lbl], gases=["h2o"], prior_error=4.0,
                            max_iterations=60, convergence_criterion=0.002,
                            device="cuda")
    after = flux_errors(model, lbl)
    say(f"chain: {res.status.name}, {res.n_iterations} iterations, "
        f"{res.n_evaluations} evaluations; cost {res.first_cost:.6g} -> "
        f"{res.cost:.6g}; heating-rate RMS error {before[0]:.6e} -> "
        f"{after[0]:.6e} K/day, surface downwelling {before[1]:.9e} -> "
        f"{after[1]:.9e} W m-2")
    say(f"chain: {res.seconds_per_iteration * 1e3:.2f} ms per iteration "
        f"(host clock): cost and gradient {res.device_seconds:.3f} s, "
        f"minimizer {res.minimizer_seconds:.3f} s of {res.wall_time:.3f} s "
        f"over {res.n_evaluations} evaluations")
    check(res.cost < res.first_cost, "optimisation lowers the cost")
    check(after[0] < before[0] and after[1] < before[1],
          "optimisation lowers the heating-rate and surface-downwelling "
          "errors")

    # the training step at production size
    size = "ng 64, nt 6, np 53, 48 columns, 50 layers, h2o linear, o3 LUT"
    x0 = ravel_tree(log_state_tree(train_step.synthetic_model(
        64, 6, 53, lut_gas=True)))
    card = card_against_cpu(f"production step ({size})",
                            lambda d: train_step.training_cost(device=d)[0],
                            x0)
    x64 = card.tensor(x0)
    c32, x32 = train_step.training_cost(device="cuda", dtype=torch.float32)
    lev = train_step.precision_levels(card, x64, c32, x32)
    say(f"production step float32 against float64: {json.dumps(lev)}")
    for key in ("value_rel", "gradient_norm_rel", "cost_20_rel"):
        check(lev[key] <= 1e-3, f"float32 {key} within 1e-3 of float64")
    for tag, cost, x in (("f64", card, x64), ("f32", c32, x32)):
        ms = cuda_ms(lambda: cost.value_and_grad(x), 20)
        t0 = time.perf_counter()
        for _ in range(20):
            cost(x0)
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        kernels, copies, busy = step_launches(cost, x, 5)
        say(f"production step {tag}: {ms:.3f} ms per value and gradient "
            f"(CUDA events), {host_ms:.3f} ms per scipy evaluation with its "
            f"copies (host clock); per evaluation {kernels:.0f} kernels and "
            f"{copies:.0f} copies launched, device busy {busy:.3f} ms, idle "
            f"{100 * max(0.0, 1 - busy / ms):.1f}% (torch.profiler)")

    # the SW step: the SW main path's model with Rayleigh active
    t0 = time.perf_counter()
    sw_lbl = training_fluxes(sw_profiles, sw_gp.g_point, sw_model.ng, dev,
                             ssi=ssi)
    say(f"SW training fluxes of {sw_lbl.ncol} profile-angle columns on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    model = copy.deepcopy(sw_model)
    model.set_active(["h2o", "rayleigh"])
    model.create_error_covariances(4.0, rayleigh_prior_error=0.5)
    prepare_lbl(sw_lbl, model, 1.0e4)
    check(model.rayleigh_is_active, "Rayleigh active in the SW step")
    card = card_against_cpu(
        f"SW step ({sw_lbl.ncol} columns, {model.ng} g-points, Rayleigh "
        "active)",
        lambda d: TrainingCost(model, [sw_lbl], CostWeights(), device=d),
        ravel_tree(log_state_tree(model)))
    x = card.tensor(ravel_tree(log_state_tree(model)))
    say(f"SW step f64: {cuda_ms(lambda: card.value_and_grad(x), 20):.3f} ms "
        "per value and gradient (CUDA events)")
    say(f"phase {time.perf_counter() - t_phase:.1f} s")


def phase_experiment(checked=False):
    """The experiment path: ``exp_kernels.main`` with all three variants
    in float32 (the script's type) and float64, counts set to 0 just
    before and read just after; then E1 against K1 on the same inputs,
    E1 and E2 against their plain versions, and their yardsticks
    (``checked``: not the plain versions' and library times)."""
    from ecckd_tpu_torch.ops.kernels import (KERNELS, fused_sums_lw_plain,
                                             reset_launch_counts,
                                             sweep_lw_scan_plain)
    from ecckd_tpu_torch.scripts import exp_kernels
    say = lambda line: log(f"[experiment] {line}")
    dtypes = (torch.float32, torch.float64)
    reset_launch_counts()
    runs = {dt: exp_kernels.main(device="cuda", dtype=dt, nwav=NWAV_FULL,
                                 iters=20, out=say) for dt in dtypes}
    launches = {k.__name__: k.launches for k in KERNELS}
    say(f"launches {launches}")
    for name in ("sweep_lw_scan_intervals", "fused_sums_lw_intervals"):
        check(launches[name] > 0, f"{name} launched on the experiment path")
    out = {}
    for dtype in dtypes:
        tag = "f64" if dtype == torch.float64 else "f32"
        bar = BARS[dtype]
        run = runs.pop(dtype)
        d = run["inputs"]
        sweep_args = (d["planck_hl"], d["bg_od"], run["od_fit"],
                      d["seg_of_wav"], d["surf_emissivity"], d["surf_planck"],
                      d["i1"], d["i2"])
        sums_args = (d["metric"], d["planck_hl"], d["hr"], d["flux_dn_surf"],
                     d["flux_up_toa"], d["i1"], d["i2"])
        scan, isum = run["sweep-scan"], run["isum-pallas"]
        vs_k1 = max(row_err(g, w)[0] for g, w in zip(scan["got"],
                                                     scan["ref"]))
        vs_k3 = row_err(isum["got"], isum["ref"])[0]
        same = torch.equal(isum["got"], isum["ref"])
        say(f"E1 vs K1 {tag}: max rel err (normwise per row) {vs_k1:.3e} "
            f"(bar {bar:.0e}); E2 vs K3: {vs_k3:.3e}, bit-identical {same}")
        check(vs_k1 <= bar, f"E1 agrees with K1 within {bar} ({tag})")
        check(same, f"E2's sums equal K3's bit for bit ({tag})")
        res = {}
        for name, got, plain, args, yard in (
                ("sweep_lw_scan", scan["got"], sweep_lw_scan_plain,
                 sweep_args, run["sweep-v0"]["ms"]),
                ("fused_sums_lw", (isum["got"],),
                 lambda *a: (fused_sums_lw_plain(*a),), sums_args,
                 isum["k3_ms"])):
            want = plain(*args)
            torch.cuda.synchronize()
            errs = [row_err(g, w) for g, w in zip(got, want)]
            rel = max(e[0] for e in errs)
            check(rel <= bar, f"{name} {tag} within {bar} of its plain "
                  "version")
            res[name] = dict(max_rel_err=rel,
                             max_abs_err=max(e[1] for e in errs),
                             ms=(scan if name == "sweep_lw_scan"
                                 else isum)["ms"],
                             plain_ms=(None if checked else
                                       cuda_ms(lambda: plain(*args), 3)),
                             yardstick_ms=yard, library_ms=None)
            if checked:
                say(f"{name} {tag} on the checked build: max rel err vs "
                    f"plain {rel:.3e}, kernel {res[name]['ms']:.4f} ms")
        out[tag] = res
        if checked:
            continue
        n, nlay = NWAV_FULL, exp_kernels.NLAY
        w_num = d["planck_hl"][1:]
        rows = torch.cat([d["metric"] * w_num, w_num, d["hr"],
                          d["flux_dn_surf"][None], d["flux_up_toa"][None]])
        res["fused_sums_lw"]["library_ms"] = membership_matmul_ms(
            rows, d["i1"], d["i2"])
        del rows
        i1, i2 = d["i1"].cpu().numpy(), d["i2"].cpu().numpy()
        for name, (b, by) in (
                ("sweep_lw_scan", lw_sweep_bound(sweep_args)),
                ("fused_sums_lw", row_sums_bound(3 * nlay + 2, n, nlay, i1,
                                                 i2, dtype))):
            r = res[name]
            r.update(bound_ms=b, bound_by=by)
            say(f"{name} {tag}: max rel err vs plain {r['max_rel_err']:.3e} "
                f"(bar {bar:.0e}), max abs err {r['max_abs_err']:.3e}; "
                f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
                f"{'K1' if name == 'sweep_lw_scan' else 'K3'} "
                f"{r['yardstick_ms']:.4f} ms, library {r['library_ms']} ms, "
                f"bound {b:.4f} ms ({by}) (CUDA events)")
        del run, d, sweep_args, sums_args, scan, isum
    return out, launches


def phase_checked(dev, times, exp):
    """Phases 3, 4 and 9 again with the wrappers on the checked build: an
    index outside its range traps, which fails the run at the next
    synchronisation, and a host check that fails raises.  Logs each
    kernel's time beside the normal build's."""
    from ecckd_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    with _build.checked():
        checked_times = phase_kernels(dev, checked=True)
        phase_small_rig()
        checked_exp = phase_experiment(checked=True)[0]
        torch.cuda.synchronize()
    for tag in ("f64", "f32"):
        for normal, checked in ((times, checked_times), (exp, checked_exp)):
            for name, res in checked[tag].items():
                log(f"[checked] {name} {tag}: {res['ms']:.4f} ms on the "
                    f"checked build, {normal[tag][name]['ms']:.4f} ms on the "
                    f"normal one ({res['ms'] / normal[tag][name]['ms']:.2f}x)")
    log(f"[checked] phases 3, 4 and 9 passed on the checked build in "
        f"{time.perf_counter() - t0:.1f} s: no index out of range")


def kernel_entry(name, source, replaces, launches, res):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=res["max_abs_err"],
                ms=res["ms"], plain_ms=res["plain_ms"],
                bound_ms=res["bound_ms"], bound_by=res["bound_by"],
                library_ms=res["library_ms"])


def jax_modules():
    return sorted(m for m in sys.modules
                  if any(m == top or m.startswith(top + ".")
                         for top in ("jax", "ecckd_tpu")))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import ecckd_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    smi = phase_card()
    phase_build()
    times = phase_kernels(dev)
    phase_small_rig()
    lw_profiles, lw_gp, lw_model, lw_launches = phase_lw_main_path()
    sw_profiles, ssi, sw_gp, sw_model, sw_launches = phase_sw_main_path()
    phase_profile(lw_profiles, sw_profiles, ssi)
    phase_optimize(lw_profiles, lw_gp, lw_model, sw_profiles, ssi, sw_gp,
                   sw_model)
    del lw_profiles, sw_profiles, lw_model, sw_model
    exp, exp_launches = phase_experiment()
    phase_checked(dev, times, exp)
    check(not jax_modules(), f"no module of jax or ecckd_tpu imported "
          f"(found {jax_modules()[:5]})")
    f64 = times["f64"]
    kernels = [
        kernel_entry("sweep_lw", "ecckd_tpu_torch/csrc/sweep_lw.cu",
                     "ecckd_tpu/ops/pallas/sweep_lw.py:305",
                     lw_launches["sweep_lw_intervals"], f64["sweep_lw"]),
        kernel_entry("sweep_sw", "ecckd_tpu_torch/csrc/sweep_sw.cu",
                     "ecckd_tpu/ops/pallas/sweep_sw.py:159",
                     sw_launches["sweep_sw_with_upwelling"],
                     f64["sweep_sw_up"]),
        kernel_entry("sweep_sw_noup", "ecckd_tpu_torch/csrc/sweep_sw.cu",
                     "ecckd_tpu/ops/pallas/sweep_sw.py:159",
                     sw_launches["sweep_sw_intervals"]
                     - sw_launches["sweep_sw_with_upwelling"],
                     f64["sweep_sw_noup"]),
        kernel_entry("interval_sum", "ecckd_tpu_torch/csrc/interval_sum.cu",
                     "ecckd_tpu/ops/segments.py:123",
                     lw_launches["fused_interval_sum"]
                     + sw_launches["fused_interval_sum"],
                     f64["interval_sum"]),
        kernel_entry("interval_sum_sw",
                     "ecckd_tpu_torch/csrc/interval_sum.cu",
                     "ecckd_tpu/ops/segments.py:123",
                     sw_launches["fused_interval_sum"],
                     f64["interval_sum_sw"]),
        kernel_entry("sweep_lw_scan",
                     "ecckd_tpu_torch/csrc/sweep_lw_scan.cu",
                     "scripts/exp_kernels.py:132",
                     exp_launches["sweep_lw_scan_intervals"],
                     exp["f64"]["sweep_lw_scan"]),
        kernel_entry("fused_sums_lw",
                     "ecckd_tpu_torch/csrc/fused_sums_lw.cu",
                     "scripts/exp_kernels.py:224",
                     exp_launches["fused_sums_lw_intervals"],
                     exp["f64"]["fused_sums_lw"]),
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
