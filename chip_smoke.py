"""Drive the PyTorch/CUDA port's generation chains, and the optimisation
and evaluation of their models, on one GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout,
on a machine with one NVIDIA Hopper card.  It needs neither jax nor h5py,
and builds the port's CUDA kernels and its native shard loader from
``ecckd_tpu_torch/csrc`` at first use.

Phases (every failed check raises; nothing is caught; phase 13 runs
last):
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
     (kernels), band_parallel off on both: identical g-point ranks,
     bit-identical repeats; the SW rig with band_parallel parallel (one
     gas-level kernel, both bands' probes in each dispatch) bit-identical
     to serial on the card; and the card's float32 chain held against its
     float64 chain (``ecckd_tpu_torch.scripts.precision``, as
     tests/test_torch_precision.py does on the CPU);
  5. the LW main path at full size: a CKDMIP-shaped synthetic LW spectrum
     of 2^20 wavenumbers x 50 layers (5 temperature profiles) through the
     same cores, with the checks of tests/test_find_g_points.py and the
     host time of the interval tables (K3's and the sweeps');
  6. the SW main path at full size: a synthetic SW spectrum of 2^20
     wavenumbers x 50 layers over 250-50000 cm-1 (5 profiles) and a solar
     spectrum, two bands (the lower reflects the direct beam), the
     total-transmission search with a kernel per band (band_parallel
     off, so that K2 runs with and without the reflected beam) and a
     transmission-averaged LUT;
  6b. the rest of find_g_points and scale_lut, each path with the counts
     set to 0 just before it and read just after: the SW main path's
     search with band_parallel parallel, serial and off, three runs each
     (parallel bit-identical to serial and to its repeats, against off the
     same g-points per band and ranks within 2; seconds, dispatches and
     K2's and K3's launches of each, and K2's and K3's device time in a
     fourth run under torch.profiler); the LW main path with g_split 0.5
     and a sub-band boundary at 1000 cm-1 (the chain's checks and those of
     tests/test_advanced_features.py); the prefix path: an LW search with
     ``use_prefix`` (no K3 launch, the same g-points, ranks within 2), and
     every probe of the LW and SW searches again on twins of their kernels
     with and without it, float64 and float32 (interval sums and costs
     against the K3 path, the prefix build and a probe timed);
     scale_lut_core on the SW main path's model with direct fluxes of its
     profile 0 from the port's ``rt_direct_sw``, card against CPU, and the
     scaled od against the best od where the LUT's clamp did not act;
  7. each main path once more under ``torch.profiler``: wall and device
     seconds, the device time of the costliest kernels and copies and the
     host time of the costliest operators;
  8. create_lut -> optimize_lut -> run_ckd on the card: LW training
     fluxes from the LW main path's profiles (the port's lw_spectra,
     ``lw_spectra_core`` with the chain's g-points), then
     ``optimize_lut_core`` (scipy L-BFGS-B, at most 60 iterations, prior
     error 4) on its model and ``run_ckd_core`` before and after: the cost
     and the heating-rate and surface-downwelling errors must fall, and
     the same run once more with every evaluation eager (the same
     iterations, evaluations, final cost and LUT); the training step of
     that model, at bench.py's production size (ng 64, nt 6, np 53, 48
     columns, 50 layers, an o3 gas in LUT mode added; float64 and float32)
     and of the SW main path's model with Rayleigh active, each captured as
     a CUDA graph (``optimize/graphs.py``) and held against its eager code:
     value and gradient bit-identical (or within 1e-12, reported), the
     capture and its replays under ``torch.cuda.set_sync_debug_mode(
     "error")``, the graph pool's bytes, each way's milliseconds (CUDA
     events), and the host's launches, the kernels run on the card and its
     idle share (graphed; eager too at production size); the graphed
     steps on the card within 1e-10 of the CPU (float64) and bit-identical
     in a repeat, float32 within PARITY.md's 1e-3, and scipy's evaluation
     with its pinned copies timed;
  9. the experiment path of ``scripts/exp_kernels.py`` as ported
     (``ecckd_tpu_torch.scripts.exp_kernels.main``, all three variants, at
     2^20 x 50 x 64 in float32 and float64): E1 (LW sweep by scans across
     layers) against K1, E2 (fused LW fit and truth sums) bit-identical
     to K3, both against their plain versions, with kernel, plain,
     yardstick and library times;
  10. phases 3, 4 (with its band_parallel dispatches of one gas-level
      kernel) and 9 again on the checked build: any index outside its
      range traps and fails the run; the kernel times beside the normal
      build's;
  11. streaming at CKDMIP scale: two profiles of the LW main path's
      synthetic spectrum at 5,600,000 wavenumbers x 50 layers written to
      float32 ``.spbin`` shards (in a temporary directory under
      ``build/``, removed at the end) and read back through the native
      loader: reorder -> find_g_points (K1 and K3 at that size, their
      launches and device time, and the search once more on the checked
      build) -> create_lut with ``streaming`` "auto" (which streams blocks
      of 2^20 wavenumbers) and ``streaming=0`` (min/max bit-identical,
      molar absorption within 1e-10 normwise below the transmission clamp
      and 1e-6 at it) -> ``lw_spectra_core`` with and without the
      g-points (broadband fluxes within 1e-12 of each other and of the
      g-point fluxes' sum); seconds by stage, the shards' read rate, the
      device's idle share and the min/max reduction's device time in the
      streamed create_lut;
  12. the whole workflow through the port's orchestrator
      (``ecckd_tpu_torch.pipeline.orchestrator.build_pipeline``), every
      file in the classic NetCDF container (``netcdf_format=classic``; h5py
      is never imported), from float32 ``.spbin`` shards of the main
      paths' profiles, in a temporary directory under ``build/``.  LW
      (phase 5's configuration): reorder -> find_g_points -> create_lut,
      the g-point ranks identical to phase 5's, the LUT identical to
      phase 5's rounded to the file's float32, the kernels' launches equal
      to phase 5's, K1 and K3 held against their plain versions on the
      search's largest probe; then a training file (``training_fluxes``,
      tests/synth.py's schema) and a scenario file, and optimize_lut (one
      pass, at most 60 iterations, prior error 4) -> run_ckd ->
      evaluate_ckd against the training file, the heating-rate error
      beside phase 8's.  SW (phase 6's configuration, with an ssi file):
      reorder -> find_g_points (total-transmission) -> create_lut
      (transmission), the ranks identical and the launches equal to phase
      6's; a training file of five zenith angles (``training_input``) and
      profile 0's direct flux at full resolution (``scale_lblfile``),
      scale_lut -> optimize_lut -> run_ckd.  (No SW
      evaluate stage: evaluate_ckd reads ``flux_up_sw`` and
      ``flux_dn_sw``, which run_ckd's SW output lacks in both packages.)
      Then both workflows again, every step skipped, and with the
      g-point file deleted only find_g_points again, to the same ranks;
  13. the on-device L-BFGS and the parallel paths, a mesh of 4 logical shards
      of the card standing for 4 cards: ``solver=device`` on phase 8's model,
      its step one CUDA graph (at most 60 iterations; the final cost within 5%
      of phase 8's scipy cost, the errors falling, bounds and zeros kept;
      evaluations, masked evaluations and host reads an iteration, one read
      every ``STEPS_PER_READ`` evaluations), and its state machine graphed
      against eager on the card (12 iterations in chunks of 6: chunk
      boundaries, values and parameters bit for bit); ``data_parallel`` over
      the 4 shards (5 profiles, padded; the shards' graphs against their eager
      code as in phase 8, value and gradient within 1e-10 of one shard and
      bit-identical in a repeat, 15 scipy iterations within 1e-8 / 1e-6); the
      LW and SW main paths' searches sharded (K1/K2 and K3 four times a probe;
      each shard's kernels held against their plain versions with shifted
      bounds on the largest probe; its costs within 1e-10 of one device with
      float32's transmission clamp on both sides; ranks identical to the
      unsharded search, or, where the float64 clamp moves a bound, the same
      g-point count, bounds within 2 ranks and identical ranks with float32's
      clamp), the LW one once more on the checked build; create_lut sharded,
      dense and streamed in blocks of 2^18 (min and max bit-identical, molar
      absorption within 1e-10 where the fit is well conditioned); and two
      processes sharing the card over gloo (``--parallel-worker``, two shards
      each): the LW search and the streamed multi-controller averaging of
      profile 0 against the one-process 4-shard run (ranks identical, costs and
      sums within 1e-12, min and max partials bit-identical).
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
# Phase 11: the wavenumbers of a CKDMIP longwave spectrum, as
# tests/test_create_lut.py's streaming rule has them, and its profiles
NWAV_CKDMIP = 5_600_000
NCOL_CKDMIP = 2
BLOCK_CKDMIP = 1 << 20
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


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


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


def gas_input(order, sp, **gas_options):
    """The h2o GasInput of a profile and its order, with the SW
    total-transmission scalings 0.5 and 2.5."""
    from ecckd_tpu_torch.tools.find_g_points import GasInput
    return GasInput("h2o", order["rank"], order["band_number"],
                    order["wavenumber1_band"], order["wavenumber2_band"],
                    order["sorting_variable"], sp.pressure_hl,
                    sp.temperature_hl, sp.wavenumber, sp.d_wavenumber,
                    sp.optical_depth, min_scaling=0.5, max_scaling=2.5,
                    **gas_options)


def search(gas, device, hr_tol, ssi=None, **options):
    """find_g_points_core on one gas: LW transmission, SW (``ssi`` given)
    total-transmission."""
    from ecckd_tpu_torch.tools.find_g_points import find_g_points_core
    return find_g_points_core(
        [gas], hr_tol,
        averaging_method="total-transmission" if ssi is not None
        else "transmission", device=device, ssi=ssi, **options)


def order_of(sp, device, dtype=torch.float64, sw=False, bands=(None, None)):
    """reorder_core on a profile: SW (``sw``) at threshold 0.25, LW 0.5."""
    from ecckd_tpu_torch.tools.reorder_spectrum import reorder_core
    return reorder_core(sp.pressure_hl, sp.wavenumber, sp.d_wavenumber,
                        sp.optical_depth, *bands,
                        threshold_optical_depth=0.25 if sw else 0.5,
                        device=device, dtype=dtype, do_sw=sw)


def run_chain(profiles, device, hr_tol, lut_profiles=None, ssi=None,
              bands=(None, None), band_parallel="auto", gas_options=None):
    """reorder -> find_g_points -> create_lut through the array cores;
    returns (order, g-points, model, seconds per stage).  LW: transmission
    search and LUT.  SW (``ssi`` given): total-transmission search with
    the h2o scalings 0.5 and 2.5, transmission-averaged LUT.
    ``band_parallel`` and ``gas_options`` (GasInput fields) go to the
    search."""
    from ecckd_tpu_torch.config import Config
    from ecckd_tpu_torch.models import ConcDependence
    from ecckd_tpu_torch.tools.common import setup
    from ecckd_tpu_torch.tools.create_lut import (LutGas, SolarSpectrum,
                                                  create_lut_core)

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

    order = timed("reorder", lambda: order_of(sp, dev, dtype, sw, bands))
    gas = gas_input(order, sp, **(gas_options or {}))
    gp = timed("find_g_points", lambda: search(
        gas, dev, hr_tol, ssi=ssi, dtype=dtype, band_parallel=band_parallel))
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


def same_search(a, b):
    """Bit-identical g-points, ranks and errors of two searches."""
    ga, gb = a.gases[0], b.gases[0]
    return (np.array_equal(ga.rank1, gb.rank1)
            and np.array_equal(ga.rank2, gb.rank2)
            and np.array_equal(ga.error, gb.error)
            and np.array_equal(a.g_point, b.g_point))


def phase_small_rig():
    """The 1024 x 15 h2o rigs of tests/synth.py on the CPU and the card
    (band_parallel off on both): LW as tests/test_torch_pipeline.py, SW
    over two bands as tests/test_torch_sw_pipeline.py; the SW rig's
    band_parallel parallel against serial on the card, bit for bit; then
    the card's float32 chain against its float64 chain on both."""
    from ecckd_tpu_torch.scripts import precision
    profiles = lw_spectrum(1024, 15, 5, seed=3, nlines=60, width=(2, 30),
                           wav_max=2000.0)
    check_same_runs(*(run_chain(profiles, dev, 0.4, band_parallel="off")
                      for dev in ("cpu", "cuda", "cuda")), "LW")
    profiles, ssi = sw_spectrum(1024, 15, 6, seed=11)
    check_same_runs(*(run_chain(profiles, dev, 0.5, ssi=ssi, bands=SW_BANDS,
                                band_parallel="off")
                      for dev in ("cpu", "cuda", "cuda")), "SW two bands")
    runs = {mode: run_chain(profiles, "cuda", 0.5, ssi=ssi, bands=SW_BANDS,
                            band_parallel=mode)
            for mode in ("parallel", "serial")}
    check(same_search(runs["parallel"][1], runs["serial"][1])
          and np.array_equal(runs["parallel"][2].single_gas_data[0].molar_abs,
                             runs["serial"][2].single_gas_data[0].molar_abs),
          "SW two bands: band_parallel parallel bit-identical to serial on "
          "the card")
    log(f"[small rig] SW two bands: band_parallel parallel and serial "
        f"bit-identical on the card (ng "
        f"{len(runs['parallel'][1].band_number)})")
    for kind in ("lw", "sw"):
        lev, fail = precision.compare(kind, "cuda")
        log(f"[small rig] float32 against float64 on the card, {kind}: "
            f"{json.dumps(lev)}")
        check(not fail, f"float32 chain within PARITY.md's bounds ({kind}):"
              f" {fail}")


def chain_checks(what, gp, model, nwav, ncol, nlay, hr_tol,
                 shared_bounds=False):
    """The checks of tests/test_find_g_points.py on a main path's result,
    band by band; with ``shared_bounds`` (g_split's sub-bands) a g-point
    may start at the last rank of the one before."""
    g = gp.gases[0]
    ng = len(gp.band_number)
    first = g.rank1[1:] - g.rank2[:-1]
    check(g.rank1[0] == 0 and np.all(g.rank2 >= g.rank1)
          and np.all((first >= 0 if shared_bounds else first == 1)
                     & (first <= 1)), f"{what}: contiguous g-point ranks")
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


def launch_counts():
    """Each kernel's launches since the counts were last set to 0, and
    K2's with the reflected beam."""
    from ecckd_tpu_torch.ops.kernels import KERNELS, sweep_sw_intervals
    launches = {k.__name__: k.launches for k in KERNELS}
    launches["sweep_sw_with_upwelling"] = \
        sweep_sw_intervals.upwelling_launches
    return launches


def drive(what, profiles, hr_tol, ssi=None, bands=(None, None),
          device="cuda", **options):
    """One main path with the launch counts set to 0 just before it and
    read just after, and the host time of its interval tables; returns
    (g-points, model, seconds, launches).  ``options`` go to
    :func:`run_chain`."""
    from ecckd_tpu_torch.ops.kernels import reset_launch_counts
    stats, undo = timing_tables()
    reset_launch_counts()
    try:
        _, gp, model, secs = run_chain(profiles, device, hr_tol, ssi=ssi,
                                       bands=bands, **options)
    finally:
        undo()
    launches = launch_counts()
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
                                      ssi=ssi, bands=SW_BANDS,
                                      band_parallel="off")
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


def fgp_run(gas, hr_tol, ssi=None, keep_log=False, cost_options=None,
            device="cuda", **options):
    """One find_g_points_core with the launch counts set to 0 just before
    it and read just after; returns (g-points, host seconds, candidate-cost
    calls (dispatches), launches, the probe log or None)."""
    from ecckd_tpu_torch.ops.kernels import reset_launch_counts
    probes = []
    reset_launch_counts()
    t0 = time.perf_counter()
    gp = search(gas, device, hr_tol, ssi=ssi,
                cost_options=dict(probe_log=probes, **(cost_options or {})),
                **options)
    sync(device)
    secs = time.perf_counter() - t0
    return (gp, secs, len(probes), launch_counts(),
            probes if keep_log else None)


def cost_twin(k, dtype, use_prefix, fit_limits=None, mesh=None):
    """A candidate-cost kernel over ``k``'s arrays in ``dtype``, with or
    without the prefix path, with ``fit_limits``, over ``mesh`` or on one
    device."""
    from ecckd_tpu_torch.partition import CandidateCostLw, CandidateCostSw
    c = lambda name: getattr(k, name).to(dtype)
    kw = dict(use_prefix=use_prefix, fit_limits=fit_limits, mesh=mesh)
    if isinstance(k, CandidateCostLw):
        names = ("layer_weight", "pressure_hl", "surf_emissivity",
                 "surf_planck", "flux_dn_surf", "flux_up_toa", "planck_hl",
                 "bg_od", "metric", "hr")
        return CandidateCostLw(k.averaging_method, k.flux_weight,
                               **{n: c(n) for n in names}, **kw)
    names = ("layer_weight", "pressure_hl", "ssi", "surf_albedo",
             "flux_dn_surf", "flux_up_toa", "bg_od", "metric", "hr")
    extras = None
    if k.averaging_method == "total-transmission":
        extras = {f"{v}_{t}": c(f"{v}_{t}") for t in ("low", "high")
                  for v in ("hr", "flux_dn_surf", "flux_up_toa")}
        extras.update(min_scaling=k.min_scaling, max_scaling=k.max_scaling)
    return CandidateCostSw(k.averaging_method, k.flux_weight,
                           cos_sza=k.cos_sza, extras=extras,
                           **{n: c(n) for n in names}, **kw)


def normwise(got, want):
    got, want = np.concatenate(got), np.concatenate(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def check_prefix(what, probes, say):
    """Every probe of a K3-path search's log again on twins of its kernels
    with and without the prefix path, float64 and float32: the probe's
    interval sums (fit and truth rows) within BARS of K3's, relative to
    the largest prefix sum of their row (the scale of a difference of two
    prefixes: a deep level's flux summed over opaque ranks is 1e-300 after
    transparent ranks whose sum is 1, and the prefix path keeps the
    difference to ~2^-106 of 1, not of 1e-300), no K3 launch with the
    prefix; the costs normwise within BARS where the fit is well
    conditioned.  A transmission fit is not where an interval is
    opaque: its mean transmission sits at the clamp, where -log1p(-mean)
    turns the sums' last bits into the cost's fifth digit (ROADMAP.md,
    faults); there the float64 costs are held with float32's clamp as
    ``fit_limits`` on both sides and the rest reported.  The prefix build
    and a probe (the batch of most intervals) timed with and without
    it."""
    from ecckd_tpu_torch.ops.kernels import fused_interval_sum
    kernels = list({id(p[0]): p[0] for p in probes}.values())
    clamped = kernels[0].averaging_method in ("transmission",
                                              "transmission-2")
    out = {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        bar = BARS[dtype]
        sums_err = 0.0
        costs = {None: ([], []), torch.float32: ([], [])}
        for j, k in enumerate(kernels):
            sync(k.device)
            t0 = time.perf_counter()
            pre = cost_twin(k, dtype, True)
            sync(k.device)
            build_ms = 1e3 * (time.perf_counter() - t0)
            base = cost_twin(k, dtype, False)
            mine = [(i1, i2) for kk, i1, i2, _ in probes if kk is k]
            k3_before = fused_interval_sum.launches
            got = [pre.costs(i1, i2) for i1, i2 in mine]
            sums = [pre.interval_sums(i1, i2) for i1, i2 in mine]
            check(fused_interval_sum.launches == k3_before,
                  f"prefix {what}: no K3 launch on the prefix path")
            scale = pre._prefix[0].double().abs().amax(dim=1)
            for s, (i1, i2) in zip(sums, mine):
                diff = (s - base.interval_sums(i1, i2)).double().abs()
                diff = diff.amax(dim=1)
                sums_err = np.nanmax([sums_err, float(torch.where(
                    scale > 0, diff / scale.clamp(min=1e-300), diff).max())])
                check(np.isfinite(sums_err), f"prefix {what}: finite sums")
            costs[None][0].extend(got)
            costs[None][1].extend(base.costs(i1, i2) for i1, i2 in mine)
            if clamped and dtype == torch.float64:
                for use, side in ((True, 0), (False, 1)):
                    twin = cost_twin(k, dtype, use, torch.float32)
                    costs[torch.float32][side].extend(
                        twin.costs(i1, i2) for i1, i2 in mine)
                    del twin
            i1, i2 = max(mine, key=lambda p: len(p[0]))
            ms_pre = cuda_ms(lambda: pre.costs(i1, i2), 10)
            ms_k3 = cuda_ms(lambda: base.costs(i1, i2), 10)
            hi = pre._prefix[0]
            nbytes = 2 * hi.numel() * hi.element_size()
            out[f"{tag} kernel {j}"] = dict(
                build_ms=build_ms, bytes=nbytes, rows=hi.shape[0],
                nwav=k.npoints, probe_ms=ms_pre, probe_k3_ms=ms_k3,
                nseg=len(i1), probes=len(mine))
            say(f"prefix {what} {tag} kernel {j} ({k.npoints} wavenumbers): "
                f"build {build_ms:.2f} ms (host clock), {hi.shape[0]} rows, "
                f"{nbytes / 1e9:.3f} GB; a probe of {len(i1)} intervals "
                f"{ms_pre:.3f} ms with the prefix, {ms_k3:.3f} ms with K3 "
                f"(CUDA events, 10); {len(mine)} probes")
            del pre, base, sums
        rel = normwise(*costs[None])
        say(f"prefix {what} {tag}: interval sums {sums_err:.3e} (of the "
            f"row's largest prefix, worst probe), costs {rel:.3e} (normwise) "
            f"from the K3 path; bar {bar:.0e}")
        check(sums_err <= bar, f"prefix {what} {tag}: interval sums within "
              f"{bar} of K3's")
        if clamped and dtype == torch.float64:
            rel_l = normwise(*costs[torch.float32])
            say(f"prefix {what} {tag}: costs {rel_l:.3e} with float32's "
                "transmission clamp on both sides")
            check(rel_l <= bar, f"prefix {what} {tag}: costs of the clamped "
                  f"fits within {bar} of the K3 path")
            out[tag] = dict(sums=sums_err, costs=rel, clamped_costs=rel_l)
        else:
            if not clamped:
                check(rel <= bar, f"prefix {what} {tag}: costs within {bar} "
                      "of the K3 path")
            out[tag] = dict(sums=sums_err, costs=rel)
    return out


def profiled_device_ms(fn):
    """Device milliseconds of ``fn()`` under torch.profiler: K2's
    (``sweep_sw_kernel``), K3's (``stream_kernel``) and the rest's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    ms = {"K2": 0.0, "K3": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            key = ("K2" if "sweep_sw_kernel" in e.key else
                   "K3" if "stream_kernel" in e.key else "other")
            ms[key] += e.self_device_time_total / 1e3
    return ms


def phase_rest(lw_profiles, sw_profiles, ssi, sw_gp, sw_model,
               device="cuda"):
    """Phase 6b: band_parallel three ways on the SW main path's search,
    g_split on the LW main path, the prefix path on both, scale_lut on
    the SW main path's model."""
    from ecckd_tpu_torch.ops.rt_sw import rt_direct_sw
    from ecckd_tpu_torch.tools.scale_lut import scale_lut_core
    say = lambda line: log(f"[rest] {line}")
    t_phase = time.perf_counter()
    dev = torch.device(device)
    out = {}

    # band_parallel: three ways, three runs each
    sw_gas = gas_input(order_of(sw_profiles[0], dev, sw=True,
                                bands=SW_BANDS), sw_profiles[0])
    modes = ("parallel", "serial", "off")
    runs = {m: [] for m in modes}
    sw_log = None
    for rep in range(3):
        for mode in modes:
            keep = rep == 0 and mode == "off"
            r = fgp_run(sw_gas, HR_TOL_SW, ssi=ssi, band_parallel=mode,
                        keep_log=keep, device=dev)
            runs[mode].append(r[:4])
            sw_log = r[4] if keep else sw_log
    for mode in modes:
        l = runs[mode][0][3]
        up = l["sweep_sw_with_upwelling"]
        out[mode] = dict(seconds=[r[1] for r in runs[mode]],
                         dispatches=runs[mode][0][2], k2_reflecting=up,
                         k2_not=l["sweep_sw_intervals"] - up,
                         k3=l["fused_interval_sum"])
        say(f"band_parallel {mode}: find_g_points seconds (host clock) "
            f"{[round(r[1], 4) for r in runs[mode]]}; dispatches "
            f"{out[mode]['dispatches']}; K2 reflecting {up}, not "
            f"{out[mode]['k2_not']}; K3 {out[mode]['k3']}")
        check(all(r[3] == l for r in runs[mode]),
              f"band_parallel {mode}: the same launches in every run")
    for mode in modes:
        ms = profiled_device_ms(lambda: fgp_run(
            sw_gas, HR_TOL_SW, ssi=ssi, band_parallel=mode, device=dev))
        out[mode]["device_ms"] = ms
        say(f"band_parallel {mode}, a fourth run under torch.profiler: "
            f"device ms K2 {ms['K2']:.3f}, K3 {ms['K3']:.3f}, all "
            f"{sum(ms.values()):.3f}")
    par = runs["parallel"][0][0]
    check(all(same_search(par, r[0]) for r in runs["parallel"][1:]
              + runs["serial"]), "band_parallel parallel bit-identical to "
          "its repeats and to serial")
    off = runs["off"][0][0]
    gp_, go = par.gases[0], off.gases[0]
    check(np.array_equal(gp_.n_g_points, go.n_g_points)
          and np.max(np.abs(gp_.rank1 - go.rank1)) <= 2
          and np.max(np.abs(gp_.rank2 - go.rank2)) <= 2,
          "band_parallel parallel against off: the same g-points per band, "
          "ranks within 2")
    check(out["parallel"]["dispatches"] < out["serial"]["dispatches"],
          "band_parallel: fewer dispatches than serial")
    say(f"band_parallel: parallel bit-identical to serial and its repeats; "
        f"against off g-points per band {gp_.n_g_points.tolist()} both, "
        f"largest rank move {int(np.max(np.abs(gp_.rank1 - go.rank1)))}")
    del runs, par, off, gp_, go

    # g_split on the LW main path
    gp, model, secs, launches = drive(
        "g_split LW", lw_profiles, HR_TOL, device=dev,
        gas_options=dict(g_split=[0.5], subband_wavenumber_boundary=[1000.0]))
    g = chain_checks("g_split LW", gp, model, NWAV_FULL, NCOL_FULL,
                     NLAY_FULL, HR_TOL, shared_bounds=True)
    ng = len(g.rank1)
    wav = gp.wavenumber
    check(ng >= 3 and g.g_point.min() >= 0 and g.g_point.max() == ng - 1
          and (wav[g.g_point == 0].max() <= 1000.0
               or wav[g.g_point == 1].max() <= 1000.0),
          "g_split: the checks of tests/test_advanced_features.py:42-58")
    out["g_split"] = dict(seconds=secs, launches=launches, ng=ng)
    del gp, model

    # the prefix path
    lw_gas = gas_input(order_of(lw_profiles[0], dev), lw_profiles[0])
    k3_run = fgp_run(lw_gas, HR_TOL, keep_log=True, device=dev)
    pre_run = fgp_run(lw_gas, HR_TOL, cost_options=dict(use_prefix=True),
                      device=dev)
    gk, gpre = k3_run[0].gases[0], pre_run[0].gases[0]
    say(f"prefix LW find_g_points: {pre_run[1]:.3f} s against {k3_run[1]:.3f}"
        f" s with K3 (host clock); launches {pre_run[3]}")
    check(pre_run[3]["fused_interval_sum"] == 0
          and pre_run[3]["sweep_lw_intervals"] > 0,
          "prefix LW find_g_points: no K3 launch, K1 launched")
    check(np.array_equal(gk.n_g_points, gpre.n_g_points)
          and np.max(np.abs(gk.rank1 - gpre.rank1)) <= 2,
          "prefix LW find_g_points: the same g-points, ranks within 2")
    out["prefix_lw_run"] = dict(seconds=pre_run[1], k3_seconds=k3_run[1],
                                launches=pre_run[3])
    out["prefix"] = {"LW": check_prefix("LW", k3_run[4], say),
                     "SW": check_prefix("SW", sw_log, say)}
    del k3_run, pre_run, sw_log

    # scale_lut on the SW main path's model
    sp = sw_profiles[0]
    mu0 = 0.5
    nlay = sp.optical_depth.shape[0]
    flux = rt_direct_sw(mu0, torch.as_tensor(ssi, device=dev),
                        torch.as_tensor(sp.optical_depth, device=dev))
    args = (sw_gp.g_point, mu0, sp.pressure_hl, sp.temperature_hl,
            np.full((1, nlay), 0.01), ["h2o"])
    sync(dev)
    t0 = time.perf_counter()
    card = scale_lut_core(sw_model, *args, flux, device=dev)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = scale_lut_core(sw_model, *args, flux.cpu(), device="cpu")
    cpu_secs = time.perf_counter() - t0
    k_card = card.model.single_gas_data[0].molar_abs
    k_cpu = cpu.model.single_gas_data[0].molar_abs
    rel = max(float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
              for a, b in ((k_card, k_cpu), (card.scaling, cpu.scaling),
                           (card.od_best, cpu.od_best)))
    check(rel <= 1e-10, f"scale_lut: card within 1e-10 of the CPU ({rel})")
    check(sw_model.np_ == nlay and np.allclose(
        np.exp(sw_model.log_pressure),
        0.5 * (sp.pressure_hl[1:] + sp.pressure_hl[:-1]), rtol=1e-14),
        "scale_lut: the LUT's pressures are the profile's layers")
    # where the clamp left the scaled LUT at the unclamped product, the
    # scaled model's od of the profile is od_best
    g0 = sw_model.single_gas_data[0]
    free = np.all(k_card == g0.molar_abs * card.scaling[None], axis=0)
    od = scale_lut_core(card.model, *args, flux, device=dev).od_total
    good = free & (card.od_best > 0) & (card.od_total > 0)
    ratio = od[good] / card.od_best[good]
    med = float(np.median(ratio))
    worst = float(np.max(np.abs(ratio - 1.0)))
    say(f"scale_lut: {secs:.3f} s on the card, {cpu_secs:.3f} s on the CPU "
        f"(host clock); card against CPU {rel:.3e} (bar 1e-10); "
        f"{int(good.sum())} of {good.size} (layer, g-point) entries "
        f"unclamped with od_best > 0: scaled od / od_best median {med!r}, "
        f"largest |ratio - 1| {worst:.3e}")
    check(abs(med - 1.0) <= 1e-3, "scale_lut: median scaled od / od_best "
          "within 1e-3 of 1")
    out["scale_lut"] = dict(seconds=secs, cpu_seconds=cpu_secs, rel=rel,
                            median=med, worst=worst)
    say(f"phase {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_profile(lw_profiles, sw_profiles, ssi):
    """Each main path once more under torch.profiler: wall and device
    seconds, the device time of the costliest kernels and copies, and the
    host time of the costliest operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for what, args in (("LW", (lw_profiles, "cuda", HR_TOL)),
                       ("SW", (sw_profiles, "cuda", HR_TOL_SW))):
        kw = (dict(ssi=ssi, bands=SW_BANDS, band_parallel="off")
              if what == "SW" else {})
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
    the card as tests/synth.py:195-347 computes its training files: LW,
    each profile through the port's lw_spectra (``lw_spectra_core`` with
    the g-points: the Planck function and ``rt_lw`` over the spectrum,
    summed over the spectrum and over each g-point of the merged map); SW,
    ``rt_norayleigh_sw`` at the zenith angles of ``SW_SZA_INDICES`` with a
    surface albedo of 0.15, summed the same way."""
    from ecckd_tpu_torch.io.lbl_fluxes import SW_SZA_INDICES, LblFluxes
    from ecckd_tpu_torch.io.spectrum import spectrum_blocks
    from ecckd_tpu_torch.ops import rt_norayleigh_sw
    from ecckd_tpu_torch.tools.lw_spectra import lw_spectra_core
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                  device=dev)
    if ssi is not None:
        gp = torch.as_tensor(np.asarray(g_point), dtype=torch.int64,
                             device=dev)
        onehot = (gp[:, None] == torch.arange(ng, device=dev)[None, :]
                  ).double()
    mu0_all = np.array([0.9, 0.7, 0.5, 0.3, 0.1])[list(SW_SZA_INDICES)]
    rows = {k: [] for k in ("p", "t", "fd", "fu", "sfd", "sfu", "mu0")}
    for sp in profiles:
        if ssi is None:
            lw = lw_spectra_core(spectrum_blocks(sp), g_point, ng,
                                 device=dev)
            fluxes = [(lw.flux_dn, lw.flux_up, lw.spectral_flux_dn,
                       lw.spectral_flux_up)]
        else:
            od = f(sp.optical_depth)
            albedo = torch.full_like(od[0], 0.15)
            fluxes = []
            for mu0 in mu0_all:
                fd, fu = rt_norayleigh_sw(float(mu0), f(ssi), od, albedo)
                fluxes.append(tuple(a.cpu().numpy() for a in (
                    fd.sum(-1), fu.sum(-1), fd @ onehot, fu @ onehot)))
            rows["mu0"].extend(mu0_all)
            del od
        for fd, fu, sfd, sfu in fluxes:
            rows["p"].append(sp.pressure_hl)
            rows["t"].append(sp.temperature_hl)
            for key, flux in (("fd", fd), ("fu", fu), ("sfd", sfd),
                              ("sfu", sfu)):
                rows[key].append(flux)
        del fluxes
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


def card_against_cpu(what, cost_of, x0, card="cuda", profile_eager=False):
    """The value and gradient of one training cost on the card against the
    same code on the CPU (float64, normwise 1e-10), its graphs against its
    eager code (:func:`graph_against_eager`), and a repeat on the card bit
    for bit.  ``cost_of(device)`` builds the TrainingCost; returns it and
    the graph check's numbers."""
    card, cpu = cost_of(card), cost_of("cpu")
    x = card.tensor(x0)
    graphs = graph_against_eager(what, card, x, profile_eager=profile_eager)
    v, g = (t.clone() for t in card.value_and_grad(x))
    v2, g2 = (t.clone() for t in card.value_and_grad(card.tensor(x0)))
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
    return card, graphs


# The runtime calls by which the host launches work on the card
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")


def step_launches(fn, reps):
    """Per call of ``fn``, from ``torch.profiler``: the launches the host
    makes (kernels, graphs, copies and sets), the kernels and the copies
    that run on the card, and the card's busy milliseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = sum(e.count for e in events if e.device_type == DeviceType.CPU
               and e.key in HOST_LAUNCHES)
    rows = [e for e in events if e.device_type == DeviceType.CUDA]
    copies = sum(e.count for e in rows if e.key.startswith(("Memcpy",
                                                             "Memset")))
    kernels = sum(e.count for e in rows) - copies
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return dict(host_launches=host / reps, kernels=kernels / reps,
                copies=copies / reps, busy_ms=busy_ms / reps)


def graph_against_eager(what, cost, x, reps=20, profile_eager=False):
    """A TrainingCost's captured value and gradient at ``x`` against its
    eager code (``value_and_grad_eager``) on the card: bit for bit, or a
    difference within 1e-12 normwise that is reported; the capture and its
    replays under ``torch.cuda.set_sync_debug_mode("error")``; the bytes
    the capture took (``max_memory_allocated`` over the eager state, the
    graphs' pools); ms (CUDA events) of each way, and the host launches,
    kernels run and idle share of the graphed way and, with
    ``profile_eager``, of the eager one (its profile takes seconds)."""
    t_all = time.perf_counter()
    ev, eg = (t.clone() for t in cost.value_and_grad_eager(x))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gv, gg = (t.clone() for t in cost.value_and_grad(x))
        for _ in range(3):
            cost.value_and_grad(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    out = dict(capture_s=time.perf_counter() - t0,
               pool_bytes=torch.cuda.max_memory_allocated() - base,
               pool_reserved_bytes=torch.cuda.memory_reserved() - reserved)
    same = torch.equal(gv, ev) and torch.equal(gg, eg)
    err = max(abs(float(gv) - float(ev)) / abs(float(ev)),
              float((gg - eg).double().norm() / eg.double().norm()))
    out.update(identical=same, err=err, compared=1 + eg.numel())
    for tag, fn, n in (("eager", cost.value_and_grad_eager, reps // 2),
                       ("graphed", cost.value_and_grad, reps)):
        ms = cuda_ms(lambda: fn(x), n)
        out[tag] = dict(ms=ms, host_launches=float("nan"),
                        kernels=float("nan"), copies=float("nan"),
                        busy_ms=float("nan"))
        if tag == "graphed" or profile_eager:
            out[tag].update(step_launches(lambda: fn(x), n // 5))
        out[tag]["idle"] = (max(0.0, 1.0 - out[tag]["busy_ms"] / ms)
                            if out[tag]["busy_ms"] >= 0.0 else float("nan"))
    out["seconds"] = time.perf_counter() - t_all
    e, g = out["eager"], out["graphed"]
    log(f"[optimize] {what}, graphed against eager: value and gradient "
        f"({out['compared']} numbers) bit-identical {same}, difference "
        f"{err:.3e} (bar: identical, else 1e-12 explained); capture and 3 "
        f"replays under sync debug mode \"error\" in "
        f"{out['capture_s']:.2f} s, pool {out['pool_bytes']} bytes "
        f"(max_memory_allocated; reserved {out['pool_reserved_bytes']}); "
        f"ms per value and gradient {e['ms']:.3f} eager, {g['ms']:.3f} "
        f"graphed (CUDA events, {reps // 2} / {reps}); host launches "
        f"{e['host_launches']:.0f} against {g['host_launches']:.0f}; "
        f"kernels + copies on the card {e['kernels']:.0f} + "
        f"{e['copies']:.0f} against {g['kernels']:.0f} + "
        f"{g['copies']:.0f}; busy {e['busy_ms']:.3f} / {g['busy_ms']:.3f} "
        f"ms, idle {100 * e['idle']:.1f}% / {100 * g['idle']:.1f}% "
        f"(torch.profiler, {reps // 10 if profile_eager else 0} / "
        f"{reps // 5}; nan: not profiled); {out['seconds']:.1f} s")
    check(same or err <= 1e-12, f"{what}: graphed value and gradient "
          "within 1e-12 of the eager ones")
    return out


class eager_cost:
    """Within it, ``TrainingCost.value_and_grad`` is its plain version
    (every kernel launched from the host): the run that the graphs are
    held against."""

    def __enter__(self):
        from ecckd_tpu_torch.optimize.solver import TrainingCost
        self.graphed = TrainingCost.value_and_grad
        TrainingCost.value_and_grad = TrainingCost.value_and_grad_eager

    def __exit__(self, *exc):
        from ecckd_tpu_torch.optimize.solver import TrainingCost
        TrainingCost.value_and_grad = self.graphed


def phase_optimize(lw_profiles, lw_gp, lw_model, sw_profiles, ssi, sw_gp,
                   sw_model):
    """create_lut -> optimize_lut -> run_ckd on the LW main path's model,
    through the captured step and once more eagerly, the training step at
    bench.py's production size, and the SW step with Rayleigh active, all
    on the card, each step graphed against eager."""
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
    steps = {}

    # the chain: training fluxes, optimisation, evaluation before and after
    t0 = time.perf_counter()
    lbl = training_fluxes(lw_profiles, lw_gp.g_point, lw_model.ng, dev)
    raw_lbl = copy.deepcopy(lbl)
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
    # the same run with every evaluation eager
    eager_model = copy.deepcopy(lw_model)
    with eager_cost():
        res_e = optimize_lut_core(eager_model, [copy.deepcopy(raw_lbl)],
                                  gases=["h2o"], prior_error=4.0,
                                  max_iterations=60,
                                  convergence_criterion=0.002, device="cuda")
    same_lut = np.array_equal(model.single_gas_data[0].molar_abs,
                              eager_model.single_gas_data[0].molar_abs)
    same_run = (res.n_iterations == res_e.n_iterations
                and res.n_evaluations == res_e.n_evaluations
                and res.cost == res_e.cost)
    say(f"chain, scipy through the graphs against eager: "
        f"{res.n_iterations} / {res_e.n_iterations} iterations, "
        f"{res.n_evaluations} / {res_e.n_evaluations} evaluations, cost "
        f"{res.cost!r} / {res_e.cost!r}, LUT bit-identical {same_lut}; "
        f"{res.seconds_per_iteration * 1e3:.2f} against "
        f"{res_e.seconds_per_iteration * 1e3:.2f} ms per iteration (host "
        "clock)")
    check(same_run, "scipy through the graphs: the eager run's iterations, "
          "evaluations and final cost")
    steps["chain_scipy"] = dict(
        graphed_ms_per_iteration=1e3 * res.seconds_per_iteration,
        eager_ms_per_iteration=1e3 * res_e.seconds_per_iteration,
        iterations=res.n_iterations, evaluations=res.n_evaluations,
        lut_identical=same_lut)
    # the chain's training step, graphed against eager
    chain_model = copy.deepcopy(lw_model)
    chain_model.set_active(["h2o"])
    chain_model.create_error_covariances(4.0)
    chain_lbl = copy.deepcopy(raw_lbl)
    prepare_lbl(chain_lbl, chain_model, 1.0e4)
    chain = TrainingCost(chain_model, [chain_lbl], CostWeights(), device=dev)
    steps["chain"] = graph_against_eager(
        f"LW chain's step ({chain_lbl.ncol} columns, {chain_model.ng} "
        "g-points)", chain, chain.tensor(ravel_tree(log_state_tree(
            chain_model))))
    del chain

    # the training step at production size
    size = "ng 64, nt 6, np 53, 48 columns, 50 layers, h2o linear, o3 LUT"
    x0 = ravel_tree(log_state_tree(train_step.synthetic_model(
        64, 6, 53, lut_gas=True)))
    card, steps["production_f64"] = card_against_cpu(
        f"production step ({size})",
        lambda d: train_step.training_cost(device=d)[0], x0,
        profile_eager=True)
    x64 = card.tensor(x0)
    c32, x32 = train_step.training_cost(device="cuda", dtype=torch.float32)
    steps["production_f32"] = graph_against_eager(
        "production step float32", c32, x32)
    lev = train_step.precision_levels(card, x64, c32, x32)
    say(f"production step float32 against float64: {json.dumps(lev)}")
    for key in ("value_rel", "gradient_norm_rel", "cost_20_rel"):
        check(lev[key] <= 1e-3, f"float32 {key} within 1e-3 of float64")
    for tag, cost, x in (("f64", card, x64), ("f32", c32, x32)):
        xs = x.double().cpu().numpy()
        cost(xs)
        t0 = time.perf_counter()
        for _ in range(20):
            cost(xs)
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        steps[f"production_{tag}"]["scipy_evaluation_ms"] = host_ms
        say(f"production step {tag}: {host_ms:.3f} ms per scipy evaluation "
            "with its pinned copies, graphed (host clock, 20)")
    del card, c32

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
    _, steps["sw"] = card_against_cpu(
        f"SW step ({sw_lbl.ncol} columns, {model.ng} g-points, Rayleigh "
        "active)",
        lambda d: TrainingCost(model, [sw_lbl], CostWeights(), device=d),
        ravel_tree(log_state_tree(model)))
    say(json.dumps(steps, default=float))
    say(f"phase {time.perf_counter() - t_phase:.1f} s")
    return SimpleNamespace(hr_error=after[0], lbl=raw_lbl, res=res,
                           errors=(before, after), steps=steps)


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


class TimedSource:
    """A profile's block source that counts the blocks and bytes its
    ``iter_blocks`` yields and the seconds from its opening to its
    ``close``, into ``stats`` (a list of per-profile dicts)."""

    def __init__(self, source, stats):
        self._source = source
        self._stat = dict(t0=time.perf_counter(), blocks=0, bytes=0)
        stats.append(self._stat)

    def __getattr__(self, name):
        return getattr(self._source, name)

    def iter_blocks(self, block_wav):
        for i0, block in self._source.iter_blocks(block_wav=block_wav):
            self._stat["blocks"] += 1
            self._stat["bytes"] += block.nbytes
            yield i0, block

    def close(self):
        self._source.close()
        self._stat["seconds"] = time.perf_counter() - self._stat["t0"]


def device_ms(prof, names):
    """Device milliseconds and launches of a profile's kernels and copies,
    by the first of ``names`` (name -> substring of the kernel's name)
    that each matches, the rest under "other"; and the device's busy
    milliseconds."""
    from torch.autograd import DeviceType
    ms = {k: [0.0, 0] for k in list(names) + ["other"]}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            key = next((k for k, sub in names.items() if sub in e.key),
                       "other")
            ms[key][0] += e.self_device_time_total / 1e3
            ms[key][1] += e.count
    ms = {k: [round(v[0], 3), v[1]] for k, v in ms.items()}
    return ms, sum(v[0] for v in ms.values())


def hold_probe_kernels(k, i1, i2, say):
    """K3 and K1 on one logged probe of an LW search, launched on the
    probe's own inputs as its cost launched them (bounds padded to the
    bucket, the partition map, the od fitted from the sums), each held
    against its plain version on the same inputs at phase 3's bar;
    returns {name: dict(max_rel_err, max_abs_err, ms, plain_ms)}."""
    from ecckd_tpu_torch.ops.kernels import (fused_interval_sum,
                                             sweep_lw_intervals,
                                             sweep_lw_plain)
    from ecckd_tpu_torch.ops.kernels.interval_stream import device_bounds
    from ecckd_tpu_torch.ops.segments import interval_sum_fused
    from ecckd_tpu_torch.partition.cost_kernel import _pad_to_bucket
    pad = _pad_to_bucket(len(i1)) - len(i1)
    d1, d2 = device_bounds(np.r_[np.zeros(pad, np.int32), i1].astype(np.int32),
                           np.r_[np.zeros(pad, np.int32), i2].astype(np.int32),
                           k.device)
    n = k.npoints
    sums = lambda: (fused_interval_sum(k._parts, n, d1, d2, dtype=k.dtype),)
    plain_sums = lambda: (interval_sum_fused(k._parts, n, d1, d2,
                                             dtype=k.dtype),)
    od_fit = k._fit_finish(plain_sums()[0][:k._fit_rows], d1, d2)
    args = (k.planck_hl, k.bg_od, od_fit.contiguous(),
            k._device_seg_of_wav(d1), k.surf_emissivity, k.surf_planck, d1,
            d2)
    out = {}
    for name, kern, plain in (
            ("K3", sums, plain_sums),
            ("K1", lambda: sweep_lw_intervals(*args),
             lambda: sweep_lw_plain(*args))):
        got, want = kern(), plain()
        sync(k.device)
        errs = [row_err(g, w) for g, w in zip(got, want)]
        rel, absolute = max(e[0] for e in errs), max(e[1] for e in errs)
        card = k.device.type == "cuda"
        out[name] = dict(max_rel_err=rel, max_abs_err=absolute,
                         ms=cuda_ms(kern, 3) if card else None,
                         plain_ms=cuda_ms(plain, 1) if card else None)
        del got, want
        say(f"{name} on a probe of the search ({len(i1)} intervals, ranks "
            f"{int(i1[0])}..{int(i2[-1])} of {n}, {k.planck_hl.shape[0]} x "
            f"{n} f64 levels): max rel err (normwise per row) {rel:.3e} "
            f"(bar {BARS[k.dtype]:.0e}), max abs err {absolute:.3e}; kernel "
            f"{out[name]['ms']} ms, plain {out[name]['plain_ms']} ms (CUDA "
            "events)")
        check(rel <= BARS[k.dtype], f"{name} on the CKDMIP search's probe "
              f"within {BARS[k.dtype]} of its plain version")
    return out


def reference_sums(path, icol, g_point, ng, block, dev, say):
    """One profile's transmission-average sums two ways: the streamed
    path's block partials (blocks read through ``open_spectrum_profile``,
    reduced and combined by the port's block loop, ``fold_blocks``), and a
    plain whole-array reduction independent of them (the profile's f64 od on
    the card, ``index_add_`` over the g-point map for the sums, the
    members of each g-point gathered in rank order for min and max).
    Holds the sums within 1e-12 normwise and min and max bit-identical;
    returns (the streamed partials, and the reference's transmission sum,
    weight sum, min and max, each (nlay, ng) numpy)."""
    from ecckd_tpu_torch.constants import LW_DIFFUSIVITY
    from ecckd_tpu_torch.io.spectrum import open_spectrum_profile
    from ecckd_tpu_torch.ops.planck import planck_function
    from ecckd_tpu_torch.ops.average import gpoint_block_partials
    from ecckd_tpu_torch.ops.streaming import fold_blocks
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                  device=dev)
    gp = torch.as_tensor(np.asarray(g_point), device=dev)
    t0 = time.perf_counter()
    with open_spectrum_profile(path, icol) as pb:
        p_hl = np.asarray(pb.pressure_hl)
        p_fl = 0.5 * (p_hl[:-1] + p_hl[1:])
        t_x_p = np.asarray(pb.temperature_hl) * p_hl
        t_fl = f(0.5 * (t_x_p[:-1] + t_x_p[1:]) / p_fl)
        wav, dwav = f(pb.wavenumber), f(pb.d_wavenumber)

        def reduce(i0, blk):
            sl = slice(i0, i0 + blk.shape[1])
            return gpoint_block_partials(
                ng, gp[sl], blk, planck_function(t_fl, wav[sl], dwav[sl]),
                "transmission")

        acc = fold_blocks(pb.iter_blocks(block_wav=block), reduce, dev,
                          torch.float64)
        od = f(pb.materialize().optical_depth)
    t_streamed = time.perf_counter() - t0
    sync(dev)
    t0 = time.perf_counter()
    w = planck_function(t_fl, wav, dwav)
    nlay = od.shape[0]
    zeros = lambda: torch.zeros((nlay, ng), dtype=torch.float64, device=dev)
    num = zeros().index_add_(1, gp, -torch.expm1(-od * LW_DIFFUSIVITY) * w)
    den = zeros().index_add_(1, gp, w)
    del w
    members = od[:, torch.argsort(gp, stable=True)]
    del od
    edges = np.r_[0, np.cumsum(torch.bincount(gp, minlength=ng).cpu().numpy())]
    mn = torch.stack([members[:, a:b].amin(1) for a, b in zip(edges[:-1],
                                                             edges[1:])], 1)
    mx = torch.stack([members[:, a:b].amax(1) for a, b in zip(edges[:-1],
                                                             edges[1:])], 1)
    del members
    sync(dev)
    t_ref = time.perf_counter() - t0
    num, den, mn, mx = (t.cpu().numpy() for t in (num, den, mn, mx))
    e_num = normwise([acc["num"]], [num])
    e_den = normwise([acc["w_sum"]], [den])
    same = (np.array_equal(acc["min"], mn) and np.array_equal(acc["max"], mx))
    say(f"profile {icol}: streamed block partials ({t_streamed:.2f} s) "
        f"against a whole-array index_add_ reduction ({t_ref:.2f} s on "
        f"{dev}): transmission sums {e_num:.3e}, weights {e_den:.3e} "
        f"(normwise, bar 1e-12); min and max bit-identical {same}")
    check(e_num <= 1e-12 and e_den <= 1e-12 and same,
          "streamed partials against the independent reduction")
    return acc, num, den, mn, mx


def time_minmax(say, nz=NLAY_FULL, nb=BLOCK_CKDMIP, ng=33, reps=20):
    """K4 at the streamed create_lut's block shape (``nz`` x ``nb``, ``ng``
    g-points, some wavenumbers unassigned), float64 and float32: held bit
    for bit against its plain version on the card, then its time beside
    its bound (od and the g-point map read once, the two (nz, ng) tables
    written), the two ``scatter_reduce`` calls alone on a prebuilt index
    (the library) and the plain version whole (the index built, then both
    calls), by CUDA events.  Returns {dtype tag: dict of ms}."""
    from ecckd_tpu_torch.ops.average import _segment_min_max
    from ecckd_tpu_torch.ops.kernels import segment_min_max
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randint(-1, ng, (nb,), device=dev, generator=gen)
    layer = ng * torch.arange(nz, device=dev)
    seg_ids = torch.where(g[None, :] >= 0, g[None, :] + layer[:, None],
                          nz * ng).reshape(-1)
    out = {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        od = torch.randn((nz, nb), device=dev, dtype=dtype, generator=gen)
        ints = torch.int64 if dtype == torch.float64 else torch.int32
        got = segment_min_max(ng, g, od)
        want = _segment_min_max(ng, g, od)
        check(all(torch.equal(a.view(ints), b.view(ints))
                  for a, b in zip(got, want)),
              f"K4 {tag} bit-identical to scatter_reduce at {nz} x {nb}")
        flat = od.reshape(-1)

        def library():
            for init, how in ((float("inf"), "amin"),
                              (-float("inf"), "amax")):
                torch.full((nz * ng + 1,), init, dtype=dtype,
                           device=dev).scatter_reduce(0, seg_ids, flat, how)

        nbytes = (od.numel() * od.element_size()
                  + g.numel() * g.element_size() + 2 * nz * ng
                  * od.element_size())
        ms = dict(kernel_ms=cuda_ms(lambda: segment_min_max(ng, g, od), reps),
                  bound_ms=bound(nbytes, 0, dtype)[0],
                  library_ms=cuda_ms(library, 3),
                  plain_ms=cuda_ms(lambda: _segment_min_max(ng, g, od), 3))
        say(f"K4 min/max {tag} at {nz} x {nb}, {ng} g-points: "
            + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
        out[tag] = ms
        del od, got, want, flat
    return out


def hold_lut_independent(model, gp, path, block, p_hl, dev, say, out):
    """Profile 0 of a streamed LUT against a reduction independent of the
    block code (:func:`reference_sums`).  The LUT must be the finalised
    streamed partials bit for bit, and its min and max the reference's.
    Its mean transmissions must be the reference's within 1e-12 in every
    entry, and its molar absorption the one-pass fit of the reference's
    (-log1p(-mean), clamped as average_optical_depth.cpp:120-163 does, on
    the host as the port does): within 1e-10 normwise where the fit is
    well conditioned (kappa = mean / ((1 - mean) (-log1p(-mean))) <= 100,
    so that means within 1e-12 give fits within 1e-10), bit for bit where
    both means sit at the transmission clamp, and everywhere between the
    fits of the reference's mean moved by -1e-12 and +1e-12.  Towards the
    clamp -log1p(-mean) turns the sums' last bits into the od's leading
    digits (ROADMAP §3): there the last bound is the one that holds."""
    from ecckd_tpu_torch.constants import LW_DIFFUSIVITY
    from ecckd_tpu_torch.ops.average import (_TRANS_CLAMP,
                                             finalize_gpoint_partials,
                                             od_to_molar_abs)
    ng = len(gp.band_number)
    acc, num, den, mn, mx = reference_sums(path, 0, gp.g_point, ng, block,
                                           dev, say)
    g = model.single_gas_data[0]
    conv = lambda a: od_to_molar_abs(a, p_hl, 0.01)
    lut = (g.molar_abs[0], g.min_molar_abs[0], g.max_molar_abs[0])
    check(all(np.array_equal(conv(a), b) for a, b in zip(
        finalize_gpoint_partials(acc, "transmission"), lut)),
        "the streamed LUT's profile 0 is its finalised block partials")
    mean, mean_s = num / den, acc["num"] / acc["w_sum"]
    e_mean = float(np.max(np.abs(mean_s / mean - 1.0)))

    def fit_of(m):
        od = np.abs(-np.log1p(-np.minimum(_TRANS_CLAMP, m)) / LW_DIFFUSIVITY)
        return conv(np.maximum(mn, np.minimum(od, mx)))

    ref, lo, hi = (fit_of(mean * (1.0 + d)) for d in (0.0, -1e-12, 1e-12))
    # a degenerate range is widened after the fit is clamped to it
    degenerate = (mn > 0.0) & (mn >= mx)
    same_range = (
        np.array_equal(conv(np.where(degenerate, mn * 0.99, mn)), lut[1])
        and np.array_equal(conv(np.where(degenerate, mx * 1.01, mx)), lut[2]))
    m = np.minimum(mean, _TRANS_CLAMP)
    with np.errstate(divide="ignore", invalid="ignore"):
        kappa = m / ((1.0 - m) * -np.log1p(-m))
    well = kappa <= 100.0
    clamped = (mean >= _TRANS_CLAMP) & (mean_s >= _TRANS_CLAMP)
    rest = ~well & ~clamped
    e_well = normwise([lut[0][well]], [ref[well]])
    e_rest = (float(np.max(np.abs(lut[0][rest] / ref[rest] - 1.0)))
              if rest.any() else 0.0)
    same_clamped = np.array_equal(lut[0][clamped], ref[clamped])
    bracketed = np.all((lo <= lut[0]) & (lut[0] <= hi))
    say(f"streamed LUT profile 0 against the one-pass fit of the "
        f"independent sums: min and max bit-identical {same_range}; mean "
        f"transmissions {e_mean:.3e} (worst entry, bar 1e-12); "
        f"{int(well.sum())} well-conditioned entries {e_well:.3e} normwise "
        f"(bar 1e-10); {int(clamped.sum())} at the clamp in both, "
        f"bit-identical {same_clamped}; {int(rest.sum())} towards the clamp "
        f"(kappa > 100), worst {e_rest:.3e} relative; every entry between "
        f"the fits of the mean moved by 1e-12 {bracketed}")
    out.update(lut_independent=dict(
        mean_err=e_mean, well=int(well.sum()), well_err=e_well,
        clamped=int(clamped.sum()), near=int(rest.sum()), near_err=e_rest))
    check(same_range and e_mean <= 1e-12 and e_well <= 1e-10
          and same_clamped and bracketed,
          "streamed LUT within its bars of the independent one-pass fit")


def lut_paths_at_main_size(profiles, gp, smi, device="cuda"):
    """create_lut on the LW main path's g-points and profiles (2^20 x 50,
    arrays in memory), streamed (``streaming=1``: a block a profile, read
    one ahead) and dense (``streaming=0``), in the order streamed, dense,
    dense, streamed: seconds of each and the same bits."""
    from ecckd_tpu_torch.models import ConcDependence
    from ecckd_tpu_torch.tools.create_lut import LutGas, create_lut_core
    runs = {"1": [], "0": []}
    models = {}
    for mode in ("1", "0", "0", "1"):
        t0 = time.perf_counter()
        models[mode] = create_lut_core(
            gp.g_point, gp.wavenumber1_band, gp.wavenumber2_band,
            gp.band_number,
            [LutGas("h2o", ConcDependence.LINEAR,
                    [lambda icol: (profiles[icol], 0.01)])],
            averaging_method="transmission", device=device, streaming=mode)
        sync(device)
        runs[mode].append(time.perf_counter() - t0)
    a, b = (models[m].single_gas_data[0] for m in ("1", "0"))
    same = all(np.array_equal(getattr(a, n), getattr(b, n)) for n in (
        "molar_abs", "min_molar_abs", "max_molar_abs"))
    nlay, nwav = profiles[0].optical_depth.shape
    log(f"[ckdmip] create_lut at {nwav} x {nlay}, {len(profiles)} "
        f"profiles from memory: streamed {[round(t, 3) for t in runs['1']]}"
        f" s, dense {[round(t, 3) for t in runs['0']]} s (host clock, "
        f"order streamed, dense, dense, streamed); bit-identical {same} "
        f"({smi})")
    check(same, "streamed and dense create_lut bit-identical at 2^20")


def phase_ckdmip(smi, device="cuda"):
    """Phase 11: the LW chain at CKDMIP scale from shards on disk.  Two
    profiles of 5,600,000 wavenumbers x 50 layers written to float32
    shards, read back through ``open_spectrum_profile``: reorder ->
    find_g_points (K1 and K3 at 5.6M wavenumbers; once more on the checked
    build; K1 and K3 on the search's largest probe held against their
    plain versions) -> create_lut streamed ("auto") and dense
    (``streaming=0``), min/max bit-identical, and profile 0 of the
    streamed LUT against a whole-array reduction independent of the block
    code -> lw_spectra with and without the g-points, and one
    full-resolution call under torch.profiler.  The shards are read back
    both through the loader's pool and through the tools' path."""
    import os
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from ecckd_tpu_torch.constants import (ACCEL_GRAVITY, LW_DIFFUSIVITY,
                                           MOLAR_MASS_DRY_AIR)
    from ecckd_tpu_torch.io import native
    from ecckd_tpu_torch.io.shards import ShardReader, write_shard
    from ecckd_tpu_torch.io.spectrum import Spectrum, open_spectrum_profile
    from ecckd_tpu_torch.models import ConcDependence
    from ecckd_tpu_torch.ops.average import _TRANS_CLAMP
    from ecckd_tpu_torch.ops.kernels import _build, reset_launch_counts
    from ecckd_tpu_torch.tools.create_lut import (LutGas, _Execution,
                                                  create_lut_core)
    from ecckd_tpu_torch.tools.lw_spectra import lw_spectra_core
    say = lambda line: log(f"[ckdmip] {line}")
    dev = torch.device(device)
    t_phase = time.perf_counter()
    nwav, nlay, ncol = NWAV_CKDMIP, NLAY_FULL, NCOL_CKDMIP
    block = BLOCK_CKDMIP
    secs, out = {}, {}

    t0 = time.perf_counter()
    native.get_lib()
    say(f"native shard loader {native.library_path().name} built and "
        f"loaded in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    profiles = lw_spectrum(nwav, nlay, ncol, seed=0, nlines=120,
                           width=(2.0, 40.0), wav_max=2500.0)
    secs["spectrum"] = time.perf_counter() - t0
    say(f"spectrum {nwav} x {nlay}, {ncol} profiles built on the host in "
        f"{secs['spectrum']:.1f} s")
    root = _build.BUILD_DIR.parent
    root.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root).free
    need = ncol * nwav * (nlay * 4 + 16)
    say(f"disk free under {root}: {free / 1e9:.2f} GB before writing "
        f"{need / 1e9:.2f} GB of shards")
    check(free > 2 * need, "room for the shards on disk")
    with tempfile.TemporaryDirectory(dir=root, prefix="ckdmip_") as tmp:
        t0 = time.perf_counter()
        paths = [write_shard(
            os.path.join(tmp, f"h2o_{icol:03d}.spbin"),
            Spectrum(sp.pressure_hl, sp.temperature_hl, sp.wavenumber,
                     sp.d_wavenumber, sp.optical_depth, "h2o", 0.01,
                     np.full(nlay, 0.01), ncol), np.float32)
            for icol, sp in enumerate(profiles)]
        secs["write"] = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(p) for p in paths)
        say(f"wrote {len(paths)} float32 shards, {nbytes} bytes, in "
            f"{secs['write']:.2f} s ({nbytes / secs['write'] / 1e9:.2f} "
            "GB/s)")
        del profiles
        t0 = time.perf_counter()
        nread = nblocks = 0
        for path in paths:
            with ShardReader(path) as r:
                for _, b in r.iter_blocks(block_wav=block):
                    nread += b.nbytes
                    nblocks += 1
        secs["read"] = time.perf_counter() - t0
        out.update(shard_bytes=nbytes, read_bytes=nread,
                   read_gb_s=nread / secs["read"] / 1e9)
        say(f"read the shards' od back through ShardReader.iter_blocks "
            f"(the loader's thread pool) in {nblocks} blocks of {block} "
            f"wavenumbers: {nread} bytes in {secs['read']:.2f} s, "
            f"{nread / secs['read'] / 1e9:.2f} GB/s (page cache warm: "
            "written just before)")
        # the tools' path: open_spectrum_profile, a synchronous pread a
        # block, widened to float64 on the host
        t0 = time.perf_counter()
        nread = nout = 0
        for icol in range(ncol):
            with open_spectrum_profile(paths[0], icol) as pb:
                for _, b in pb.iter_blocks(block_wav=block):
                    nread += b.size * 4
                    nout += b.nbytes
        secs["read_tools"] = time.perf_counter() - t0
        out.update(read_tools_gb_s=nread / secs["read_tools"] / 1e9)
        say(f"read them back through open_spectrum_profile(...).iter_blocks,"
            f" the tools' path: {nread} shard bytes in "
            f"{secs['read_tools']:.2f} s, {out['read_tools_gb_s']:.2f} GB/s "
            f"read, {nout / secs['read_tools'] / 1e9:.2f} GB/s of float64 "
            "blocks")

        # the chain
        t0 = time.perf_counter()
        with open_spectrum_profile(paths[0], 0) as pb:
            check(pb.ncol == ncol and pb.nwav == nwav and pb.nlay == nlay,
                  "shard metadata")
            sp0 = pb.materialize()
            p_hl = pb.pressure_hl
        secs["materialize"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        order = order_of(sp0, dev)
        sync(dev)
        secs["reorder"] = time.perf_counter() - t0
        gas = gas_input(order, sp0)
        probes = []
        reset_launch_counts()
        t0 = time.perf_counter()
        gp = search(gas, dev, HR_TOL, band_parallel="auto",
                    cost_options=dict(probe_log=probes))
        sync(dev)
        secs["find_g_points"] = time.perf_counter() - t0
        launches = launch_counts()
        out["search_launches"] = launches
        say(f"find_g_points at {nwav} wavenumbers: launches {launches}")
        for name in ("sweep_lw_intervals", "fused_interval_sum"):
            check(launches[name] > 0 or dev.type == "cpu",
                  f"{name} launched at CKDMIP scale")
        # the probe of most intervals, of those the one reaching furthest
        k, i1, i2, _ = max(probes, key=lambda p: (len(p[1]), int(p[2][-1])))
        out["search_probe_kernels"] = hold_probe_kernels(k, i1, i2, say)
        del probes, k
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            again = search(gas, dev, HR_TOL, band_parallel="auto")
            sync(dev)
        check(same_search(gp, again), "CKDMIP search repeats bit-identical")
        k_ms, busy = device_ms(prof, {"K1": "sweep_lw_kernel",
                                      "K3": "stream_kernel",
                                      "sum_slots": "sum_slots"})
        say(f"find_g_points under torch.profiler: device [ms, launches] "
            f"{k_ms}, busy {busy:.1f} ms")
        out["search_device"] = k_ms
        t0 = time.perf_counter()
        with _build.checked():
            gp_checked = search(gas, dev, HR_TOL, band_parallel="auto")
            sync(dev)
        secs["find_g_points_checked"] = time.perf_counter() - t0
        gc_, g_ = gp_checked.gases[0], gp.gases[0]
        check(np.array_equal(gc_.rank1, g_.rank1)
              and np.array_equal(gc_.rank2, g_.rank2),
              "CKDMIP search on the checked build: the same ranks")
        say(f"find_g_points on the checked build: {secs['find_g_points_checked']:.2f}"
            f" s, no index out of range, the same ranks, errors "
            f"bit-identical {np.array_equal(gc_.error, g_.error)}")
        del sp0, gas, order, again, gp_checked

        # create_lut streamed and dense from the shards
        check(_Execution().use_streaming(nlay, nwav),
              "auto streams at CKDMIP scale")

        def lut(streaming, stats):
            def open_profile(icol):
                return TimedSource(open_spectrum_profile(paths[0], icol),
                                   stats), 0.01
            return create_lut_core(
                gp.g_point, gp.wavenumber1_band, gp.wavenumber2_band,
                gp.band_number,
                [LutGas("h2o", ConcDependence.LINEAR, [open_profile])],
                averaging_method="transmission", device=dev,
                streaming=streaming, streaming_block_wav=block)

        runs = {}
        for mode in ("auto", "0"):
            stats = []
            t0 = time.perf_counter()
            model = lut(mode, stats)
            sync(dev)
            runs[mode] = (model, stats, time.perf_counter() - t0)
            out[f"lut_{mode}"] = dict(
                seconds=runs[mode][2],
                profile_seconds=[st["seconds"] for st in stats],
                blocks=[st["blocks"] for st in stats])
            say(f"create_lut streaming={mode}: {runs[mode][2]:.2f} s; per "
                f"profile seconds "
                f"{[round(st['seconds'], 3) for st in stats]}, blocks "
                f"{[st['blocks'] for st in stats]}, bytes streamed "
                f"{[st['bytes'] for st in stats]}")
        streamed, dense = runs["auto"][0], runs["0"][0]
        check(all(st["blocks"] == -(-nwav // block) for st in runs["auto"][1])
              and all(st["blocks"] == 0 for st in runs["0"][1]),
              "streaming auto streamed every profile in blocks, "
              "streaming=0 none")
        say(f"streaming auto chose streaming: {runs['auto'][1][0]['blocks']}"
            f" blocks a profile")
        chain_checks("CKDMIP", gp, streamed, nwav, ncol, nlay, HR_TOL)
        gs, gd = streamed.single_gas_data[0], dense.single_gas_data[0]
        check(np.array_equal(gs.min_molar_abs, gd.min_molar_abs)
              and np.array_equal(gs.max_molar_abs, gd.max_molar_abs),
              "streamed min and max molar absorption bit-identical to dense")
        # where the mean transmission sits at the clamp, the fitted od is
        # the clamp's; there the fit is ill-conditioned (ROADMAP §3)
        dp = np.diff(p_hl)[None, :, None]
        od = gd.molar_abs * 0.01 / (ACCEL_GRAVITY * 0.001
                                    * MOLAR_MASS_DRY_AIR) * dp
        od_clamp = -np.log1p(-_TRANS_CLAMP) / LW_DIFFUSIVITY
        at = od >= od_clamp * (1.0 - 1e-9)
        below = normwise([gs.molar_abs[~at]], [gd.molar_abs[~at]])
        rel_at = (float(np.max(np.abs(gs.molar_abs[at] / gd.molar_abs[at]
                                      - 1.0))) if at.any() else 0.0)
        same = np.array_equal(gs.molar_abs, gd.molar_abs)
        say(f"streamed against dense molar absorption: {int(at.sum())} of "
            f"{at.size} entries at the transmission clamp; below it "
            f"{below:.3e} normwise (bar 1e-10), at it {rel_at:.3e} "
            f"(bar 1e-6); bit-identical {same}")
        out.update(lut_below_clamp=below, lut_at_clamp=rel_at,
                   lut_at_clamp_entries=int(at.sum()),
                   lut_bit_identical=same)
        check(below <= 1e-10 and rel_at <= 1e-6,
              "streamed molar absorption within its bars of dense")
        hold_lut_independent(streamed, gp, paths[0], block, p_hl, dev, say,
                             out)

        if dev.type == "cuda":
            out["minmax"] = time_minmax(say)

        # the streamed run once more under torch.profiler
        stats = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lut("auto", stats)
            sync(dev)
            wall = time.perf_counter() - t0
        ms, busy = device_ms(prof, {"min/max K4": "scatter",
                                    "one-hot matmuls": "gemm",
                                    "copies": "Memcpy"})
        idle = max(0.0, 1 - busy / 1e3 / wall)
        say(f"create_lut streamed under torch.profiler: wall {wall:.3f} s, "
            f"device busy {busy / 1e3:.3f} s, idle {100 * idle:.1f}%; "
            f"device [ms, launches] {ms}")
        out.update(lut_profiled_wall=wall, lut_device=ms, lut_idle=idle)

        # lw_spectra with and without the g-points; profile 0's run at full
        # resolution under torch.profiler, to see where its time goes
        import contextlib
        ng = len(gp.band_number)
        for icol in range(ncol):
            res = {}
            for tag, g in (("full", None), ("g-points", gp.g_point)):
                profiled = (icol, tag) == (0, "full")
                with (profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
                      if profiled else contextlib.nullcontext()) as p:
                    t0 = time.perf_counter()
                    with open_spectrum_profile(paths[0], icol) as pb:
                        res[tag] = lw_spectra_core(
                            pb, g, ng if g is not None else None,
                            device=dev)
                    sync(dev)
                    secs[f"lw_spectra {tag} {icol}"] = (time.perf_counter()
                                                        - t0)
                if profiled:
                    prof = p
            full, gpt = res["full"], res["g-points"]
            check(full.spectral_flux_dn.shape == (nlay + 1, nwav)
                  and gpt.spectral_flux_dn.shape == (nlay + 1, ng)
                  and gpt.optical_depth.shape == (nlay, ng)
                  and all(np.all(np.isfinite(a)) for a in (
                      gpt.flux_dn, gpt.flux_up, gpt.spectral_flux_dn,
                      gpt.spectral_flux_up, gpt.optical_depth)),
                  "lw_spectra shapes, finite")
            e_bb = normwise([gpt.flux_dn, gpt.flux_up],
                            [full.flux_dn, full.flux_up])
            e_sum = normwise([gpt.spectral_flux_dn.sum(-1),
                              gpt.spectral_flux_up.sum(-1)],
                             [gpt.flux_dn, gpt.flux_up])
            say(f"lw_spectra profile {icol}: full "
                f"{secs[f'lw_spectra full {icol}']:.2f} s, g-points "
                f"{secs[f'lw_spectra g-points {icol}']:.2f} s; g-point "
                f"broadband against full {e_bb:.3e}, g-point fluxes summed "
                f"against broadband {e_sum:.3e} (normwise, bars 1e-12); "
                f"surface downwelling {gpt.flux_dn[-1]:.6f} W m-2")
            out[f"lw_spectra_{icol}"] = dict(broadband=e_bb, summed=e_sum)
            check(e_bb <= 1e-12 and e_sum <= 1e-12,
                  "lw_spectra broadband fluxes within 1e-12")
            del res, full, gpt
        # where a full-resolution lw_spectra's time goes
        from torch.autograd import DeviceType
        wall = secs["lw_spectra full 0"]
        ms, busy = device_ms(prof, {"DtoH copies": "Memcpy DtoH",
                                    "HtoD copies": "Memcpy HtoD"})
        host = [(e.key, e.self_cpu_time_total / 1e3)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CPU]
        ops_ms = sum(v for _, v in host)
        top = [(key, round(v, 1)) for key, v in
               sorted(host, key=lambda kv: -kv[1])[:6]]
        say(f"lw_spectra full resolution, profile 0, under torch.profiler: "
            f"wall {wall:.3f} s, device busy {busy / 1e3:.3f} s; device "
            f"[ms, launches] {ms}; host ms in PyTorch's ops {ops_ms:.1f} "
            f"(self time, all threads; most: {top}); the rest of the wall, "
            f"{1e3 * wall - ops_ms:.1f} ms, is outside them (numpy: filling "
            "the fresh spectral arrays, the float64 widening, waiting for "
            "the next block)")
        out.update(lw_spectra_profiled=dict(wall=wall, busy_ms=busy,
                                            device=ms, host_ops_ms=ops_ms,
                                            top_host_ops=top))
    out["seconds"] = secs
    out["phase_seconds"] = time.perf_counter() - t_phase
    say(f"summary {json.dumps(out)} ({smi})")
    say(f"phase {out['phase_seconds']:.1f} s")


# ---------------------------------------------------------------- phase 12
WORKFLOW_STAGE1 = ("reorder_h2o", "find_g_points", "create_lut")
SW_MU0 = (0.9, 0.7, 0.5, 0.3, 0.1)


def write_classic(path, dims, variables, attributes=()):
    """A classic NetCDF file (``NcWriter(format="classic")``) of ``dims``
    {name: length}, ``variables`` {name: (type, dims, data)} and global
    ``attributes`` {name: text}."""
    from ecckd_tpu_torch.io.ncio import NcWriter
    with NcWriter(path, format="classic") as w:
        for name, length in dims.items():
            w.define_dimension(name, length)
        for name, (kind, var_dims, _) in variables.items():
            w.define_variable(name, kind, *var_dims)
        for name, (_, _, data) in variables.items():
            w.write(data, name)
        for name, value in dict(attributes).items():
            w.write_attribute(value, name)
    return path


def write_scenario(path, profiles):
    """The profiles as a run_ckd scenario, in the schema of
    tests/synth.py:95-128 (h2o at 0.01)."""
    nlay = profiles[0].optical_depth.shape[0]
    p = np.stack([sp.pressure_hl for sp in profiles])
    t = np.stack([sp.temperature_hl for sp in profiles])
    return write_classic(
        path, {"column": len(profiles), "half_level": nlay + 1,
               "level": nlay},
        {"pressure_hl": ("double", ("column", "half_level"), p),
         "temperature_hl": ("double", ("column", "half_level"), t),
         "h2o_mole_fraction_fl": ("double", ("column", "level"),
                                  np.full((len(profiles), nlay), 0.01))},
        {"experiment": "chip smoke workflow", "experiment_id": "smoke",
         "sub_experiment": "", "sub_experiment_id": ""})


def write_lw_training(path, lbl):
    """LW training fluxes (an LblFluxes from :func:`training_fluxes`) in
    the schema of tests/synth.py:195-256."""
    ncol, nhl = lbl.pressure_hl.shape
    ng = lbl.spectral_flux_dn.shape[-1]
    col_hl = ("column", "half_level")
    return write_classic(
        path, {"column": ncol, "half_level": nhl, "level": nhl - 1,
               "gas": 1, "g_point": ng},
        {"pressure_hl": ("double", col_hl, lbl.pressure_hl),
         "temperature_hl": ("double", col_hl, lbl.temperature_hl),
         "mole_fraction_fl": ("double", ("column", "gas", "level"),
                              lbl.vmr_fl),
         "flux_dn_lw": ("double", col_hl, lbl.flux_dn),
         "flux_up_lw": ("double", col_hl, lbl.flux_up),
         "spectral_flux_dn_lw": ("double", col_hl + ("g_point",),
                                 lbl.spectral_flux_dn),
         "spectral_flux_up_lw": ("double", col_hl + ("g_point",),
                                 lbl.spectral_flux_up)},
        {"constituent_id": "h2o"})


def write_sw_training(path, profiles, ssi, g_point, ng, dev):
    """SW training fluxes of the profiles in the schema of
    tests/synth.py:273-347, computed on the card as it computes them: the
    direct beam and the no-Rayleigh upwelling (``rt_norayleigh_sw``) at
    its five zenith angles over a surface albedo of 0.15, summed over the
    spectrum and over each g-point."""
    from ecckd_tpu_torch.ops import rt_norayleigh_sw
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                  device=dev)
    gp = torch.as_tensor(np.asarray(g_point), dtype=torch.int64, device=dev)
    onehot = (gp[:, None] == torch.arange(ng, device=dev)[None, :]).double()
    ncol, nmu0 = len(profiles), len(SW_MU0)
    nhl = profiles[0].optical_depth.shape[0] + 1
    out = {k: np.zeros((ncol, nmu0, nhl) + ((ng,) if k[0] == "s" else ()))
           for k in ("fd", "fu", "sfd", "sfu")}
    for ic, sp in enumerate(profiles):
        od = f(sp.optical_depth)
        albedo = torch.full_like(od[0], 0.15)
        for im, mu0 in enumerate(SW_MU0):
            fd, fu = rt_norayleigh_sw(mu0, f(ssi), od, albedo)
            for key, flux in (("fd", fd.sum(-1)), ("fu", fu.sum(-1)),
                              ("sfd", fd @ onehot), ("sfu", fu @ onehot)):
                out[key][ic, im] = flux.cpu().numpy()
        del od
    nlay = nhl - 1
    cmh = ("column", "mu0", "half_level")
    return write_classic(
        path, {"column": ncol, "mu0": nmu0, "half_level": nhl,
               "level": nlay, "gas": 1, "g_point": ng},
        {"mu0": ("double", ("mu0",), np.asarray(SW_MU0)),
         "pressure_hl": ("double", ("column", "half_level"),
                         np.stack([sp.pressure_hl for sp in profiles])),
         "temperature_hl": ("double", ("column", "half_level"),
                            np.stack([sp.temperature_hl
                                      for sp in profiles])),
         "mole_fraction_fl": ("double", ("column", "gas", "level"),
                              np.full((ncol, 1, nlay), 0.01)),
         "flux_dn_direct_sw": ("double", cmh, out["fd"]),
         "flux_up_sw": ("double", cmh, out["fu"]),
         "spectral_flux_dn_direct_sw": ("double", cmh + ("g_point",),
                                        out["sfd"]),
         "spectral_flux_up_sw": ("double", cmh + ("g_point",), out["sfu"])},
        {"constituent_id": "h2o"})


def write_scale_lbl(path, sp, ssi, dev, mu0=0.5):
    """scale_lut's line-by-line file: the direct beam of one profile at
    full resolution (``rt_direct_sw`` at cosine zenith angle ``mu0``, as
    phase 6b computes it), in the schema of tests/test_aux_tools.py:208-228."""
    from ecckd_tpu_torch.ops.rt_sw import rt_direct_sw
    flux = rt_direct_sw(mu0, torch.as_tensor(ssi, device=dev),
                        torch.as_tensor(sp.optical_depth, device=dev))
    nlay, nwav = sp.optical_depth.shape
    return write_classic(
        path, {"column": 1, "mu0": 1, "half_level": nlay + 1,
               "level": nlay, "gas": 1, "wavenumber": nwav},
        {"mu0": ("double", ("mu0",), np.array([mu0])),
         "pressure_hl": ("double", ("column", "half_level"),
                         sp.pressure_hl[None]),
         "temperature_hl": ("double", ("column", "half_level"),
                            sp.temperature_hl[None]),
         "mole_fraction_fl": ("double", ("column", "gas", "level"),
                              np.full((1, 1, nlay), 0.01)),
         "spectral_flux_dn_direct_sw": (
             "double", ("column", "half_level", "wavenumber"),
             flux.cpu().numpy()[None])},
        {"constituent_id": "h2o"})


def write_ssi(path, wavenumber, ssi):
    """The solar spectrum in the schema of tests/synth.py's
    synth_ssi_file."""
    return write_classic(
        path, {"wavenumber": len(wavenumber)},
        {"wavenumber": ("double", ("wavenumber",), wavenumber),
         "solar_spectral_irradiance": ("double", ("wavenumber",), ssi),
         "total_solar_irradiance": ("double", (), float(ssi.sum()))})


def write_profile_shards(tmp, profiles):
    """The profiles as float32 ``.spbin`` shards (h2o at 0.01); returns
    the path of profile 0's, which names the set."""
    import os
    from ecckd_tpu_torch.io.shards import write_shard
    from ecckd_tpu_torch.io.spectrum import Spectrum
    nlay = profiles[0].optical_depth.shape[0]
    paths = [write_shard(
        os.path.join(tmp, f"h2o_{icol:03d}.spbin"),
        Spectrum(sp.pressure_hl, sp.temperature_hl, sp.wavenumber,
                 sp.d_wavenumber, sp.optical_depth, "h2o", 0.01,
                 np.full(nlay, 0.01), len(profiles)), np.float32)
        for icol, sp in enumerate(profiles)]
    return paths[0]


def run_steps(pipe, keep=None, device="cuda"):
    """Run a pipeline (only the steps named in ``keep``, if given);
    returns the steps that ran, each with its seconds."""
    if keep is not None:
        pipe.steps = [s for s in pipe.steps if s.name in keep]
    ran = {}
    for step in pipe.steps:
        def timed(run=step.run, name=step.name):
            t0 = time.perf_counter()
            run()
            sync(device)
            ran[name] = time.perf_counter() - t0
        step.run = timed
    pipe.run()
    return ran


class probe_logging:
    """Log every probe of the file tool's searches (``probe_log`` in the
    cost options of ``find_g_points_core``) into ``probes``."""

    def __init__(self, probes):
        from ecckd_tpu_torch.tools import find_g_points as tool
        self.tool, self.probes, self.real = tool, probes, None

    def __enter__(self):
        self.real = real = self.tool.find_g_points_core
        probes = self.probes

        def logged(*args, cost_options=None, **kwargs):
            return real(*args, cost_options=dict(cost_options or {},
                                                 probe_log=probes), **kwargs)
        self.tool.find_g_points_core = logged
        return self

    def __exit__(self, *exc):
        self.tool.find_g_points_core = self.real


def file_ranks(path):
    """(rank1, rank2, g_point) of the h2o g-points in a g-point file."""
    from ecckd_tpu_torch.io import NcFile
    with NcFile(path) as f:
        return tuple(np.asarray(f.read(n)) for n in
                     ("h2o_rank1", "h2o_rank2", "g_point"))


def same_ranks(path, gp):
    r1, r2, g_point = file_ranks(path)
    g = gp.gases[0]
    return (np.array_equal(r1, g.rank1) and np.array_equal(r2, g.rank2)
            and np.array_equal(g_point, gp.g_point))


def lut_against(path, model, say, what):
    """The molar absorption (and Planck) tables of a ckd-definition file,
    stored as float32, against a model of the array cores rounded to
    float32: (bit-identical, max abs diff, max rel diff)."""
    from ecckd_tpu_torch.io import NcFile
    names = [("h2o_molar_absorption_coeff",
              model.single_gas_data[0].molar_abs)]
    if model.planck_function is not None:
        names.append(("planck_function", model.planck_function))
    same, worst_abs, worst_rel = True, 0.0, 0.0
    with NcFile(path) as f:
        for name, want in names:
            got = f.read(name)
            want = np.asarray(want).astype(np.float32)
            check(got.shape == want.shape and got.dtype == np.float32,
                  f"{what}: {name} is float32 of shape {want.shape}")
            same &= bool(np.array_equal(got.view(np.uint32),
                                        want.view(np.uint32)))
            diff = np.abs(got.astype(np.float64) - want)
            worst_abs = max(worst_abs, float(diff.max()))
            worst_rel = max(worst_rel, float(
                (diff / np.maximum(np.abs(want), 1e-300)).max()))
    say(f"{what}: the file's LUT against the array cores' rounded to "
        f"float32: bit-identical {same}, max abs diff {worst_abs:.3e}, max "
        f"rel diff {worst_rel:.3e}")
    return same, worst_abs, worst_rel


def check_resume(pipe_of, gpoints, gp, say, what, device):
    """Every step skips on a second run; with the g-point file deleted only
    find_g_points runs again (the JAX rule), to the same ranks."""
    import os
    ran = run_steps(pipe_of(), device=device)
    check(not ran, f"{what}: a second run skips every step (ran {ran})")
    os.remove(gpoints)
    ran = run_steps(pipe_of(), device=device)
    check(list(ran) == ["find_g_points"],
          f"{what}: with the g-point file deleted only find_g_points runs "
          f"again (ran {list(ran)})")
    check(same_ranks(gpoints, gp), f"{what}: the rerun's ranks identical")
    say(f"{what} resume: a second run skipped every step; with the g-point "
        f"file deleted only find_g_points ran again "
        f"({ran['find_g_points']:.2f} s), to the same ranks")


def phase_workflow(smi, lw, sw, device="cuda"):
    """Phase 12: the whole LW and SW workflow through the port's
    orchestrator (``build_pipeline``), every file in the classic NetCDF
    container, on the card.  ``lw`` and ``sw`` hold phases 5 and 6
    (profiles, g-points, model, launches; SW its ssi; LW phase 8's
    optimised heating-rate error)."""
    import os
    import shutil
    import tempfile
    from ecckd_tpu_torch.config import Config
    from ecckd_tpu_torch.io import NcFile
    from ecckd_tpu_torch.models import CkdModel
    from ecckd_tpu_torch.ops.kernels import _build, reset_launch_counts
    from ecckd_tpu_torch.pipeline.orchestrator import build_pipeline
    say = lambda line: log(f"[workflow] {line}")
    dev = torch.device(device)
    t_phase = time.perf_counter()
    check("h5py" not in sys.modules, "h5py not imported")
    secs, out = {}, {"card": smi}
    root = _build.BUILD_DIR.parent
    root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root, prefix="workflow_") as tmp:
        # ---- LW: the main path's configuration, from shards
        t0 = time.perf_counter()
        nwav = len(lw.profiles[0].wavenumber)
        lw_dir = os.path.join(tmp, "lw")
        os.makedirs(lw_dir)
        shard = write_profile_shards(lw_dir, lw.profiles)
        secs["lw_shards"] = time.perf_counter() - t0
        work = os.path.join(tmp, "lw_work")
        lw_cfg = Config({
            "mode": "lw", "application": "smoke", "band_structure": "fsck",
            "work_dir": work, "gases": "h2o", "tolerance": str(HR_TOL),
            "averaging_method": "transmission", "device": device,
            "netcdf_format": "classic", "h2o.input": shard,
            "h2o.conc_dependence": "linear", "h2o.min_scaling": "0.5",
            "h2o.max_scaling": "2.5", "optimize_passes": "1",
            "pass1.gases": "h2o", "pass1.max_iterations": "60",
            "pass1.prior_error": "4.0",
            "pass1.convergence_criterion": "0.002",
            "evaluation_input": write_scenario(
                os.path.join(tmp, "lw_scenario.nc"), lw.profiles)})
        probes = []
        reset_launch_counts()
        with probe_logging(probes):
            ran = run_steps(build_pipeline(lw_cfg), WORKFLOW_STAGE1, device)
        launches = launch_counts()
        check(list(ran) == list(WORKFLOW_STAGE1),
              f"LW stage 1 ran {list(ran)}")
        out["lw_stage_seconds"] = dict(ran)
        out["lw_launches"] = launches
        say(f"LW stage 1 ({nwav} x {lw.profiles[0].optical_depth.shape[0]},"
            f" {len(lw.profiles)} float32 shards written in "
            f"{secs['lw_shards']:.2f} s): seconds "
            f"{json.dumps({k: round(v, 3) for k, v in ran.items()})}; "
            f"launches {launches} (phase 5: {lw.launches}) ({smi})")
        for name in ("sweep_lw_intervals", "fused_interval_sum",
                     "sweep_sw_intervals"):
            check(launches[name] == lw.launches[name] or dev.type == "cpu",
                  f"LW workflow: {name} launched as often as on the LW "
                  "main path")
        gpoints = os.path.join(work, "lw_gpoints_lw_smoke_fsck.h5")
        raw = os.path.join(work, "lw_raw-ckd-definition_lw_smoke_fsck.nc")
        for path in (gpoints, raw,
                     os.path.join(work, "lw_order_smoke_h2o.h5")):
            with open(path, "rb") as f:
                check(f.read(4) == b"CDF\x02", f"{path} is classic CDF-2")
        check(same_ranks(gpoints, lw.gp), "LW workflow: g-point ranks "
              "identical to the LW main path's")
        same, _, _ = lut_against(raw, lw.model, say, "LW workflow")
        check(same, "LW workflow: the LUT identical to the LW main path's "
              "(rounded to the file's float32)")
        k, i1, i2, _ = max(probes, key=lambda p: (len(p[1]), int(p[2][-1])))
        out["lw_probe_kernels"] = hold_probe_kernels(k, i1, i2, say)
        del probes, k

        # ---- LW stage 2: training file, optimize, run_ckd, evaluate
        t0 = time.perf_counter()
        g_point = file_ranks(gpoints)[2]
        ng = int(g_point.max()) + 1
        lbl = training_fluxes(lw.profiles, g_point, ng, dev)
        training = write_lw_training(os.path.join(tmp, "lw_training.nc"),
                                     lbl)
        secs["lw_training"] = time.perf_counter() - t0
        lw_cfg.set("pass1.training_input", training)
        lw_cfg.set("lbl_evaluation_fluxes", training)
        ran = run_steps(build_pipeline(lw_cfg), device=device)
        check(list(ran) == ["optimize_pass1", "run_ckd_0", "evaluate_0"],
              f"LW stage 2 ran {list(ran)}")
        out["lw_stage_seconds"].update(ran)
        final = os.path.join(work, "lw_ckd-definition_lw_smoke_fsck.nc")
        with NcFile(final) as f:
            history = f.attribute("history")
            check(all(s in history for s in ("find_g_points", "create_lut",
                                             "optimize_lut"))
                  and not f.exist("h2o_molar_absorption_coeff_min"),
                  "LW workflow: the final model's provenance, min/max "
                  "removed")
        with open(os.path.join(work, "lw_stats_lw_smoke_fsck_0.json")) as f:
            stats = json.load(f)["models"][0]
        out["lw_stats"] = stats
        check(all(np.isfinite(v) for k, v in stats.items()
                  if isinstance(v, float)), "LW stats finite")
        before = flux_errors(CkdModel.read(raw), lbl, device)
        after = flux_errors(CkdModel.read(final), lbl, device)
        out["lw_hr_rms"] = [before[0], after[0]]
        check(after[0] < before[0], "LW workflow: the optimised model's "
              "heating-rate error below the raw model's")
        say(f"LW stage 2 (training file in {secs['lw_training']:.2f} s): "
            f"seconds {json.dumps({k: round(v, 3) for k, v in ran.items()})}"
            f"; heating-rate RMS error (phase 8's measure) {before[0]:.6e} "
            f"-> {after[0]:.6e} K/day (phase 8: {lw.hr_error:.6e}); "
            f"evaluate_ckd {json.dumps(stats)} ({smi})")
        if not 0.5 <= after[0] / lw.hr_error <= 2.0:
            say(f"NOTE: the workflow's optimised heating-rate error is "
                f"{after[0] / lw.hr_error:.3f}x phase 8's")

        # ---- SW: phase 6's configuration, from shards
        t0 = time.perf_counter()
        sw_dir = os.path.join(tmp, "sw")
        os.makedirs(sw_dir)
        shard = write_profile_shards(sw_dir, sw.profiles)
        ssi_file = write_ssi(os.path.join(tmp, "ssi.nc"),
                             sw.profiles[0].wavenumber, sw.ssi)
        secs["sw_shards"] = time.perf_counter() - t0
        work = os.path.join(tmp, "sw_work")
        code = "sw_smoke_two-band"
        sw_cfg = Config({
            "mode": "sw", "application": "smoke",
            "band_structure": "two-band", "work_dir": work, "gases": "h2o",
            "tolerance": str(HR_TOL_SW), "ssi": ssi_file,
            "wavenumber1": " ".join(str(v) for v in SW_BANDS[0]),
            "wavenumber2": " ".join(str(v) for v in SW_BANDS[1]),
            "threshold_optical_depth": "0.25", "band_parallel": "off",
            "averaging_method": "total-transmission", "device": device,
            "netcdf_format": "classic", "h2o.input": shard,
            "h2o.conc_dependence": "linear", "h2o.min_scaling": "0.5",
            "h2o.max_scaling": "2.5", "optimize_passes": "1",
            "pass1.gases": "h2o", "pass1.max_iterations": "60",
            "pass1.prior_error": "4.0",
            "pass1.convergence_criterion": "0.002",
            "evaluation_input": write_scenario(
                os.path.join(tmp, "sw_scenario.nc"), sw.profiles)})
        reset_launch_counts()
        # the search's averaging is total-transmission, the LUT's
        # transmission, as phase 6 has them
        ran = run_steps(build_pipeline(sw_cfg), WORKFLOW_STAGE1[:2], device)
        sw_cfg.set("averaging_method", "transmission")
        ran.update(run_steps(build_pipeline(sw_cfg), WORKFLOW_STAGE1[2:],
                             device))
        launches = launch_counts()
        check(list(ran) == list(WORKFLOW_STAGE1),
              f"SW stage 1 ran {list(ran)}")
        out["sw_stage_seconds"] = dict(ran)
        out["sw_launches"] = launches
        say(f"SW stage 1 ({len(sw.profiles)} float32 shards and the ssi "
            f"file written in {secs['sw_shards']:.2f} s): seconds "
            f"{json.dumps({k: round(v, 3) for k, v in ran.items()})}; "
            f"launches {launches} (phase 6: {sw.launches}) ({smi})")
        for name in ("sweep_sw_intervals", "sweep_sw_with_upwelling",
                     "fused_interval_sum", "sweep_lw_intervals"):
            check(launches[name] == sw.launches[name] or dev.type == "cpu",
                  f"SW workflow: {name} launched as often as on the SW "
                  "main path")
        sw_gpoints = os.path.join(work, f"sw_gpoints_{code}.h5")
        check(same_ranks(sw_gpoints, sw.gp), "SW workflow: g-point ranks "
              "identical to the SW main path's")
        raw = os.path.join(work, f"sw_raw-ckd-definition_{code}.nc")
        out["sw_lut_against_phase6"] = lut_against(raw, sw.model, say,
                                                   "SW workflow")

        # ---- SW stage 2: training file, scale_lut, optimize, run_ckd
        t0 = time.perf_counter()
        g_point = file_ranks(sw_gpoints)[2]
        training = write_sw_training(os.path.join(tmp, "sw_training.nc"),
                                     sw.profiles, sw.ssi, g_point,
                                     int(g_point.max()) + 1, dev)
        scale_lbl = write_scale_lbl(os.path.join(tmp, "sw_scale_lbl.nc"),
                                    sw.profiles[0], sw.ssi, dev)
        secs["sw_training"] = time.perf_counter() - t0
        sw_cfg.set("scale_lblfile", scale_lbl)
        sw_cfg.set("pass1.training_input", training)
        ran = run_steps(build_pipeline(sw_cfg), device=device)
        check(list(ran) == ["scale_lut", "optimize_pass1", "run_ckd_0"],
              f"SW stage 2 ran {list(ran)}")
        out["sw_stage_seconds"].update(ran)
        with NcFile(os.path.join(work, f"sw_fluxes_{code}_0.nc")) as f:
            fd = f.read("flux_dn_direct_sw")
            sfd = f.read("spectral_flux_dn_direct_sw")
        ncol, nhl = len(sw.profiles), sw.profiles[0].optical_depth.shape[0] + 1
        check(fd.shape == (ncol, nhl) and sfd.shape[:2] == (ncol, nhl)
              and np.all(np.isfinite(sfd)) and np.all(sfd >= 0),
              "SW run_ckd fluxes finite, non-negative, of the scenario's "
              "shape")
        check(np.allclose(fd[:, 0], 1361.0 * 0.5, rtol=1e-6)
              and np.all(np.diff(fd, axis=1) <= 0),
              "SW direct flux: 1361 W m-2 x cos 60 deg at the top, falling "
              "to the surface")
        out["sw_surface_direct"] = fd[:, -1].tolist()
        say(f"SW stage 2 (training file of 5 zenith angles and scale_lut's "
            f"full-resolution direct flux of profile 0 in "
            f"{secs['sw_training']:.2f} s): seconds "
            f"{json.dumps({k: round(v, 3) for k, v in ran.items()})}; "
            f"run_ckd's direct flux at the surface {fd[:, -1].tolist()} "
            f"W m-2 ({smi})")

        # ---- resume
        t0 = time.perf_counter()
        check_resume(lambda: build_pipeline(lw_cfg), gpoints, lw.gp, say,
                     "LW", device)
        sw_cfg.set("averaging_method", "total-transmission")
        check_resume(lambda: build_pipeline(sw_cfg), sw_gpoints, sw.gp, say,
                     "SW", device)
        secs["resume"] = time.perf_counter() - t0
    check("h5py" not in sys.modules, "h5py not imported")
    out["seconds"] = secs
    out["phase_seconds"] = time.perf_counter() - t_phase
    say(json.dumps(out, default=float))
    say(f"phase {out['phase_seconds']:.1f} s ({smi})")
    return out


# ------------------------------------------------------------- phase 13

PARALLEL_SHARDS = 4
PARALLEL_BLOCK = 1 << 18


def shard_probe_kernels(k, i1, i2, say, what):
    """Each shard's K3 and sweep (K1, or K2 with the LOW scaling of a
    total-transmission probe) on one probe of a sharded search, launched on
    the probe's own inputs as ``costs()`` launches them (bounds padded to
    the bucket and shifted into the shard's slice, the partition map of its
    global ranks, the od fitted from the reduced sums), each held against
    its plain version on the same inputs at phase 3's bar; returns the
    worst errors."""
    from ecckd_tpu_torch.ops.kernels import (fused_interval_sum,
                                             sweep_lw_intervals,
                                             sweep_lw_plain,
                                             sweep_sw_intervals,
                                             sweep_sw_plain)
    from ecckd_tpu_torch.ops.segments import interval_sum_fused
    from ecckd_tpu_torch.partition import CandidateCostLw
    from ecckd_tpu_torch.partition.cost_kernel import _pad_to_bucket, _Probe
    pad = _pad_to_bucket(len(i1)) - len(i1)
    probe = _Probe(k, np.r_[np.zeros(pad, np.int32), i1],
                   np.r_[np.zeros(pad, np.int32), i2])
    lw = isinstance(k, CandidateCostLw)
    rows = k._probe_rows
    plain = [interval_sum_fused(sh._probe_parts, sh.npoints, b[2], b[3],
                                dtype=k.dtype)[:rows]
             for sh, b in zip(k._shards, probe.shards)]
    sums = k.mesh.sum(plain, device=k.device)
    od_fit = k._fit_finish(sums[:k._fit_rows], probe.i1, probe.i2)
    if not lw and k.averaging_method == "total-transmission":
        od_fit = od_fit * k.min_scaling
    worst = dict(K3=(0.0, 0.0), sweep=(0.0, 0.0))
    for j, (sh, b) in enumerate(zip(k._shards, probe.shards)):
        got = fused_interval_sum(sh._probe_parts, sh.npoints, b[2], b[3],
                                 dtype=k.dtype)[:rows]
        errs = {"K3": [row_err(got, plain[j])]}
        od = od_fit.to(sh.device).contiguous()
        seg = probe.seg_of_wav(sh, j)
        if lw:
            args = (sh.planck_hl, sh.bg_od, od, seg, sh.surf_emissivity,
                    sh.surf_planck, b[2], b[3])
            pair = (sweep_lw_intervals(*args), sweep_lw_plain(*args))
        else:
            args = (sh.ssi, sh.bg_od, od, seg, b[2], b[3], k.cos_sza,
                    sh.surf_albedo, k.with_upwelling)
            pair = (sweep_sw_intervals(*args), sweep_sw_plain(*args))
        errs["sweep"] = [row_err(g, w) for g, w in zip(*pair)]
        sync(k.device)
        for name, e in errs.items():
            worst[name] = (max(worst[name][0], max(x[0] for x in e)),
                           max(worst[name][1], max(x[1] for x in e)))
    sweep = "K1" if lw else "K2"
    say(f"{what}: each of {len(k._shards)} shards' K3 and {sweep} on the "
        f"search's largest probe ({len(i1)} intervals; bounds shifted into "
        f"slices of {k._shards[0].npoints} ranks) against their plain "
        f"versions: K3 {worst['K3'][0]:.3e}, {sweep} {worst['sweep'][0]:.3e} "
        f"(normwise per row, bar {BARS[k.dtype]:.0e}); max abs "
        f"{worst['K3'][1]:.3e} / {worst['sweep'][1]:.3e}")
    for name in worst:
        check(worst[name][0] <= BARS[k.dtype], f"{what}: each shard's "
              f"{name} within {BARS[k.dtype]} of its plain version")
    return {"K3": worst["K3"][0], sweep: worst["sweep"][0]}


def probe_costs_against_one_device(k, i1, i2, say, what):
    """The costs of one probe of a sharded kernel against the same
    kernel's arrays on one device: as searched, and with float32's
    transmission clamp as ``fit_limits`` on both sides, where an opaque
    interval's fit is well conditioned (-log1p(-mean) turns the sums' last
    bits into the cost's leading digits at the float64 clamp, ROADMAP §3;
    the sharded sums add in another order).  The clamped costs are held to
    1e-10."""
    one = cost_twin(k, k.dtype, False)
    raw = normwise([k.costs(i1, i2)], [one.costs(i1, i2)])
    limited = normwise(
        [cost_twin(k, k.dtype, False, torch.float32,
                   mesh=k.mesh).costs(i1, i2)],
        [cost_twin(k, k.dtype, False, torch.float32).costs(i1, i2)])
    del one
    say(f"{what}: the largest probe's costs sharded against one device "
        f"{raw:.3e} (normwise, as searched), {limited:.3e} with float32's "
        "transmission clamp on both sides (bar 1e-10)")
    check(limited <= 1e-10, f"{what}: sharded probe costs within 1e-10 of "
          "one device")
    return dict(costs=raw, clamped_costs=limited)


def sharded_search(what, gas, hr_tol, mesh, base, say, ssi=None,
                   out=None):
    """One find_g_points_core over ``mesh`` (band_parallel off) against
    the unsharded run of this phase (``fgp_run``'s result): K1 or K2
    launched once a shard and sweep, and with as many probes K1/K2 and K3
    four times as often as unsharded; each shard's kernels and the costs
    on the largest probe."""
    _, base_secs, base_calls, base_launches, _ = base
    gp, secs, calls, launches, probes = fgp_run(
        gas, hr_tol, ssi=ssi, keep_log=True, band_parallel="off", mesh=mesh,
        device=mesh.devices[0])
    # a probe sweeps once (LW) or twice (SW total-transmission's LOW and
    # HIGH runs) on every shard
    sweep, runs = (("sweep_lw_intervals", 1) if ssi is None
                   else ("sweep_sw_intervals", 2))
    card = mesh.devices[0].type == "cuda"     # the plain versions count none
    check(launches[sweep] == PARALLEL_SHARDS * runs * calls or not card,
          f"{what}: {sweep} launched {PARALLEL_SHARDS * runs}x per probe")
    say(f"{what}: {calls} probes sharded, {base_calls} unsharded")
    if calls == base_calls:
        for name in (sweep, "sweep_sw_with_upwelling",
                     "fused_interval_sum"):
            check(launches[name] == PARALLEL_SHARDS * base_launches[name]
                  and (launches[name] > 0 or name != sweep or not card),
                  f"{what}: {name} launched {PARALLEL_SHARDS}x as often as "
                  f"unsharded ({launches[name]} against "
                  f"{base_launches[name]})")
    k, i1, i2, _ = max(probes, key=lambda p: len(p[1]))
    held = shard_probe_kernels(k, i1, i2, say, what)
    held.update(probe_costs_against_one_device(k, i1, i2, say, what))
    say(f"{what}: {calls} probes, {secs:.3f} s over {PARALLEL_SHARDS} "
        f"logical shards of one card against {base_secs:.3f} s unsharded "
        f"(host clock); launches {json.dumps(launches)}")
    if out is not None:
        out.update(seconds=secs, seconds_unsharded=base_secs, probes=calls,
                   launches=launches, held=held)
    return gp, probes


def rank_moves(what, gas, hr_tol, mesh, gp, ref, probes, say, device,
               ssi=None):
    """A sharded search's ranks (``gp``, its probe log ``probes``) against
    the unsharded run's (``ref``).  The sharded sums add in another order,
    and a transmission fit at the float64 clamp turns their last bits into
    a cost's leading digits (ROADMAP §3), which can move a bound.  So where
    the ranks differ: the same g-point count and every bound within 2
    ranks, each partition's interval costs on one device printed, and the
    two searches again with float32's clamp as the fit's limit on both
    sides, whose ranks must be identical."""
    (a1, a2), (b1, b2) = ranks_of(gp), ranks_of(ref)
    if (np.array_equal(a1, b1) and np.array_equal(a2, b2)
            and np.array_equal(gp.g_point, ref.g_point)):
        say(f"{what}: g-point ranks identical to the unsharded search")
        return dict(identical=True)
    same_n = len(a1) == len(b1)
    shift = (int(max(np.abs(a1 - b1).max(), np.abs(a2 - b2).max()))
             if same_n else None)
    say(f"{what}: ranks differ from the unsharded search: rank1 "
        f"{a1.tolist()} against {b1.tolist()}, rank2 {a2.tolist()} against "
        f"{b2.tolist()}; largest shift {shift}")
    check(same_n and shift <= 2, f"{what}: the same g-point count, bounds "
          "within 2 ranks of the unsharded search")
    kernels = {id(p[0]): p[0] for p in probes}
    if len(kernels) == 1:
        one = cost_twin(probes[0][0], torch.float64, False)
        ca, cb = one.costs(a1, a2), one.costs(b1, b2)
        say(f"{what}: interval costs on one device, sharded partition "
            f"{ca.tolist()}, unsharded {cb.tolist()}; largest "
            f"{ca.max():.12g} against {cb.max():.12g}")
        del one
    opts = dict(band_parallel="off", device=device,
                cost_options={"fit_limits": torch.float32})
    lim = [fgp_run(gas, hr_tol, ssi=ssi, **opts)[0],
           fgp_run(gas, hr_tol, ssi=ssi, mesh=mesh, **opts)[0]]
    (c1, c2), (d1, d2) = ranks_of(lim[0]), ranks_of(lim[1])
    same32 = np.array_equal(c1, d1) and np.array_equal(c2, d2)
    say(f"{what}: with float32's clamp as the fit's limit, sharded and "
        f"unsharded ranks identical {same32} (rank1 {d1.tolist()})")
    check(same32, f"{what}: identical ranks with float32's clamp on both "
          "sides")
    return dict(identical=False, largest_shift=shift, identical_f32_clamp=True)


def ranks_of(gp):
    g = gp.gases[0]
    return np.asarray(g.rank1), np.asarray(g.rank2)


def check_same_ranks(a, b, what):
    """Identical g-point ranks, or a failure that shows the two
    partitions."""
    (a1, a2), (b1, b2) = ranks_of(a), ranks_of(b)
    same = (np.array_equal(a1, b1) and np.array_equal(a2, b2)
            and np.array_equal(a.g_point, b.g_point))
    if not same:
        log(f"[parallel] {what}: ranks differ: rank1 {a1.tolist()} against "
            f"{b1.tolist()}, rank2 {a2.tolist()} against {b2.tolist()}")
    check(same, f"{what}: identical g-point ranks")


def well_conditioned(model, profiles):
    """Per LUT entry of a transmission-averaged model, whether its fit is
    well conditioned (kappa = m / ((1 - m) (-log1p(-m))) <= 100 for the
    mean transmission m of its od, as phase 11 holds it)."""
    from ecckd_tpu_torch.constants import LW_DIFFUSIVITY
    from ecckd_tpu_torch.ops.average import od_to_molar_abs
    k = model.single_gas_data[0].molar_abs
    out = np.zeros(k.shape, bool)
    for icol, sp in enumerate(profiles):
        per_od = od_to_molar_abs(np.ones(k.shape[1:]), sp.pressure_hl, 0.01)
        m = -np.expm1(-LW_DIFFUSIVITY * k[icol] / per_od)
        with np.errstate(divide="ignore", invalid="ignore"):
            kappa = m / ((1.0 - m) * -np.log1p(-m))
        out[icol] = (kappa <= 100.0) | (m == 0.0)
    return out


def sharded_luts(lw, mesh, say, device):
    """create_lut_core over ``mesh``, dense and streamed in blocks of
    2^18, against one device (this phase's dense run and phase 5's LUT):
    min and max bit-identical, molar absorption within 1e-10 normwise
    where the fit is well conditioned, seconds of each."""
    from ecckd_tpu_torch.models import ConcDependence
    from ecckd_tpu_torch.tools.create_lut import LutGas, create_lut_core
    gas = LutGas("h2o", ConcDependence.LINEAR,
                 [lambda icol: (lw.profiles[icol], 0.01)])
    gp = lw.gp
    run = lambda **kw: create_lut_core(
        gp.g_point, gp.wavenumber1_band, gp.wavenumber2_band,
        gp.band_number, [gas], averaging_method="transmission",
        device=device, streaming_block_wav=PARALLEL_BLOCK, **kw)
    secs, models = {}, {}
    for tag, kw in (("one device dense", dict(streaming="0")),
                    ("sharded dense", dict(streaming="0", mesh=mesh)),
                    ("sharded streamed", dict(streaming="1", mesh=mesh))):
        sync(device)
        t0 = time.perf_counter()
        models[tag] = run(**kw)
        sync(device)
        secs[tag] = time.perf_counter() - t0
    want = lw.model.single_gas_data[0]
    well = well_conditioned(lw.model, lw.profiles)
    out = dict(seconds=secs)
    for tag in ("sharded dense", "sharded streamed"):
        g = models[tag].single_gas_data[0]
        same = (np.array_equal(g.min_molar_abs, want.min_molar_abs)
                and np.array_equal(g.max_molar_abs, want.max_molar_abs))
        err = normwise([g.molar_abs[well]], [want.molar_abs[well]])
        rest = ~well
        worst = (float(np.max(np.abs(g.molar_abs[rest]
                                     / want.molar_abs[rest] - 1.0)))
                 if rest.any() else 0.0)
        say(f"create_lut {tag} over {PARALLEL_SHARDS} shards: min and max "
            f"bit-identical to phase 5's LUT {same}; molar absorption "
            f"{err:.3e} normwise over {int(well.sum())} well-conditioned "
            f"entries (bar 1e-10), {int(rest.sum())} towards the clamp "
            f"worst {worst:.3e} relative")
        check(same, f"create_lut {tag}: min and max bit-identical")
        check(err <= 1e-10, f"create_lut {tag}: molar absorption within "
              "1e-10 where well conditioned")
        out[tag] = dict(min_max_identical=same, err=err, near=worst)
    say(f"create_lut seconds (host clock): "
        f"{json.dumps({k: round(v, 3) for k, v in secs.items()})}")
    return out


def device_problem(lw, opt, device):
    """Phase 8's LW model and training fluxes as optimize_lut's device
    solver sees them: the TrainingCost, the start, the bounds and the
    pinned entries, on ``device``."""
    import copy
    from ecckd_tpu_torch.ops.cost import CostWeights
    from ecckd_tpu_torch.optimize.cost_fn import MIN_X
    from ecckd_tpu_torch.optimize.solver import (TrainingCost,
                                                 log_state_tree, ravel_tree,
                                                 state_bounds)
    from ecckd_tpu_torch.tools.optimize_lut import prepare_lbl
    model = copy.deepcopy(lw.model)
    lbl = copy.deepcopy(opt.lbl)
    model.set_active(["h2o"])
    model.create_error_covariances(4.0)
    prepare_lbl(lbl, model, 1.0e4)
    cost = TrainingCost(model, [lbl], CostWeights(), device=device)
    x0 = ravel_tree(log_state_tree(model))
    lo, hi = (cost.tensor(ravel_tree(t)) for t in state_bounds(model))
    return (cost, cost.tensor(x0), lo, hi,
            torch.as_tensor(x0 <= MIN_X, device=device))


def machine_graph_against_eager(lw, opt, say, device):
    """The device solver's state machine with its step as one CUDA graph
    against the same machine run eagerly on the card (phase 8's problem,
    12 iterations in chunks of 6): chunk boundaries, each iteration's
    value and the parameters bit for bit; ms an iteration of each."""
    from ecckd_tpu_torch.optimize import lbfgs
    cost, x0, lo, hi, sentinel = device_problem(lw, opt, device)
    runs = {}
    for tag, graph in (("graphed", "step"), ("eager", None)):
        chunks, history, stats = [], [], lbfgs.Stats()
        sync(device)
        t0 = time.perf_counter()
        params, value, it, gnorm = lbfgs.minimize(
            cost.value_and_grad_eager, x0, lo, hi, sentinel, 12, 0.002,
            chunk=6, on_chunk=lambda p, it, v: chunks.append((it, v)),
            history=history, stats=stats,
            graph=graph if device.type == "cuda" else None)
        sync(device)
        runs[tag] = dict(seconds=time.perf_counter() - t0, chunks=chunks,
                         history=history, params=params.clone(),
                         end=(value, it, gnorm), stats=stats)
    g, e = runs["graphed"], runs["eager"]
    same = (g["chunks"] == e["chunks"] and g["history"] == e["history"]
            and torch.equal(g["params"], e["params"])
            and g["end"] == e["end"])
    n = max(g["end"][1], 1)
    say(f"device solver, step graphed against the eager state machine: "
        f"{g['end'][1]} iterations, chunk boundaries "
        f"{[c[0] for c in g['chunks']]} / {[c[0] for c in e['chunks']]}, "
        f"values, parameters and boundaries bit-identical {same}; "
        f"{1e3 * g['seconds'] / n:.2f} against "
        f"{1e3 * e['seconds'] / n:.2f} ms an iteration (host clock); "
        f"graphed {g['stats']}")
    check(same, "graphed device solver: the eager state machine's iterates "
          "bit for bit")
    return dict(identical=same, boundaries=[c[0] for c in g["chunks"]],
                graphed_ms_per_iteration=1e3 * g["seconds"] / n,
                eager_ms_per_iteration=1e3 * e["seconds"] / n)


def device_solver_run(lw, opt, say, device):
    """optimize_lut_core with solver=device on phase 8's LW model and
    training fluxes: at most 60 iterations, prior error 4, its step one
    CUDA graph on the card."""
    import copy
    from ecckd_tpu_torch.optimize.lbfgs import STEPS_PER_READ
    from ecckd_tpu_torch.tools.optimize_lut import optimize_lut_core
    model = copy.deepcopy(lw.model)
    lbl = copy.deepcopy(opt.lbl)
    res = optimize_lut_core(model, [lbl], gases=["h2o"], prior_error=4.0,
                            max_iterations=60, convergence_criterion=0.002,
                            solver="device", device=device)
    before = flux_errors(lw.model, lbl, device)
    after = flux_errors(model, lbl, device)
    scipy_res = opt.res
    g0, g1 = lw.model.single_gas_data[0], model.single_gas_data[0]
    pos = g0.molar_abs > 0
    bounded = (np.all(g1.molar_abs[pos] <= g0.max_molar_abs[pos]
                      * (1 + 1e-9))
               and np.all(g1.molar_abs[pos] >= g0.min_molar_abs[pos]
                          * np.where(g0.min_molar_abs[pos] > 0,
                                     1 - 1e-9, 0.0))
               and np.all(g1.molar_abs[~pos] == 0.0))
    n = max(res.n_iterations, 1)
    per_it = res.n_evaluations / n
    say(f"device solver: {res.status.name}, {res.n_iterations} iterations, "
        f"{res.n_evaluations} evaluations ({per_it:.2f} an iteration) and "
        f"{res.masked_evaluations} masked, {res.host_reads} host reads "
        f"({res.host_reads / n:.4f} an iteration against "
        f"{per_it / STEPS_PER_READ:.4f}, evaluations an iteration over "
        f"{STEPS_PER_READ} steps a read); cost {res.first_cost:.6g} -> "
        f"{res.cost:.6g} (scipy in phase 8: {scipy_res.cost:.6g} after "
        f"{scipy_res.n_iterations} iterations); heating-rate RMS error "
        f"{before[0]:.6e} -> {after[0]:.6e} K/day, surface downwelling "
        f"{before[1]:.9e} -> {after[1]:.9e} W m-2; bounds held and zeros "
        f"kept {bounded}")
    steady = (res.wall_time - res.capture_seconds) / n
    say(f"device solver {1e3 * res.seconds_per_iteration:.2f} ms an "
        f"iteration, {1e3 * steady:.2f} without the step's capture "
        f"({res.capture_seconds:.3f} s), against scipy's "
        f"{1e3 * scipy_res.seconds_per_iteration:.2f} ms in phase 8 (host "
        "clock)")
    check(res.cost <= scipy_res.cost * 1.05
          and scipy_res.cost <= res.cost * 1.05,
          "device solver's final cost within 5% of scipy's")
    check(after[0] < before[0] and after[1] < before[1],
          "device solver lowers the heating-rate and surface errors")
    check(bounded, "device solver: bounds hold and zeros stay zero")
    # 60 iterations are one chunk: one read after every STEPS_PER_READ
    # steps until the state froze, so its evaluations over that, rounded up
    check(res.host_reads <= -(-res.n_evaluations // STEPS_PER_READ),
          "device solver: one host read every STEPS_PER_READ evaluations")
    return dict(status=res.status.name, iterations=res.n_iterations,
                evaluations=res.n_evaluations,
                masked_evaluations=res.masked_evaluations,
                host_reads=res.host_reads,
                cost=res.cost, scipy_cost=scipy_res.cost,
                ms_per_iteration=1e3 * res.seconds_per_iteration,
                ms_per_iteration_after_capture=1e3 * steady,
                capture_seconds=res.capture_seconds,
                scipy_ms_per_iteration=1e3 * scipy_res.seconds_per_iteration,
                hr_error=after[0],
                graph=machine_graph_against_eager(lw, opt, say, device))


def data_parallel_run(lw, opt, mesh, say, device):
    """data_parallel over ``mesh`` with phase 8's LW model and its 5
    profiles (padded to 8 over 4 shards): value and gradient against one
    shard and in a repeat, then 15 scipy iterations against one shard."""
    import copy
    from ecckd_tpu_torch.ops.cost import CostWeights
    from ecckd_tpu_torch.optimize.solver import (TrainingCost,
                                                 log_state_tree, ravel_tree)
    from ecckd_tpu_torch.tools.optimize_lut import (optimize_lut_core,
                                                    prepare_lbl)
    model = copy.deepcopy(lw.model)
    lbl = copy.deepcopy(opt.lbl)
    model.set_active(["h2o"])
    model.create_error_covariances(4.0)
    prepare_lbl(lbl, model, 1.0e4)
    x = ravel_tree(log_state_tree(model))
    one = TrainingCost(model, [lbl], CostWeights(), device=device)
    shd = TrainingCost(model, [lbl], CostWeights(), device=device,
                       mesh=mesh)
    graphs = (graph_against_eager(f"data_parallel over {mesh.size} "
                                  "shards", shd, shd.tensor(x), reps=10)
              if device.type == "cuda" else None)
    (v1, g1), (v, g), (v2, g2) = one(x), shd(x), shd(x)
    rel_v = abs(v / v1 - 1.0)
    rel_g = float(np.linalg.norm(g - g1) / np.linalg.norm(g1))
    same = v2 == v and np.array_equal(g2, g)
    ms = {tag: cuda_ms(lambda c=c: c.value_and_grad(c.tensor(x)), 10)
          if device.type == "cuda" else float("nan")
          for tag, c in (("one", one), ("sharded", shd))}
    say(f"data_parallel: {lbl.ncol} profiles over {mesh.size} shards; "
        f"value {rel_v:.3e}, gradient {rel_g:.3e} (normwise) against one "
        f"shard (bar 1e-10); repeat bit-identical {same}; graphed "
        f"{ms['sharded']:.3f} ms per value and gradient against "
        f"{ms['one']:.3f} ms, {ms['sharded'] / ms['one']:.2f}x (CUDA "
        "events)")
    check(rel_v <= 1e-10 and rel_g <= 1e-10, "data_parallel value and "
          "gradient within 1e-10 of one shard")
    check(same, "data_parallel: bit-identical repeat")
    runs = {}
    for tag, kw in (("one", dict(data_parallel=False)),
                    ("sharded", dict(data_parallel=True, mesh=mesh))):
        m = copy.deepcopy(lw.model)
        res = optimize_lut_core(m, [copy.deepcopy(opt.lbl)], gases=["h2o"],
                                prior_error=4.0, max_iterations=15,
                                convergence_criterion=1e-12, device=device,
                                **kw)
        runs[tag] = (res, m.single_gas_data[0].molar_abs)
    (r1, k1), (r, k) = runs["one"], runs["sharded"]
    rel_cost = abs(r.cost / r1.cost - 1.0)
    rel_lut = float(np.max(np.abs(k[k1 > 0] / k1[k1 > 0] - 1.0)))
    say(f"data_parallel: 15 scipy iterations, cost {r.cost:.9g} against "
        f"{r1.cost:.9g} ({rel_cost:.3e}, bar 1e-8), LUT worst {rel_lut:.3e} "
        f"(bar 1e-6); {1e3 * r.seconds_per_iteration:.2f} ms an iteration "
        f"against {1e3 * r1.seconds_per_iteration:.2f} (host clock)")
    check(rel_cost <= 1e-8 and rel_lut <= 1e-6, "data_parallel: 15 "
          "iterations within 1e-8 (cost) and 1e-6 (LUT) of one shard")
    return dict(value=rel_v, gradient=rel_g, ms=ms, cost=rel_cost,
                lut=rel_lut, graphs=graphs)


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def planck_weights(sp, device):
    """The Planck weights of create_lut for profile ``sp``, on ``device``."""
    from ecckd_tpu_torch.ops.planck import planck_function
    from ecckd_tpu_torch.tools.common import device_tensor
    p = np.asarray(sp.pressure_hl)
    t_x_p = np.asarray(sp.temperature_hl) * p
    p_fl = 0.5 * (p[:-1] + p[1:])
    t_fl = 0.5 * (t_x_p[:-1] + t_x_p[1:]) / p_fl
    return planck_function(*(device_tensor(a, device, torch.float64)
                             for a in (t_fl, sp.wavenumber,
                                       sp.d_wavenumber)))


def write_parallel_inputs(work, sp, order, g_point):
    """Profile 0 of the LW main path, its order and the sharded search's
    g-point map as .npy files for the workers."""
    import os
    for name, a in (("optical_depth", sp.optical_depth),
                    ("pressure_hl", sp.pressure_hl),
                    ("temperature_hl", sp.temperature_hl),
                    ("wavenumber", sp.wavenumber),
                    ("d_wavenumber", sp.d_wavenumber),
                    ("g_point", g_point)):
        np.save(os.path.join(work, f"{name}.npy"), np.asarray(a))
    np.savez(os.path.join(work, "order.npz"),
             **{k: np.asarray(v) for k, v in order.items()})


def read_parallel_inputs(work):
    import os
    load = lambda name: np.load(os.path.join(work, f"{name}.npy"),
                                mmap_mode="r")
    sp = SimpleNamespace(**{n: np.asarray(load(n)) for n in (
        "pressure_hl", "temperature_hl", "wavenumber", "d_wavenumber")})
    sp.optical_depth = load("optical_depth")
    sp.ncol = 1
    with np.load(os.path.join(work, "order.npz")) as f:
        order = {k: f[k] for k in f.files}
        for k, v in order.items():
            if v.ndim == 0:
                order[k] = v.item()
    return sp, order, np.asarray(load("g_point"))


def parallel_worker(work, device="cuda:0"):
    """One of the two processes of phase 13's multi-controller run (run as
    ``chip_smoke.py --parallel-worker DIR DEVICE`` with torchrun's
    variables): 2 logical shards on ``device`` each, so the process-major
    mesh has 4.  Runs
    the LW main path's search and the streamed multi-controller averaging
    of its profile 0 (each process its half of the wavenumbers), and
    process 0 writes the ranks, every probe's costs (as searched and with
    float32's clamp) and the averaging's partials to ``DIR``."""
    import os
    import torch.distributed as dist
    from ecckd_tpu_torch.parallel import distributed, make_mesh
    from ecckd_tpu_torch.parallel.sharded_average import (
        streaming_sharded_average_od_to_gpoints_multihost)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    check(distributed.initialize_from_env(backend="gloo", timeout_s=600),
          "initialize_from_env over gloo")
    rank = dist.get_rank()
    mesh = make_mesh(devices=[dev] * (PARALLEL_SHARDS // 2),
                     data_parallel=1)
    check(mesh.size == PARALLEL_SHARDS and mesh.process_count == 2,
          "a process-major mesh of 4 shards over 2 processes")
    sp, order, g_point = read_parallel_inputs(work)
    t0 = time.perf_counter()
    probes = []
    gp = search(gas_input(order, sp), dev, HR_TOL, band_parallel="off",
                mesh=mesh, cost_options=dict(probe_log=probes))
    sync(dev)
    secs = time.perf_counter() - t0
    twins = {id(k): cost_twin(k, k.dtype, False, torch.float32, mesh=mesh)
             for k, _, _, _ in probes}
    limited = [twins[id(k)].costs(i1, i2) for k, i1, i2, _ in probes]
    del twins
    nwav = len(sp.wavenumber)
    half = nwav // 2
    lo = rank * half
    w = planck_weights(sp, dev)
    ng = int(g_point.max()) + 1
    t0 = time.perf_counter()
    acc = streaming_sharded_average_od_to_gpoints_multihost(
        mesh, ng, g_point[lo:lo + half],
        lambda i0, nb: sp.optical_depth[:, lo + i0:lo + i0 + nb], half,
        lambda i0, nb: w[:, lo + i0:lo + i0 + nb], "transmission",
        block_wav=PARALLEL_BLOCK, finalize=False)
    avg_secs = time.perf_counter() - t0
    if rank == 0:
        r1, r2 = ranks_of(gp)
        np.savez(os.path.join(work, "worker.npz"), rank1=r1, rank2=r2,
                 g_point=gp.g_point,
                 costs=np.concatenate([p[3] for p in probes]),
                 limited=np.concatenate(limited),
                 i1=np.concatenate([p[1] for p in probes]),
                 i2=np.concatenate([p[2] for p in probes]),
                 sizes=np.asarray([len(p[1]) for p in probes]),
                 seconds=secs, avg_seconds=avg_secs,
                 **{f"acc_{k}": v for k, v in acc.items()})
    dist.barrier()
    dist.destroy_process_group()
    log(f"[parallel worker {rank}] search {secs:.3f} s, averaging "
        f"{avg_secs:.3f} s")


def multi_controller_run(lw, k, ref_gp, say, device):
    """Two processes on ``device`` over gloo (:func:`parallel_worker`) against
    this process's LW sharded search (``ref_gp``, its kernel ``k``, over
    the same 4 shards in one process):
    identical ranks, the probes' costs within 1e-12 (with float32's clamp
    on both sides; as searched reported), the averaging's min and max
    partials bit-identical and its sums within 1e-12."""
    import os
    import subprocess
    import tempfile
    from ecckd_tpu_torch.ops.kernels import _build
    from ecckd_tpu_torch.parallel.sharded_average import (
        streaming_sharded_average_od_to_gpoints)
    sp = lw.profiles[0]
    order = order_of(sp, device)
    root = _build.BUILD_DIR.parent
    root.mkdir(parents=True, exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=root, prefix="parallel_") as work:
        write_parallel_inputs(work, sp, order, ref_gp.g_point)
        port = _free_port()
        procs = []
        t0 = time.perf_counter()
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--parallel-worker", work, str(device)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs_out = []
        try:
            for p in procs:
                logs_out.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        for rank, (p, text) in enumerate(zip(procs, logs_out)):
            tail = "\n".join(text.splitlines()[-15:])
            say(f"worker {rank} exit {p.returncode}; last lines:\n{tail}")
            check(p.returncode == 0, f"multi-controller worker {rank} ran")
        with np.load(os.path.join(work, "worker.npz")) as f:
            got = {k: f[k] for k in f.files}
    r1, r2 = ranks_of(ref_gp)
    same = (np.array_equal(got["rank1"], r1)
            and np.array_equal(got["rank2"], r2)
            and np.array_equal(got["g_point"], ref_gp.g_point))
    check(same, "multi-controller search: ranks identical to the one-process"
          " 4-shard run")
    # every probe of the workers' search on this process's 4-shard mesh
    mesh = k.mesh
    k_lim = cost_twin(k, k.dtype, False, torch.float32, mesh=mesh)
    costs, limited = [], []
    i0 = 0
    for n in got["sizes"]:
        i1, i2 = got["i1"][i0:i0 + n], got["i2"][i0:i0 + n]
        i0 += n
        costs.append(k.costs(i1, i2))
        limited.append(k_lim.costs(i1, i2))
    del k_lim
    raw = normwise([got["costs"]], [np.concatenate(costs)])
    lim = float(np.max(np.abs(got["limited"] / np.concatenate(limited)
                              - 1.0)))
    say(f"multi-controller search ({len(got['sizes'])} probes, "
        f"{float(got['seconds']):.3f} s in worker 0, two processes "
        f"{wall:.1f} s with start-up): ranks identical {same}; costs "
        f"against one process {raw:.3e} normwise as searched, worst "
        f"{lim:.3e} relative with float32's clamp (bar 1e-12)")
    check(lim <= 1e-12, "multi-controller costs within 1e-12 of one "
          "process")
    # the averaging's partials against one process over the same shards
    w = planck_weights(sp, device)
    ng = int(ref_gp.g_point.max()) + 1

    class Reader:
        def iter_blocks(self, block_wav):
            for j in range(0, sp.optical_depth.shape[1], block_wav):
                yield j, sp.optical_depth[:, j:j + block_wav]

    acc = streaming_sharded_average_od_to_gpoints(
        mesh, Reader(), ng, ref_gp.g_point, lambda j, nb: w[:, j:j + nb],
        "transmission", block_wav=PARALLEL_BLOCK, finalize=False)
    same_mm = all(np.array_equal(got[f"acc_{m}"], acc[m])
                  for m in ("min", "max"))
    sums = [key for key in acc if key not in ("min", "max")]
    worst = 0.0
    for key in sums:
        a, b = got[f"acc_{key}"], acc[key]
        nz = b != 0
        check(np.array_equal(a[~nz], b[~nz]), f"averaging {key}: zeros "
              "identical")
        worst = max(worst, float(np.max(np.abs(a[nz] / b[nz] - 1.0),
                                        initial=0.0)))
    say(f"multi-controller averaging of profile 0 (blocks of "
        f"{PARALLEL_BLOCK}, {float(got['avg_seconds']):.3f} s in worker 0):"
        f" min and max partials bit-identical {same_mm}; sums {sums} worst "
        f"{worst:.3e} relative (bar 1e-12)")
    check(same_mm, "multi-controller min and max partials bit-identical")
    check(worst <= 1e-12, "multi-controller sums within 1e-12")
    out.update(ranks_identical=same, costs=raw, clamped_costs=lim,
               sums=worst, seconds=float(got["seconds"]), wall=wall)
    return out


def phase_parallel(smi, lw, sw, opt, device="cuda"):
    """Phase 13: the device solver and the parallel paths on one card.
    A mesh of 4 logical shards on cuda:0 stands for 4 cards; the
    multi-controller run is two processes on cuda:0 over gloo."""
    from ecckd_tpu_torch.ops.kernels import _build
    from ecckd_tpu_torch.parallel import make_mesh
    say = lambda line: log(f"[parallel] {line}")
    dev = torch.device(device)
    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[dev] * PARALLEL_SHARDS, data_parallel=1)
    out = {"mesh": repr(mesh)}

    seconds = out["seconds"] = {}
    t0 = time.perf_counter()
    out["device_solver"] = device_solver_run(lw, opt, say, dev)
    seconds["device_solver"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["data_parallel"] = data_parallel_run(lw, opt, mesh, say, dev)
    seconds["data_parallel"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # find_g_points sharded: LW and SW main paths, and LW once checked
    lw_gas = gas_input(order_of(lw.profiles[0], dev), lw.profiles[0])
    base = fgp_run(lw_gas, HR_TOL, band_parallel="off", device=dev)
    check_same_ranks(base[0], lw.gp, "LW search in phase 13 and phase 5")
    out["lw_search"] = {}
    lw_gp, probes = sharded_search("LW sharded search", lw_gas, HR_TOL,
                                   mesh, base, say, out=out["lw_search"])
    out["lw_search"]["ranks"] = rank_moves(
        "LW sharded search", lw_gas, HR_TOL, mesh, lw_gp, base[0], probes,
        say, dev)
    lw_kernel = probes[0][0]
    del probes
    sw_gas = gas_input(order_of(sw.profiles[0], dev, sw=True,
                                bands=SW_BANDS), sw.profiles[0])
    base = fgp_run(sw_gas, HR_TOL_SW, ssi=sw.ssi, band_parallel="off",
                   device=dev)
    check_same_ranks(base[0], sw.gp, "SW search in phase 13 and phase 6")
    out["sw_search"] = {}
    sw_gp, probes = sharded_search("SW sharded search", sw_gas, HR_TOL_SW,
                                   mesh, base, say, ssi=sw.ssi,
                                   out=out["sw_search"])
    out["sw_search"]["ranks"] = rank_moves(
        "SW sharded search", sw_gas, HR_TOL_SW, mesh, sw_gp, base[0],
        probes, say, dev, ssi=sw.ssi)
    del probes
    t0 = time.perf_counter()
    with _build.checked():
        checked_gp = fgp_run(lw_gas, HR_TOL, band_parallel="off",
                             mesh=mesh, device=dev)[0]
        sync(dev)
    check_same_ranks(checked_gp, lw_gp, "LW sharded search on the checked "
                     "build against the normal build")
    say(f"LW sharded search on the checked build in "
        f"{time.perf_counter() - t0:.2f} s: no index out of range, ranks "
        "identical")
    del lw_gas, sw_gas, base, checked_gp
    seconds["searches"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["create_lut"] = sharded_luts(lw, mesh, say, dev)
    seconds["create_lut"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["multi_controller"] = multi_controller_run(lw, lw_kernel, lw_gp,
                                                   say, dev)
    seconds["multi_controller"] = time.perf_counter() - t0
    out["phase_seconds"] = time.perf_counter() - t_phase
    say(json.dumps(out, default=float))
    say(f"phase {out['phase_seconds']:.1f} s ({smi})")
    return out


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

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    elapsed = lambda what: log(f"[smoke] {what} done at "
                               f"{time.perf_counter() - t_start:.1f} s")
    smi = phase_card()
    phase_build()
    elapsed("phase 2 (build)")
    times = phase_kernels(dev)
    elapsed("phase 3 (kernels)")
    phase_small_rig()
    elapsed("phase 4 (small rigs)")
    lw_profiles, lw_gp, lw_model, lw_launches = phase_lw_main_path()
    sw_profiles, ssi, sw_gp, sw_model, sw_launches = phase_sw_main_path()
    elapsed("phases 5-6 (main paths)")
    phase_rest(lw_profiles, sw_profiles, ssi, sw_gp, sw_model)
    phase_profile(lw_profiles, sw_profiles, ssi)
    elapsed("phases 6b-7 (rest, profile)")
    opt = phase_optimize(lw_profiles, lw_gp, lw_model, sw_profiles, ssi,
                         sw_gp, sw_model)
    lut_paths_at_main_size(lw_profiles, lw_gp, smi)
    elapsed("phase 8 (optimize, create_lut paths)")
    exp, exp_launches = phase_experiment()
    phase_checked(dev, times, exp)
    elapsed("phases 9-10 (experiment, checked build)")
    phase_ckdmip(smi)
    elapsed("phase 11 (CKDMIP scale)")
    lw = SimpleNamespace(profiles=lw_profiles, gp=lw_gp, model=lw_model,
                         launches=lw_launches, hr_error=opt.hr_error)
    sw = SimpleNamespace(profiles=sw_profiles, ssi=ssi, gp=sw_gp,
                         model=sw_model, launches=sw_launches)
    phase_workflow(smi, lw, sw)
    elapsed("phase 12 (workflow)")
    phase_parallel(smi, lw, sw, opt)
    del lw, sw, lw_profiles, sw_profiles, lw_model, sw_model
    log(f"[smoke] every phase passed in {time.perf_counter() - t_start:.1f} s")
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
    if sys.argv[1:2] == ["--parallel-worker"]:
        parallel_worker(*sys.argv[2:4])
        sys.exit(0)
    sys.exit(main())
