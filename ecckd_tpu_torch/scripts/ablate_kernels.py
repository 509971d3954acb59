"""Where the time of the sum and sweep kernels goes, on a card.

Times K1, K2 (with the reflected beam, ``K2up``, and without), K3, E1 and
E2 on the experiment inputs (:func:`~ecckd_tpu_torch.scripts.exp_kernels.
build_inputs`, 2^20 x 50 x 64, float64 then float32; K2 on the LW band's
od scaled by 0.05, its surface Planck row as the solar irradiance and an
albedo of 0.15) with parts of their work switched off.  Each variant is a copy of the
package under ``build/ablate/<variant>/`` with a line of one or two CUDA
sources edited, built and timed in a process of its own, in the order base,
no-reduce, no-scan, no-fit, no-common, lanes-swap, strip-32, strip-8,
lpl-16, base.
An edited kernel may give wrong sums: its times only count.

  no-reduce  the per-interval sums do nothing, on the streaming core of
             ``csrc/interval_stream.cuh`` (``ECCKD_STREAM_REDUCE`` 0): K3
             and E2 still load and form their rows, and K1, K2 and E1 still
             sweep (no masked sums, no shuffle trees, no level sums of E1's
             buffer; K3 and E2 still add and write their warps' partials)
  no-scan    E1 composes no maps across the lanes of a wavenumber's group
             (``kScanWidth`` 1): it still loads, forms each layer's map,
             applies its own and sums the levels
  no-fit     K1 and K2 add no fitted od: the gather of od_fit through L1
             is gone (what staging od_fit in shared memory could save)
  no-common  K1 and K2 gather od_fit per wavenumber even where all of a
             lane's wavenumbers share an interval
  lanes-swap K1 and K2 sweep 8 wavenumbers a lane in float64 (up to 255
             registers a thread) and 4 in float32, in place of 4 (up to
             128 registers) and 8
  strip-32   E1 takes strips of 32 wavenumbers, in place of 16: twice the
             level buffer a warp, half the warps an SM holds
  strip-8    E1 takes strips of 8 wavenumbers: half the level buffer, twice
             the strips and their table entries
  lpl-16     E1 takes up to 16 layers a lane, in place of 8: at 50 layers
             float32 takes 4 lanes a wavenumber (13 layers a lane, 8
             wavenumbers a step) in place of 8 (7 layers, 4 wavenumbers)

Usage: ``python -m ecckd_tpu_torch.scripts.ablate_kernels [variant ...]``
from the root of a checkout, on a machine with a CUDA card; named
variants run between two base runs in place of all of them.  One JSON
line per variant and dtype: the mean milliseconds (CUDA events, best of 3 runs of 20
launches) of each kernel, and the warps of E1 one SM holds at 50 layers
(:func:`e1_resident_warps`).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
OUT = PKG.parent / "build" / "ablate"

# variant: edits (source under csrc/, line as it is, line as edited)
EDITS = {
    "no-reduce": (
        ("interval_stream.cuh", "#define ECCKD_STREAM_REDUCE 1",
         "#define ECCKD_STREAM_REDUCE 0"),),
    "no-scan": (
        ("sweep_lw_scan.cu", "constexpr int kScanWidth = G;",
         "constexpr int kScanWidth = 1;"),),
    "no-fit": (
        ("interval_stream.cuh", "const T x = __ldg(fit_row + f.common);",
         "const T x = T(0);"),
        ("interval_stream.cuh",
         "if (f.col[k] >= 0) od[k] += __ldg(fit_row + f.col[k]);",
         "if (f.col[k] >= 0) od[k] += T(0);")),
    "no-common": (
        ("interval_stream.cuh", "if (f.common >= 0) {",
         "if (f.common >= 0 && false) {"),
        ("interval_stream.cuh", "} else if (f.common == -2) {",
         "} else if (f.common == -2 || f.common >= 0) {")),
    "lanes-swap": (
        ("interval_stream.cuh",
         "template <typename T> constexpr int kSweepPer = 8;",
         "template <typename T> constexpr int kSweepPer = 4;"),
        ("interval_stream.cuh",
         "template <> constexpr int kSweepPer<double> = 4;",
         "template <> constexpr int kSweepPer<double> = 8;"),
        ("interval_stream.cuh",
         "template <> constexpr int kSweepMinBlocks<double> = 4;",
         "template <> constexpr int kSweepMinBlocks<double> = 2;")),
    "strip-32": (
        ("sweep_lw_scan.cu", "constexpr int kScanStrip = 16;",
         "constexpr int kScanStrip = 32;"),),
    "strip-8": (
        ("sweep_lw_scan.cu", "constexpr int kScanStrip = 16;",
         "constexpr int kScanStrip = 8;"),),
    "lpl-16": (
        ("sweep_lw_scan.cu", "constexpr int kScanMaxLpl = 8;",
         "constexpr int kScanMaxLpl = 16;"),),
}
VARIANTS = ("base", "no-reduce", "no-scan", "no-fit", "no-common",
            "lanes-swap", "strip-32", "strip-8", "lpl-16", "base")


def _copy(variant):
    """The package copied under ``build/ablate/<variant>`` with its edits;
    returns the directory to put on PYTHONPATH."""
    root = OUT / variant
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, old, new in EDITS[variant]:
        src = root / PKG.name / "csrc" / name
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{variant}: {name} no longer has the line "
                               f"{old!r} once")
        src.write_text(text.replace(old, new))
    return root


def _constant(text, name):
    return int(re.search(rf"{name} = (\d+);", text)[1])


def e1_resident_warps(nlay, bytes_, build_log):
    """Warps of E1 one H100 SM holds at ``nlay`` layers of ``bytes_``-byte
    values, as the occupancy calculator counts them: the blocks that its
    64 warps, its 64K registers (the instantiation's registers in nvcc's
    report ``build_log``, a warp's rounded up to 256) and its 228 KB of
    shared memory (the level buffers, 1 KB more a block) allow, at most
    32, times the warps a block.  The shape is csrc/sweep_lw_scan.cu's
    visit_shape, from the constants of the source this process built."""
    text = (PKG / "csrc" / "sweep_lw_scan.cu").read_text()
    strip, warps, max_lpl = (_constant(text, k) for k in (
        "kScanStrip", "kScanWarps", "kScanMaxLpl"))
    group = _constant(text, "kScanGroup<double>" if bytes_ == 8
                      else "constexpr int kScanGroup")
    while group * max_lpl < nlay:
        group *= 2
    lpl = -(-nlay // group)
    name = f"sweep_lw_scan_kernelI{'d' if bytes_ == 8 else 'f'}Li{group}ELi{lpl}E"
    regs = int(re.search(rf"Compiling entry function '[^']*{name}[^']*'.*?"
                         r"Used (\d+) registers", build_log, re.S)[1])
    smem = bytes_ * warps * 2 * (nlay + 1) * (strip + 1)
    blocks = min(32, 64 // warps,
                 65536 // (-(-regs * 32 // 256) * 256) // warps,
                 228 * 1024 // (-(-smem // 128) * 128 + 1024))
    return blocks * warps


def time_kernels(variant):
    """Print one JSON line per dtype with each kernel's milliseconds."""
    import torch

    from ..ops.average import fit_optical_depth_lw
    from ..ops.kernels import (_build, fused_interval_sum,
                               fused_sums_lw_intervals, sweep_lw_intervals,
                               sweep_lw_scan_intervals, sweep_sw_intervals)
    from ..ops.segments import part_of
    from .exp_kernels import NLAY, NSEG, build_inputs, time_ms

    dev = torch.device("cuda")
    n = 1 << 20
    for dtype in (torch.float64, torch.float32):
        d = build_inputs(NLAY, n, NSEG, dtype, dev)
        p, m, hr = d["planck_hl"], d["metric"], d["hr"]
        fd, fu, i1, i2 = (d["flux_dn_surf"], d["flux_up_toa"], d["i1"],
                          d["i2"])
        od_fit = fit_optical_depth_lw("transmission", p, m, i1, i2)
        sweep = (p, d["bg_od"], od_fit, d["seg_of_wav"],
                 d["surf_emissivity"], d["surf_planck"], i1, i2)
        sw = (d["surf_planck"], d["bg_od"] * 0.05, od_fit * 0.05,
              d["seg_of_wav"], i1, i2, 0.5,
              torch.full_like(d["surf_planck"], 0.15))
        parts = [part_of(m, p[1:]), part_of(p[1:]), part_of(hr),
                 part_of(fd), part_of(fu)]
        runs = {"K1": lambda: sweep_lw_intervals(*sweep),
                "K2up": lambda: sweep_sw_intervals(*sw, True),
                "K2": lambda: sweep_sw_intervals(*sw, False),
                "E1": lambda: sweep_lw_scan_intervals(*sweep),
                "K3": lambda: fused_interval_sum(parts, n, i1, i2),
                "E2": lambda: fused_sums_lw_intervals(m, p, hr, fd, fu, i1,
                                                      i2)}
        ms = {k: min(time_ms(fn, 20, dev) for _ in range(3))
              for k, fn in runs.items()}
        warps = e1_resident_warps(NLAY, torch.finfo(dtype).bits // 8,
                                  _build.build_log)
        print(json.dumps({"variant": variant, "dtype": str(dtype),
                          "device": torch.cuda.get_device_name(dev),
                          "ms": ms, "e1_resident_warps": warps}), flush=True)


def main(variants=VARIANTS):
    for variant in variants:
        path = PKG.parent if variant == "base" else _copy(variant)
        env = dict(os.environ, PYTHONPATH=str(path))
        subprocess.run([sys.executable, "-m", f"{PKG.name}.scripts."
                        "ablate_kernels", "--time", variant], env=env,
                       cwd=path, check=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_kernels(sys.argv[2])
    elif sys.argv[1:]:
        unknown = set(sys.argv[1:]) - set(EDITS)
        if unknown:
            sys.exit(f"unknown variants {sorted(unknown)}; choose from "
                     f"{sorted(EDITS)}")
        sys.exit(main(("base", *sys.argv[1:], "base")))
    else:
        sys.exit(main())
