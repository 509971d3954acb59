"""Where the time of the sum and sweep kernels goes, on a card.

Times K1, K2 (with the reflected beam, ``K2up``, and without), K3, E1 and
E2 on the experiment inputs (:func:`~ecckd_tpu_torch.scripts.exp_kernels.
build_inputs`, 2^20 x 50 x 64, float64 then float32; K2 on the LW band's
od scaled by 0.05, its surface Planck row as the solar irradiance and an
albedo of 0.15) with parts of their work switched off.  Each variant is a copy of the
package under ``build/ablate/<variant>/`` with a line of one or two CUDA
sources edited, built and timed in a process of its own, in the order base,
no-reduce, no-scan, no-fit, no-common, lanes-swap, base.  An edited kernel gives wrong
sums: its times only count.

  no-reduce  the per-interval warp sums do nothing: E1 still stages its
             rows in the reducer of ``csrc/interval_reduce.cuh``
             (``Reducer::reduce`` skips them); K3 and E2 still load and form
             their rows, and K1 and K2 still sweep, on the streaming core of
             ``csrc/interval_stream.cuh`` (``ECCKD_STREAM_REDUCE`` 0: no
             masked sums, no shuffle trees; K3 and E2 still add and write
             their warps' partials)
  no-scan    E1 skips the scans of its wavenumbers: it still stages its
             tiles and reduces them
  no-fit     K1 and K2 add no fitted od: the gather of od_fit through L1
             is gone (what staging od_fit in shared memory could save)
  no-common  K1 and K2 gather od_fit per wavenumber even where all of a
             lane's wavenumbers share an interval
  lanes-swap K1 and K2 sweep 8 wavenumbers a lane in float64 (up to 255
             registers a thread) and 4 in float32, in place of 4 (up to
             128 registers) and 8

Usage: ``python -m ecckd_tpu_torch.scripts.ablate_kernels`` from the root
of a checkout, on a machine with a CUDA card.  One JSON line per variant
and dtype: the mean milliseconds (CUDA events, best of 3 runs of 20
launches) of each kernel.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
OUT = PKG.parent / "build" / "ablate"

# variant: edits (source under csrc/, line as it is, line as edited)
EDITS = {
    "no-reduce": (
        ("interval_reduce.cuh",
         "for (int p = warp; p < nrows_buf * count; p += kWarps) {",
         "for (int p = warp; p < 0; p += kWarps) {"),
        ("interval_stream.cuh", "#define ECCKD_STREAM_REDUCE 1",
         "#define ECCKD_STREAM_REDUCE 0")),
    "no-scan": (
        ("sweep_lw_scan.cu",
         "for (int c = warp; c < width; c += kWarps) {",
         "for (int c = warp; c < 0; c += kWarps) {"),),
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
}
VARIANTS = ("base", "no-reduce", "no-scan", "no-fit", "no-common",
            "lanes-swap", "base")


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


def time_kernels(variant):
    """Print one JSON line per dtype with each kernel's milliseconds."""
    import torch

    from ..ops.average import fit_optical_depth_lw
    from ..ops.kernels import (fused_interval_sum, fused_sums_lw_intervals,
                               sweep_lw_intervals, sweep_lw_scan_intervals,
                               sweep_sw_intervals)
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
        print(json.dumps({"variant": variant, "dtype": str(dtype),
                          "device": torch.cuda.get_device_name(dev),
                          "ms": ms}), flush=True)


def main():
    for variant in VARIANTS:
        path = PKG.parent if variant == "base" else _copy(variant)
        env = dict(os.environ, PYTHONPATH=str(path))
        subprocess.run([sys.executable, "-m", f"{PKG.name}.scripts."
                        "ablate_kernels", "--time", variant], env=env,
                       cwd=path, check=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_kernels(sys.argv[2])
    else:
        sys.exit(main())
