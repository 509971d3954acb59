"""summarize_g_points: per-file g-point count summary.

The port's own copy of ``ecckd_tpu/tools/summarize_g_points.py``, the
equivalent of test/summarize_g_points.sh (an ncdump|sed one-liner there):
for each NetCDF file on the command line print the g_point dimension, the
per-gas g-point totals and the band count, one line per file.  Pure
metadata reads — no spectra are touched.
"""

from __future__ import annotations

import sys
from typing import List


def summarize_file(path: str) -> str:
    from ..io import NcFile

    with NcFile(path) as f:
        parts: List[str] = []
        names = f.names()
        # Total merged g points (dimension of band_number / solar_irradiance)
        if f.exist("band_number"):
            parts.append(f"g_point = {f.size('band_number')[0]}")
        # Per-gas counts from <gas>_n_g_points vectors
        for name in sorted(names):
            if name.endswith("_n_g_points"):
                gas = name[:-len("_n_g_points")]
                counts = f.read(name)
                total = int(counts.sum())
                per_band = " ".join(str(int(c)) for c in counts)
                parts.append(f"{gas} = {total} [{per_band}]")
        if f.exist("wavenumber1_band"):
            parts.append(f"bands = {f.size('wavenumber1_band')[0]}")
        # ckd-definition files: per-gas molar-abs g dimension
        if not parts and f.exist("gpoint_fraction"):
            parts.append(f"g_point = {f.size('gpoint_fraction')[0]}")
    return f"{' | '.join(parts) or 'no g-point metadata'} {path}"


def summarize_g_points(paths) -> List[str]:
    return [summarize_file(p) for p in paths]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: summarize_g_points FILE [FILE...]", file=sys.stderr)
        return 1
    for line in summarize_g_points(argv):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
