"""convert_spectra: convert CKDMIP HDF5 spectra to flat binary shards.

The port's own copy of ``ecckd_tpu/tools/convert_spectra.py``; its shards
are byte for byte the JAX tool's.  It reads HDF5, so it runs where h5py is.

Pre-processing step for the high-throughput streaming path (io/shards.py):
shards store wavenumber-major optical-depth blocks so the native loader can
stream contiguous wavenumber ranges with asynchronous reads overlapping
device compute.

Usage: python -m ecckd_tpu_torch.tools.convert_spectra input=... out_prefix=... \
       [iprofiles="0 1 2"] [dtype=float32] [cfg]
"""

from __future__ import annotations

import sys

import numpy as np

from .. import logs
from ..config import Config
from ..io.shards import convert_spectrum_file
from .common import tool_prologue, find_file


def convert_spectra(cfg: Config, argv=()) -> list:
    input_file = find_file(cfg.read_string("input"))
    out_prefix = cfg.read_string("out_prefix")
    iprofiles = cfg.read_ints("iprofiles", default=None)
    dtype = np.dtype(cfg.read_string("dtype", default="float32"))
    logs.log(f"Converting {input_file} -> {out_prefix}_*.spbin ({dtype})")
    paths = convert_spectrum_file(input_file, out_prefix,
                                  iprofiles=iprofiles, dtype=dtype)
    logs.log(f"Wrote {len(paths)} shard(s)")
    return paths


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: convert_spectra(tool_prologue(argv), argv=["convert_spectra"] + argv),
        name="convert_spectra")


if __name__ == "__main__":
    sys.exit(main())
