"""reorder_cloud_spectrum: rank wavenumbers by cloud absorptance.

PyTorch-package counterpart of ``ecckd_tpu/tools/reorder_cloud_spectrum.py``
(ref src/ecckd/reorder_cloud_spectrum.cpp:30-201), host numpy as there:
the sorting variable is the cloud's approximate absorptance in the
optically thick limit, from its delta-Eddington-scaled single-scattering
albedo and asymmetry factor, interpolated onto the gas wavenumber grid;
within each band the wavenumbers are ranked by it.

:func:`reorder_cloud_core` works on arrays; :func:`reorder_cloud_spectrum`
is the file tool (``python -m ecckd_tpu_torch.tools.reorder_cloud_spectrum
input=<mie file> isize=N wavenumber_input=<spectrum> output=...
[wavenumber1=... wavenumber2=...]``), whose order file the SW
find_g_points reads as its ``cloud`` pseudo-gas.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import logs
from ..config import Config
from .common import find_file, netcdf_format, tool_prologue


def reorder_cloud_core(wavenumber, d_wavenumber, cloud_wavenumber,
                       single_scattering_albedo, asymmetry_factor,
                       wavenumber1=None, wavenumber2=None):
    """The order of the (nwav,) gas grid ``wavenumber`` (spacing
    ``d_wavenumber``) by the absorptance of a cloud whose (ncloud,) albedo
    and asymmetry factor are given on ``cloud_wavenumber``, per band
    [wavenumber1, wavenumber2) (one band over the grid by default).
    Returns the fields of the order file: ``wavenumber1_band``,
    ``wavenumber2_band`` (clamped to the grid), ``band_number`` (-1
    outside every band), ``rank`` and ``sorting_variable``."""
    wavenumber = np.asarray(wavenumber, np.float64)
    nwav = len(wavenumber)
    ssa = np.asarray(single_scattering_albedo, np.float64)
    asymmetry = np.asarray(asymmetry_factor, np.float64)

    # Absorptance in the thick limit with delta-Eddington scaling
    # (ref reorder_cloud_spectrum.cpp:113-123)
    fsc = asymmetry * asymmetry
    asymmetry_de = 1.0 / (1.0 + asymmetry)
    ssa_de = ssa * (1.0 - fsc) / (1.0 - ssa * fsc)
    abs_inf_c = np.sqrt((1.0 - ssa_de) / (1.0 - ssa_de * asymmetry_de))
    abs_inf_c = 1.0 - (1.0 - abs_inf_c) / (1.0 + abs_inf_c)
    abs_inf = np.interp(wavenumber, np.asarray(cloud_wavenumber, np.float64),
                        abs_inf_c)

    if wavenumber1 is not None:
        band1 = np.asarray(wavenumber1, np.float64)
        band2 = np.asarray(wavenumber2, np.float64)
    else:
        band1 = np.array([max(0.0, wavenumber[0] - d_wavenumber[0])])
        band2 = np.array([wavenumber[-1] + d_wavenumber[-1]])
    nband = len(band1)
    logs.log("Treating the entire spectrum as one band" if nband == 1
             else f"Splitting the spectrum into {nband} bands")
    band_clamp1 = band1.copy()
    band_clamp2 = band2.copy()
    band_clamp1[0] = max(wavenumber[0], band1[0])
    band_clamp2[-1] = min(wavenumber[-1], band2[-1])

    iband = np.full(nwav, -1, np.int32)
    g_index = np.arange(nwav)
    for jband in range(nband):
        sel = (wavenumber >= band1[jband]) & (
            wavenumber < band2[jband] if jband < nband - 1
            else wavenumber <= band2[jband])
        idx = np.nonzero(sel)[0]
        if len(idx) == 0:
            continue
        iband[idx] = jband
        sub = g_index[idx[0]:idx[-1] + 1]
        g_index[idx[0]:idx[-1] + 1] = sub[np.argsort(abs_inf[sub],
                                                     kind="stable")]
    rank = np.empty(nwav, np.int32)
    rank[g_index] = np.arange(nwav)
    return dict(wavenumber1_band=band_clamp1, wavenumber2_band=band_clamp2,
                band_number=iband, rank=rank, sorting_variable=abs_inf)


def reorder_cloud_spectrum(cfg: Config, argv=()) -> str:
    """The file tool: read the gas grid and one size of the cloud's
    optical properties, write the cloud's order file."""
    from ..io import NcFile, write_order
    from ..io.spectrum import _d_wavenumber_from_grid

    input_file = find_file(cfg.read_string("input"))
    isize = cfg.read_int("isize")
    wavenumber_input = find_file(cfg.read_string("wavenumber_input"))
    output = cfg.read_string("output")
    logs.log(f"Reading {wavenumber_input}")
    with NcFile(wavenumber_input) as f:
        wavenumber = np.asarray(f.read("wavenumber"), np.float64)
    d_wavenumber = _d_wavenumber_from_grid(wavenumber)
    logs.log(f"Reading {input_file}")
    with NcFile(input_file) as f:
        cloud_wavenumber = f.read("wavenumber")
        ssa = np.asarray(f.read("single_scattering_albedo"))[isize]
        asymmetry = np.asarray(f.read("asymmetry_factor"))[isize]
    bands = {}
    if cfg.exist("wavenumber1"):
        bands = dict(wavenumber1=cfg.read_floats("wavenumber1"),
                     wavenumber2=cfg.read_floats("wavenumber2"))
    order = reorder_cloud_core(wavenumber, d_wavenumber, cloud_wavenumber,
                               ssa, asymmetry, **bands)
    logs.log(f"Writing {output}")
    write_order(output, argv or sys.argv, "cloud", cfg.sprint(),
                order["wavenumber1_band"], order["wavenumber2_band"],
                wavenumber, d_wavenumber, order["band_number"],
                order["rank"], None, order["sorting_variable"],
                format=netcdf_format(cfg))
    return output


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: reorder_cloud_spectrum(
            tool_prologue(argv), argv=["reorder_cloud_spectrum"] + argv),
        name="reorder_cloud_spectrum")


if __name__ == "__main__":
    sys.exit(main())
