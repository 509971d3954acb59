"""reorder_spectrum: rank wavenumbers within each band by a sorting
variable.

PyTorch counterpart of ``ecckd_tpu/tools/reorder_spectrum.py``
(ref reorder_spectrum.cpp:36-313).  In the longwave the sorting variable
is the pseudo-height of peak cooling from a spectral radiative-transfer
calculation with an idealised temperature profile; in the shortwave
(``ssi`` given) it is the pseudo-height at which the od summed from the
top of the atmosphere reaches ``threshold_optical_depth``.  The per-band
std::stable_sort is a NumPy stable argsort.

Usage: ``python -m ecckd_tpu_torch.tools.reorder_spectrum input=...
output=... [ssi=...] [device=cuda|cpu] [precision=float64|float32]
[profile_dir=DIR]`` (``profile_dir``: a ``torch.profiler`` trace of the
core with the port's spans, :class:`~.common.maybe_profile`).
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

from .. import logs
from ..config import Config
from ..ops.heating_rate import heating_rate
from ..ops.planck import planck_function
from ..ops.rt_lw import rt_lw
from ..ops.streaming import block_results, read_ahead
from .common import (device_tensor, find_file, maybe_profile,
                     netcdf_format, resolve_device, setup, tool_prologue)


def _sorting_kernel(pressure_hl, wavenumber, d_wavenumber, od,
                    threshold_optical_depth=0.5):
    """LW sorting variable and column od for one wavenumber block
    (ref reorder_spectrum.cpp:98-228).  Independent per wavenumber, so
    blocks reproduce the whole-spectrum evaluation."""
    # Idealised T(log p): -100 C at 1 Pa to +15 C at 1e5 Pa (ref :121-124),
    # interpolated as jnp.interp does
    log_p = torch.log(pressure_hl)
    xp1 = math.log(100000.0)
    fp0, fp1 = 173.15, 288.15
    t_hl = fp0 + (log_p / xp1) * (fp1 - fp0)
    t_hl = torch.where(log_p < 0.0, fp0, torch.where(log_p > xp1, fp1, t_hl))
    planck_hl = planck_function(t_hl, wavenumber, d_wavenumber)
    surf_planck = planck_hl[-1]
    flux_dn, flux_up = rt_lw(planck_hl, od, torch.ones_like(surf_planck),
                             surf_planck)
    # Only interested in cooling (ref :172-175)
    hr = torch.clamp(heating_rate(pressure_hl, flux_dn, flux_up), max=0.0)

    column_od = torch.sum(od, dim=0)
    # Peak cooling pseudo-height (ref :178-183)
    log_p_hl = torch.log(pressure_hl)
    pseudo_height = log_p_hl[-1] - 0.5 * (log_p_hl[:-1] + log_p_hl[1:])
    d_height = log_p_hl[1:] - log_p_hl[:-1]
    num = torch.sum(hr * (d_height * pseudo_height)[:, None], dim=0)
    den = torch.sum(hr * d_height[:, None], dim=0)
    peak = num / torch.where(den != 0.0, den, 1.0)
    peak = torch.where(den != 0.0, peak, 0.0)
    if threshold_optical_depth > 0.0:
        peak = torch.where(column_od < threshold_optical_depth,
                           column_od - threshold_optical_depth, peak)
    return peak, column_od


def _sw_sorting_kernel(pressure_hl, od, threshold_optical_depth=0.5):
    """SW sorting variable and column od for one wavenumber block: the
    pseudo-height where the od summed from the top reaches the threshold,
    interpolated within the first layer that reaches it, or ``column_od -
    threshold`` where the column is thinner (ref reorder_spectrum.cpp:
    196-222).  The JAX tool's direct-beam heating rate is not computed:
    the SW sort never reads it."""
    t = threshold_optical_depth
    log_p_hl = torch.log(pressure_hl)
    column_od = torch.sum(od, dim=0)
    pseudo_height_hl = log_p_hl[-1] - log_p_hl
    cum_od = torch.cat([torch.zeros_like(od[:1]), torch.cumsum(od, dim=0)])
    reaches = cum_od[1:] >= t
    # First layer that reaches the threshold (0 when none does); argmax
    # takes no bool and returns the first maximum
    ilay = torch.argmax(reaches.to(torch.int32), dim=0)
    cum_above = cum_od.gather(0, ilay[None])[0]
    od_lay = od.gather(0, ilay[None])[0]
    h_above = pseudo_height_hl[ilay]
    h_below = pseudo_height_hl[ilay + 1]
    interp_h = (((t - cum_above) * h_below
                 + (cum_above + od_lay - t) * h_above)
                / torch.clamp(od_lay, min=1.0e-12))
    return torch.where(column_od <= t, column_od - t, interp_h), column_od


def compute_sorting_variable(pressure_hl, wavenumber, d_wavenumber,
                             optical_depth, threshold_optical_depth=0.5,
                             block_wav=1 << 20, device="cuda",
                             dtype=torch.float64, do_sw=False):
    """LW (or, with ``do_sw``, SW) sorting variable per wavenumber,
    computed blockwise on ``device`` (the card unless ``device="cpu"``;
    raises without one).

    ``optical_depth`` is a dense (nlay, nwav) array or anything with
    ``iter_blocks(block_wav)`` (the JAX package's ProfileBlocks).  The
    blocks run on the port's block loop (:func:`~ecckd_tpu_torch.ops.
    streaming.block_results`): on a card each is staged in page-locked
    memory on the prefetch thread and copied one block ahead of its
    kernel.  Returns (sorting_variable, column_optical_depth) as float64
    numpy arrays."""
    device = resolve_device(device)
    p_hl = device_tensor(pressure_hl, device, dtype)
    nwav = len(wavenumber)
    sorting = np.empty(nwav)
    column_od = np.empty(nwav)
    threshold = float(threshold_optical_depth)
    if hasattr(optical_depth, "iter_blocks"):
        blocks = optical_depth.iter_blocks(block_wav=block_wav)
    else:
        od_arr = np.asarray(optical_depth)
        blocks = ((i0, od_arr[:, i0:i0 + block_wav])
                  for i0 in range(0, nwav, block_wav))
    if not do_sw:
        wav_t = device_tensor(wavenumber, device, dtype)
        dwav_t = device_tensor(d_wavenumber, device, dtype)

    def reduce(i0, od):
        if do_sw:
            s, c = _sw_sorting_kernel(p_hl, od, threshold)
        else:
            sl = slice(i0, i0 + od.shape[1])
            s, c = _sorting_kernel(p_hl, wav_t[sl], dwav_t[sl], od,
                                   threshold_optical_depth=threshold)
        return {"sorting": s, "column_od": c}

    for i0, out in block_results(read_ahead(blocks, device), reduce, device,
                                 dtype):
        sl = slice(i0, i0 + len(out["sorting"]))
        sorting[sl] = out["sorting"]
        column_od[sl] = out["column_od"]
    return sorting, column_od


def _band_ranks(sorting, wavenumber, band1, band2, band_clamp1,
                band_clamp2):
    """Per-band stable sort ascending in the sorting variable (ref
    :262-295): (band number, rank) of each wavenumber."""
    nwav = len(wavenumber)
    nband = len(band1)
    iband = np.full(nwav, -1, np.int32)
    g_index = np.arange(nwav)
    for jband in range(nband):
        logs.log(f"  Band {jband}: {band_clamp1[jband]}-"
                 f"{band_clamp2[jband]} cm-1")
        if jband < nband - 1:
            sel = (wavenumber >= band1[jband]) & (wavenumber < band2[jband])
        else:
            sel = (wavenumber >= band1[jband]) & (wavenumber <= band2[jband])
        idx = np.nonzero(sel)[0]
        if len(idx) == 0:
            continue
        iband[idx] = jband
        i1, i2 = idx[0], idx[-1]
        sub = g_index[i1:i2 + 1]
        g_index[i1:i2 + 1] = sub[np.argsort(sorting[sub], kind="stable")]
    rank = np.empty(nwav, np.int32)
    rank[g_index] = np.arange(nwav)
    return iband, rank


def reorder_core(pressure_hl, wavenumber, d_wavenumber, optical_depth,
                 band1=None, band2=None, threshold_optical_depth=0.5,
                 block_wav=1 << 20, device="cuda", dtype=torch.float64,
                 do_sw=False):
    """Array-level reorder_spectrum: the order-file fields as a dict,
    computed on ``device`` (the card unless ``device="cpu"``; raises
    without one).

    ``do_sw`` selects the shortwave sorting variable.  ``band1``/``band2``
    are the band wavenumber bounds; None treats the whole spectrum as one
    band.  Returns ``wavenumber1_band``,
    ``wavenumber2_band`` (clamped to the spectrum), ``band_number``,
    ``rank``, ``column_optical_depth`` and ``sorting_variable``."""
    with logs.span("ecckd.reorder.core"):
        device = resolve_device(device)
        wavenumber = np.asarray(wavenumber)
        d_wavenumber = np.asarray(d_wavenumber)
        with logs.span("ecckd.reorder.sorting_variable"):
            sorting, column_od = compute_sorting_variable(
                pressure_hl, wavenumber, d_wavenumber, optical_depth,
                threshold_optical_depth, block_wav, device, dtype, do_sw)

        if band1 is None:
            band1 = np.array([max(0.0, wavenumber[0] - d_wavenumber[0])])
            band2 = np.array([wavenumber[-1] + d_wavenumber[-1]])
        band1 = np.asarray(band1, np.float64)
        band2 = np.asarray(band2, np.float64)
        logs.log("Treating the entire spectrum as one band" if len(band1) == 1
                 else f"Splitting the spectrum into {len(band1)} bands")
        band_clamp1 = band1.copy()
        band_clamp2 = band2.copy()
        band_clamp1[0] = max(wavenumber[0], band1[0])
        band_clamp2[-1] = min(wavenumber[-1], band2[-1])
        with logs.span("ecckd.reorder.sort"):
            iband, rank = _band_ranks(sorting, wavenumber, band1, band2,
                                      band_clamp1, band_clamp2)
        return dict(wavenumber1_band=band_clamp1,
                    wavenumber2_band=band_clamp2, band_number=iband,
                    rank=rank, column_optical_depth=column_od,
                    sorting_variable=sorting)


def reorder_spectrum(cfg: Config, argv=()) -> str:
    """The file tool: read one profile of a spectrum file, write the
    ordering file with the JAX tool's schema."""
    from ..io.order import write_order
    from ..io.spectrum import open_spectrum_profile

    device, dtype = setup(cfg)
    input_file = find_file(cfg.read_string("input"))
    output_file = cfg.read_string("output")
    ssi_file = cfg.read_string("ssi", default=None)
    do_sw = ssi_file is not None
    iprofile = cfg.read_int("iprofile", default=0)
    threshold = cfg.read_float("threshold_optical_depth", default=0.5)
    if do_sw:
        # The SW sorting variable needs no irradiance, but a missing ssi
        # file fails as it does in the JAX tool
        if not os.path.exists(find_file(ssi_file)):
            raise FileNotFoundError(f"ssi file {ssi_file!r} not found")
        logs.log("Assuming shortwave spectral region (ssi provided)")
    else:
        logs.log("Assuming longwave spectral region (ssi not provided)")
    logs.log(f"Reading {input_file}")
    with open_spectrum_profile(input_file, iprofile) as sp:
        molecule = cfg.read_string("molecule", default=sp.molecule)
        block_wav = cfg.read_int("streaming_block_wav", default=1 << 20)
        logs.log(f"{len(sp.pressure_hl) - 1} layers\n"
                 f"{len(sp.wavenumber)} spectral points")
        band1 = band2 = None
        if cfg.exist("wavenumber1"):
            band1 = cfg.read_floats("wavenumber1")
            band2 = cfg.read_floats("wavenumber2")
        with maybe_profile(cfg):
            out = reorder_core(sp.pressure_hl, sp.wavenumber,
                               sp.d_wavenumber, sp, band1, band2, threshold,
                               block_wav, device, dtype, do_sw)
        wavenumber, d_wavenumber = sp.wavenumber, sp.d_wavenumber
    logs.log(f"Writing {output_file}")
    write_order(output_file, argv or sys.argv, molecule, cfg.sprint(),
                out["wavenumber1_band"], out["wavenumber2_band"], wavenumber,
                d_wavenumber, out["band_number"], out["rank"],
                out["column_optical_depth"], out["sorting_variable"],
                format=netcdf_format(cfg))
    return output_file


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from ..errors import run_tool
    return run_tool(
        lambda: reorder_spectrum(tool_prologue(argv),
                                 argv=["reorder_spectrum"] + argv),
        name="reorder_spectrum")


if __name__ == "__main__":
    sys.exit(main())
