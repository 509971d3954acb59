"""Readers for CKDMIP high-resolution absorption-spectra files.

The port's own copy of ``ecckd_tpu/io/spectrum.py``.  A path ending in
``.spbin`` is a flat binary shard (io/shards.py), read by the native loader;
any other path is a NetCDF file, read through h5py, which only those
branches import, so that shards are read where h5py is missing.
Equivalents of read_spectrum (src/ecckd/read_spectrum.cpp:19-87)
and read_merged_spectrum (src/ecckd/read_merged_spectrum.cpp:19-190): load
one profile of layer x wavenumber optical depth, optionally summing several
gases with concentration scaling to target profiles.

Two access modes share one code path:

* ``read_spectrum`` / ``read_merged_spectrum`` materialize the full
  (nlay, nwav) array — fine for test-scale spectra.
* ``open_spectrum_profile`` / ``open_merged_spectrum_profile`` return a
  :class:`ProfileBlocks` whose ``iter_blocks`` yields wavenumber blocks
  via HDF5 hyperslab or shard reads, so at CKDMIP scale (~5.6M wavenumbers x ~50
  layers x several gases) host memory stays bounded and reads overlap
  device compute.  The reference streams one profile at a time for the
  same reason (create_look_up_table.cpp:242-298); the block axis is this
  framework's addition.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np

from .. import logs
from ..config import Config


@dataclasses.dataclass
class Spectrum:
    pressure_hl: np.ndarray          # (nlev+1,)
    temperature_hl: np.ndarray       # (nlev+1,)
    wavenumber: np.ndarray           # (nwav,) cm-1
    d_wavenumber: np.ndarray         # (nwav,) cm-1
    optical_depth: np.ndarray        # (nlay, nwav)
    molecule: str = ""
    reference_surface_vmr: float = -1.0
    vmr_fl: Optional[np.ndarray] = None   # (nlay,) or (ngas, nlay) merged
    ncol: int = 1


def _d_wavenumber_from_grid(wavenumber: np.ndarray) -> np.ndarray:
    """Central differences with halved end values
    (ref read_spectrum.cpp:55-63)."""
    d = np.empty_like(wavenumber)
    d[1:-1] = 0.5 * (wavenumber[2:] - wavenumber[:-2])
    d[0] = 0.5 * d[1]
    d[-1] = 0.5 * d[-2]
    return d


class ProfileBlocks:
    """One profile's spectral optical depth as a lazy block source.

    The merged optical depth is a per-file scaled sum
    (read_merged_spectrum.cpp:120-165); each source carries its scale —
    ``None`` (unscaled), a scalar, or an (nlay,) concentration-profile
    ratio — and blocks sum across sources in file order, so a full-width
    block reproduces the dense readers bit-for-bit.

    Metadata attributes mirror :class:`Spectrum` (all O(nlay + nwav)).
    """

    def __init__(self, sources, pressure_hl, temperature_hl, wavenumber,
                 d_wavenumber, molecule="", reference_surface_vmr=-1.0,
                 vmr_fl=None, ncol=1, log_column_od=False):
        # sources: list of (file, iprof, scale); a file has
        # read_slice("optical_depth", iprof, i0, i1) and close()
        self._sources = sources
        self.pressure_hl = pressure_hl
        self.temperature_hl = temperature_hl
        self.wavenumber = wavenumber
        self.d_wavenumber = d_wavenumber
        self.molecule = molecule
        self.reference_surface_vmr = reference_surface_vmr
        self.vmr_fl = vmr_fl
        self.ncol = ncol
        self._log_column_od = log_column_od
        self.nwav = len(wavenumber)
        self.nlay = len(pressure_hl) - 1

    # -- block access ------------------------------------------------------
    def read_block(self, iwav0: int, nwav_block: int) -> np.ndarray:
        """(nlay, nwav_block) float64 merged optical depth."""
        out = None
        for f, iprof, scale in self._sources:
            block = np.asarray(
                f.read_slice("optical_depth", iprof, iwav0,
                             iwav0 + nwav_block), np.float64)
            if scale is not None:
                if np.ndim(scale) == 1:
                    block = block * np.asarray(scale)[:, None]
                elif scale != 1.0:
                    block = block * scale
            out = block if out is None else out + block
        return out

    def iter_blocks(self, block_wav: int = 1 << 20):
        """Yield (iwav0, (nlay, block) od) over the wavenumber axis —
        the interface ops.streaming.streaming_average_od_to_gpoints
        consumes."""
        for i0 in range(0, self.nwav, block_wav):
            nb = min(block_wav, self.nwav - i0)
            with logs.span("ecckd.io.read_block"):
                block = self.read_block(i0, nb)
            yield i0, block

    def materialize(self) -> Spectrum:
        """Full (nlay, nwav) read -> dense :class:`Spectrum`."""
        od = self.read_block(0, self.nwav)
        if self._log_column_od:
            col_od = od.sum(axis=1)
            logs.log(f"    Column optical depth: {col_od.mean():g} +/- "
                     f"{col_od.std():g}")
        return Spectrum(self.pressure_hl, self.temperature_hl,
                        self.wavenumber, self.d_wavenumber, od,
                        self.molecule, self.reference_surface_vmr,
                        self.vmr_fl, self.ncol)

    def close(self):
        seen = set()
        for f, _, _ in self._sources:
            if id(f) not in seen:
                seen.add(id(f))
                f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _ArraySource:
    """The read_slice view of an in-memory (nlay, nwav) optical depth."""

    def __init__(self, optical_depth):
        self.optical_depth = optical_depth

    def read_slice(self, var, iprof, a, b):
        if var != "optical_depth":
            raise KeyError(var)
        return self.optical_depth[:, a:b]

    def close(self):
        pass


def spectrum_blocks(spectrum) -> ProfileBlocks:
    """A :class:`ProfileBlocks` over an in-memory spectrum (anything with
    ``pressure_hl``, ``temperature_hl``, ``wavenumber``, ``d_wavenumber``
    and an (nlay, nwav) ``optical_depth``), for the block-wise consumers
    (streamed averaging, lw_spectra) on arrays.  Blocks are views where the
    od is float64 already."""
    g = lambda name, default: getattr(spectrum, name, default)
    return ProfileBlocks(
        [(_ArraySource(spectrum.optical_depth), 0, None)],
        np.asarray(spectrum.pressure_hl, np.float64),
        np.asarray(spectrum.temperature_hl, np.float64),
        np.asarray(spectrum.wavenumber, np.float64),
        np.asarray(spectrum.d_wavenumber, np.float64), g("molecule", ""),
        g("reference_surface_vmr", -1.0), g("vmr_fl", None), g("ncol", 1))


def _profile_meta(f, file_name: str, iprof: int):
    """Everything in a spectrum file except the optical depth."""
    ncol = f.size("pressure_hl")[0]
    pressure_hl = np.asarray(f.read("pressure_hl", index=iprof), np.float64)
    if f.exist("temperature_hl"):
        temperature_hl = np.asarray(f.read("temperature_hl", index=iprof),
                                    np.float64)
    else:
        logs.warning('"temperature_hl" not present')
        temperature_hl = np.zeros_like(pressure_hl)
    wavenumber = np.asarray(f.read("wavenumber"), np.float64)
    if f.exist("d_wavenumber"):
        d_wavenumber = np.asarray(f.read("d_wavenumber"), np.float64)
    else:
        d_wavenumber = _d_wavenumber_from_grid(wavenumber)
    molecule = f.attribute("constituent_id", default="") or ""
    if f.exist("reference_surface_mole_fraction"):
        ref_vmr = float(f.read_scalar("reference_surface_mole_fraction"))
    else:
        ref_vmr = -1.0
    if f.exist("mole_fraction_fl") and len(f.size("mole_fraction_fl")) == 2:
        vmr_fl = np.asarray(f.read("mole_fraction_fl", index=iprof),
                            np.float64)
    else:
        vmr_fl = np.full(len(pressure_hl) - 1, -1.0)
    return (ncol, pressure_hl, temperature_hl, wavenumber, d_wavenumber,
            molecule, ref_vmr, vmr_fl)


class _ShardSourceFile:
    """NcFile-compatible optical-depth view of a ``.spbin`` shard, so the
    native loader serves ProfileBlocks consumers (reorder_spectrum,
    find_g_points, create_lut, lw_spectra) without h5py.  Each slice is
    one synchronous ``pread`` (``ShardReader.read_block``); the streamed
    consumers overlap the reads with the device's work by reading through
    ``io.prefetch.prefetch_iter``'s thread, not through the loader's
    thread pool (which ``ShardReader.iter_blocks`` uses)."""

    def __init__(self, path: str):
        from .shards import ShardReader
        self.reader = ShardReader(path)

    def read_slice(self, var, iprof, a, b):
        if var != "optical_depth":
            raise KeyError(var)
        return self.reader.read_block(a, b - a)

    def close(self):
        self.reader.close()


def _shard_profile_path(path: str, iprof: int) -> str:
    """Per-profile shard naming: convert_spectrum_file writes one profile
    per file as ``prefix_NNN.spbin``; profile i of ``prefix_000.spbin`` is
    ``prefix_<i:03d>.spbin``."""
    import re
    if iprof == 0:
        return path
    m = re.match(r"^(.*_)(\d+)(\.spbin)$", path)
    if not m:
        raise ValueError(
            f"{path} has no _NNN.spbin profile suffix; cannot select "
            f"profile {iprof}")
    return f"{m.group(1)}{iprof:0{len(m.group(2))}d}{m.group(3)}"


def _shard_profile_count(path: str) -> int:
    """Number of sibling per-profile shards of ``path``."""
    import glob
    import re
    m = re.match(r"^(.*_)(\d+)(\.spbin)$", path)
    if not m:
        return 1
    # glob.escape the literal prefix/suffix: metacharacters ([, ?, *) in
    # directory or file names must match themselves, not act as patterns
    return len(glob.glob(f"{glob.escape(m.group(1))}"
                         f"{'[0-9]' * len(m.group(2))}"
                         f"{glob.escape(m.group(3))}")) or 1


def _shard_meta(path: str, iprof: int):
    """Shard analogue of :func:`_profile_meta` (header carries molecule,
    reference vmr and the concentration profile)."""
    src = _ShardSourceFile(_shard_profile_path(path, iprof))
    r = src.reader
    h = r.header
    vmr_fl = (np.asarray(h.get("vmr_fl"), np.float64)
              if h.get("vmr_fl") is not None
              else np.full(r.nlay, -1.0))
    return src, (_shard_profile_count(path), r.pressure_hl,
                 r.temperature_hl, r.wavenumber, r.d_wavenumber,
                 h.get("molecule", "") or "",
                 float(h.get("reference_surface_vmr", -1.0)), vmr_fl)


def _open_source(file_name: str, iprof: int):
    """(file, metadata) of one profile of a shard or a NetCDF file."""
    if file_name.endswith(".spbin"):
        return _shard_meta(file_name, iprof)
    from .ncio import NcFile
    f = NcFile(file_name)
    return f, _profile_meta(f, file_name, iprof)


def open_spectrum_profile(file_name: str, iprof: int) -> ProfileBlocks:
    """Open one profile of spectral optical depth for block reads.

    ``.spbin`` shards (io.shards / tools.convert_spectra) are read by
    the native loader, a synchronous ``pread`` a block; anything else
    reads via NetCDF.
    """
    f, meta = _open_source(file_name, iprof)
    (ncol, pressure_hl, temperature_hl, wavenumber, d_wavenumber, molecule,
     ref_vmr, vmr_fl) = meta
    return ProfileBlocks([(f, iprof, None)], pressure_hl, temperature_hl,
                         wavenumber, d_wavenumber, molecule, ref_vmr,
                         vmr_fl, ncol)


def read_spectrum(file_name: str, iprof: int) -> Spectrum:
    """Read one profile of spectral optical depth."""
    with open_spectrum_profile(file_name, iprof) as pb:
        return pb.materialize()


def open_merged_spectrum_profile(config: Config, iprofile: int,
                                 prefix: str = "") -> ProfileBlocks:
    """Open the scaled per-gas sum of several spectra for block reads.

    Config keys (relative to ``prefix``, e.g. "h2o."): ``input`` (list of
    files), ``scaling``/``conc`` (per-file scalars), ``conc_input`` +
    ``iprofile`` (target concentration profiles).  Ref
    read_merged_spectrum.cpp:19-190 — the scale factors are resolved here
    from metadata only; the od itself is read lazily.
    """
    input_name = prefix + "input"
    scaling_name = prefix + "scaling"
    conc_name = prefix + "conc"
    conc_input_name = prefix + "conc_input"
    iprof_conc_name = prefix + "iprofile"

    files = config.read_strings(input_name, default=None)
    if not files:
        raise ValueError(f"Unable to read input file names in {input_name}")
    scalings = config.read_floats(scaling_name, default=None) or []
    concs = config.read_floats(conc_name, default=None) or []

    iprof_conc = -1
    conc_file = None
    pressure_conc = None
    conc_file_name = config.read_string(conc_input_name, default=None)
    if conc_file_name:
        iprof_conc = config.read_int(iprof_conc_name, default=None)
        if iprof_conc is None:
            raise ValueError('Concentration file specified without profile '
                             'number in "iprofile"')
        from .ncio import NcFile
        conc_file = NcFile(conc_file_name)
        pressure_conc = np.asarray(
            conc_file.read("pressure_fl", index=iprof_conc), np.float64)

    sources = []
    molecules: List[str] = []
    vmr_rows: List[np.ndarray] = []
    meta = None
    pressure_fl = None

    for ibg, file_name in enumerate(files):
        scaling = scalings[ibg] if ibg < len(scalings) else -1.0
        conc = concs[ibg] if ibg < len(concs) else -1.0
        logs.log(f"  Reading {file_name}")
        f, meta_f = _open_source(file_name, iprofile)
        (ncol, pressure_hl, temperature_hl, wavenumber, d_wavenumber,
         molecule, ref_vmr, vmr_fl) = meta_f
        if not molecule:
            raise ValueError(
                'Found neither "constituent_id" nor "molecules" amongst the '
                "global attributes")
        molecules.append(molecule)

        if meta is None:
            meta = (ncol, pressure_hl, temperature_hl, wavenumber,
                    d_wavenumber)
            pressure_fl = 0.5 * (pressure_hl[:-1] + pressure_hl[1:])

        scale: Union[None, float, np.ndarray] = None
        if iprof_conc >= 0:
            conc_req = np.asarray(conc_file.read(
                f"{molecule}_mole_fraction_fl", index=iprof_conc), np.float64)
            conc_interp = np.interp(pressure_fl, pressure_conc, conc_req)
            scale = conc_interp / vmr_fl
            logs.log("    Scaling to target concentration profile in the "
                     f"range {conc_interp.min():g} to {conc_interp.max():g}")
            vmr_rows.append(conc_interp)
        else:
            if conc == 0.0:
                scaling = 0.0
            elif conc > 0.0:
                if ref_vmr < 0.0:
                    raise ValueError(
                        "Attempt to specify concentration when no "
                        "reference_surface_mole_fraction present in "
                        f"{file_name}")
                scaling = conc / ref_vmr
                logs.log(f"    Reference surface concentration = {ref_vmr}")
                logs.log(f"    Target surface concentration    = {conc}")
            elif scaling < 0.0:
                scaling = 1.0
            if scaling != 1.0:
                logs.log(f"    Scaling by {scaling}")
                scale = scaling
                vmr_rows.append(vmr_fl * scaling)
            else:
                vmr_rows.append(vmr_fl)
        sources.append((f, iprofile, scale))

    if conc_file is not None:
        conc_file.close()

    ncol, pressure_hl, temperature_hl, wavenumber, d_wavenumber = meta
    return ProfileBlocks(sources, pressure_hl, temperature_hl, wavenumber,
                         d_wavenumber, " ".join(molecules), -1.0,
                         np.vstack(vmr_rows), ncol, log_column_od=True)


def read_merged_spectrum(config: Config, iprofile: int,
                         prefix: str = "") -> Spectrum:
    """Read and sum the spectra of several gases (dense form)."""
    with open_merged_spectrum_profile(config, iprofile, prefix) as pb:
        return pb.materialize()
