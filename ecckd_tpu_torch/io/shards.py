"""Flat binary spectral shards for streaming reads.

The port's own copy of ``ecckd_tpu/io/shards.py``, with the same magic and
byte layout, so that either package reads the other's shards.  The CKDMIP
database is ~700 GB of HDF5 spectra and the reference's wall clock is
dominated by reading it (doc/ecckd_documentation.tex:225-228).  A shard
holds one profile laid out for the streamed averaging: a contiguous byte
range is a contiguous wavenumber block of all layers, read by the native
loader (io/native.py) one block ahead of the consumer.

Format (one ``.spbin`` file per profile):
  [8-byte little-endian header length][JSON header]
  [wavenumber float64 array][d_wavenumber float64 array]
  [optical depth, shape (nwav, nlay), dtype from header, C order]

Only :func:`convert_spectrum_file` reads NetCDF, so it alone imports the
NetCDF reader (and h5py); a shard is written and read without them.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

from .native import NativeFile, PrefetchPool

_MAGIC = "ecckd_tpu-spbin-v1"


def write_shard(path: str, spectrum, dtype=np.float32):
    """Write one profile's spectrum (a :class:`~.spectrum.Spectrum`) as a
    flat binary shard."""
    od_t = np.ascontiguousarray(spectrum.optical_depth.T.astype(dtype))
    nwav, nlay = od_t.shape
    header = dict(
        magic=_MAGIC, dtype=np.dtype(dtype).name, nlay=nlay, nwav=nwav,
        molecule=spectrum.molecule,
        reference_surface_vmr=float(spectrum.reference_surface_vmr),
        pressure_hl=list(map(float, spectrum.pressure_hl)),
        temperature_hl=list(map(float, spectrum.temperature_hl)),
        vmr_fl=(list(map(float, np.atleast_1d(spectrum.vmr_fl)))
                if spectrum.vmr_fl is not None else None),
    )
    hjson = json.dumps(header).encode()
    # Write-then-rename so an interrupted write never leaves a truncated
    # shard at the final path (callers cache shards by existence).
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<q", len(hjson)))
        f.write(hjson)
        f.write(np.asarray(spectrum.wavenumber, np.float64).tobytes())
        f.write(np.asarray(spectrum.d_wavenumber, np.float64).tobytes())
        f.write(od_t.tobytes())
    os.replace(tmp, path)
    return path


def convert_spectrum_file(h5_path: str, out_prefix: str, iprofiles=None,
                          dtype=np.float32):
    """Convert profiles of a CKDMIP HDF5 spectrum file to shards."""
    from .spectrum import read_spectrum
    sp0 = read_spectrum(h5_path, 0)
    n = sp0.ncol
    if iprofiles is None:
        iprofiles = range(n)
    paths = []
    for iprof in iprofiles:
        sp = sp0 if iprof == 0 else read_spectrum(h5_path, iprof)
        paths.append(write_shard(f"{out_prefix}_{iprof:03d}.spbin", sp,
                                 dtype))
    return paths


class ShardReader:
    """Read a shard's metadata eagerly and its od in wavenumber blocks:
    through the native loader, or with ``native=False`` through Python's
    file reads (synchronous, no prefetch)."""

    def __init__(self, path: str, native: bool = True):
        self.path = path
        self._file = NativeFile(path, native=native)
        try:
            hlen = struct.unpack("<q", bytes(self._file.read(0, 8)))[0]
            self.header = json.loads(bytes(self._file.read(8, hlen)))
            if self.header.get("magic") != _MAGIC:
                raise ValueError(f"{path} is not a spectral shard")
        except BaseException:
            self._file.close()
            raise
        self.nlay = self.header["nlay"]
        self.nwav = self.header["nwav"]
        self.dtype = np.dtype(self.header["dtype"])
        self.pressure_hl = np.asarray(self.header["pressure_hl"])
        self.temperature_hl = np.asarray(self.header["temperature_hl"])
        off = 8 + hlen
        self.wavenumber = self._file.read(off, self.nwav * 8).view(
            np.float64)
        off += self.nwav * 8
        self.d_wavenumber = self._file.read(off, self.nwav * 8).view(
            np.float64)
        self._od_offset = off + self.nwav * 8
        self._row_bytes = self.nlay * self.dtype.itemsize

    def _block(self, raw: np.ndarray) -> np.ndarray:
        """The (nlay, nb) od of a block's bytes: a transposed view of the
        (nb, nlay) rows as stored, no copy."""
        return raw.view(self.dtype).reshape(-1, self.nlay).T

    def read_block(self, iwav0: int, nwav_block: int) -> np.ndarray:
        """Synchronously read a (nlay, nwav_block) od block."""
        return self._block(self._file.read(
            self._od_offset + iwav0 * self._row_bytes,
            nwav_block * self._row_bytes))

    def iter_blocks(self, block_wav: int = 1 << 16,
                    pool: Optional[PrefetchPool] = None
                    ) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (iwav0, od_block); natively, block k+1 is read by the
        loader's thread pool while block k is being processed."""
        starts = list(range(0, self.nwav, block_wav))
        sizes = [min(block_wav, self.nwav - i0) for i0 in starts]
        if not self._file.native:
            for iwav0, nb in zip(starts, sizes):
                yield iwav0, self.read_block(iwav0, nb)
            return
        own_pool = pool is None
        if own_pool:
            pool = PrefetchPool(nthreads=2)
        try:
            def submit(k):
                pool.submit(self._file,
                            self._od_offset + starts[k] * self._row_bytes,
                            sizes[k] * self._row_bytes, tag=k)
            if starts:
                submit(0)
            for k, iwav0 in enumerate(starts):
                if k + 1 < len(starts):
                    submit(k + 1)
                yield iwav0, self._block(pool.wait(k))
        finally:
            if own_pool:
                pool.close()

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
