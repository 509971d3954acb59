"""NetCDF file I/O: NetCDF-4 over HDF5 (h5py), or the classic container.

TPU-native replacement for the reference's DataFile/OutputDataFile layer
(src/include/DataFile.h:49-337, src/include/OutputDataFile.h:47-193,
src/tools/DataFileEngineNetcdf.cpp, src/tools/OutputDataFile.cpp).

NetCDF-4 files *are* HDF5 files whose dimensions are HDF5 dimension scales,
so reading CKDMIP inputs and writing ckd-definition outputs needs no netCDF
C library: we read/write plain HDF5 and emit proper dimension scales plus
the standard attributes (units, long_name, history, config, summary) so the
outputs are drop-in consumable by ecRad/netCDF tools.

Write-side parity features (ref OutputDataFile.cpp):
* define_dimension (incl. unlimited via maxshape=None)
* typed variables: double/float/int/short/byte/string
* deflate compression + chunking
* ``append_history``: timestamped command line appended to the global
  ``history`` attribute (ref OutputDataFile.cpp:1005-1048)

The port's own copy of ``ecckd_tpu/io/ncio.py``: the port imports nothing of
the JAX package.  It adds the classic container, CDF-2 (64-bit offset),
written and read through ``scipy.io.netcdf_file`` where h5py is missing;
the reference's OutputDataFile writes it as well as NetCDF-4, and ecRad
reads both.  NetCDF-4 stays the default: ``NcWriter(path,
format="classic")`` (the tools' ``netcdf_format=classic``) asks for the
other, and NetCDF-4 without h5py raises.  :class:`NcFile` tells the two
apart by their first bytes.  h5py is imported only for NetCDF-4 and scipy
only for classic.  The variables, dimensions and attributes, and so every
number, are the same in both; the classic container has
* one unlimited dimension, the leading one of each variable that uses it;
* no string type: a ``string`` variable raises;
* no compression: ``deflate`` is not written (logged once per process);
* no ``_nc4_non_coord_`` names: a variable that shares a dimension's name
  is stored under its own;
* a cap of 4 GiB on one fixed-size variable (on one record of a record
  variable), which raises;
and ``scipy.io.netcdf_file`` keeps the whole file in memory until it is
closed, which suits the workflow's artifacts, not a full-resolution
spectrum.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import logs

FORMATS = ("netcdf4", "classic")

_TYPE_MAP = {
    "double": np.float64,
    "float": np.float32,
    "int": np.int32,
    "short": np.int16,
    "byte": np.int8,
}

# Sentinel attribute h5py uses to mark "dimension without coordinate variable"
_DIM_WITHOUT_VAR = b"This is a netCDF dimension but not a netCDF variable."


def _import_h5py():
    try:
        import h5py
    except ImportError as err:
        raise ImportError(
            "NetCDF-4 files need h5py, which is not installed; write the "
            "classic container instead (netcdf_format=classic)") from err
    return h5py


def _container(path: str) -> str:
    """The container of ``path``, from its first bytes: ``CDF\\x01`` or
    ``CDF\\x02`` is ``"classic"``; anything else (``\\x89HDF``) is
    ``"netcdf4"``, handed to h5py."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        magic = f.read(4)
    return "classic" if magic in (b"CDF\x01", b"CDF\x02") else "netcdf4"


def _decode(value):
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    if isinstance(value, np.ndarray) and value.dtype.kind in ("S", "O"):
        if value.size == 1:
            return _decode(value.reshape(-1)[0])
        return [_decode(v) for v in value]
    if isinstance(value, np.generic):
        return value.item() if value.dtype.kind in "iufb" else _decode(value.item())
    return value


class NcFile:
    """Read-only NetCDF file (DataFile equivalent): NetCDF-4/HDF5, or a
    classic file, which opens as :class:`_ClassicFile`."""

    def __new__(cls, path: str):
        if cls is NcFile and _container(path) == "classic":
            cls = _ClassicFile
        return super().__new__(cls)

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self._f = _import_h5py().File(path, "r")

    # -- queries ---------------------------------------------------------
    def _resolve(self, name: str) -> str:
        """Resolve a netCDF variable name to its HDF5 dataset: variables that
        clash with a dimension name are stored as _nc4_non_coord_<name>
        (netcdf-c convention)."""
        alt = "_nc4_non_coord_" + name
        if alt in self._f:
            return alt
        return name

    def exist(self, name: str) -> bool:
        name = self._resolve(name)
        if name not in self._f or not isinstance(self._f[name],
                                                 _import_h5py().Dataset):
            return False
        ds = self._f[name]
        # A pure dimension scale with no data is not a netCDF variable
        nm = ds.attrs.get("NAME")
        if nm is not None and bytes(nm).startswith(
                b"This is a netCDF dimension but not a netCDF variable"):
            return False
        return True

    def size(self, name: str) -> Tuple[int, ...]:
        return tuple(self._f[self._resolve(name)].shape)

    def names(self) -> List[str]:
        dataset = _import_h5py().Dataset
        return [k for k in self._f.keys() if isinstance(self._f[k], dataset)]

    # -- data ------------------------------------------------------------
    def read(self, name: str, index: Optional[int] = None,
             index2: Optional[int] = None) -> np.ndarray:
        """Read a variable; ``index`` selects along the leading dimension
        (matching DataFile's slice-read convention, DataFile.h:140-220)."""
        ds = self._f[self._resolve(name)]
        if ds.shape == ():  # scalar
            return _decode(ds[()])
        if index is None:
            data = ds[...]
        elif index2 is None:
            data = ds[index, ...]
        else:
            data = ds[index, index2, ...]
        if data.dtype.kind in ("S", "O"):
            return _decode(data)
        return data

    def read_slice(self, name: str, index: Optional[int],
                   start: int, stop: int) -> np.ndarray:
        """Hyperslab read along the LAST axis of one leading-index record
        (``var[index, ..., start:stop]``) — the streaming-read primitive:
        at CKDMIP scale a (nlay, nwav) profile is several GB, so the
        wavenumber axis is consumed in blocks (create_look_up_table.cpp
        streams whole profiles; the block axis is this framework's
        addition so host reads overlap device compute)."""
        ds = self._f[self._resolve(name)]
        if index is None:
            return ds[..., start:stop]
        return ds[index, ..., start:stop]

    def read_scalar(self, name: str) -> float:
        val = self.read(name)
        if isinstance(val, np.ndarray):
            return val.reshape(-1)[0].item()
        return val

    def read_string(self, name: str) -> str:
        return str(self.read(name))

    # -- attributes ------------------------------------------------------
    def attribute(self, attr: str, var: Optional[str] = None,
                  default: Any = None) -> Any:
        obj = self._f if var is None else self._f[self._resolve(var)]
        if attr in obj.attrs:
            return _decode(obj.attrs[attr])
        return default

    def global_attributes(self) -> Dict[str, Any]:
        return {k: _decode(v) for k, v in self._f.attrs.items()
                if not k.startswith("_")}

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NcWriter:
    """NetCDF writer (OutputDataFile equivalent): NetCDF-4 by default,
    the classic container with ``format="classic"``
    (:class:`_ClassicWriter`).

    Usage follows the reference two-phase define/data model loosely, but
    definitions and writes may be freely interleaved.
    """

    def __new__(cls, path: str, deflate_level: int = 0,
                format: str = "netcdf4"):
        if format not in FORMATS:
            raise ValueError(f"NetCDF format {format!r} not understood; "
                             f"choose from {list(FORMATS)}")
        if cls is NcWriter and format == "classic":
            cls = _ClassicWriter
        return super().__new__(cls)

    def __init__(self, path: str, deflate_level: int = 0,
                 format: str = "netcdf4"):
        h5py = _import_h5py()
        self.path = path
        self._f = h5py.File(path, "w")
        self._dims: Dict[str, Optional[int]] = {}
        self._dim_order: List[str] = []
        self._var_dims: Dict[str, Tuple[str, ...]] = {}
        self._pending_attach: List[Tuple[str, int, str]] = []
        self._deflate = deflate_level
        # NetCDF-4 files written by the netcdf-c library carry this marker;
        # harmless and helps tools identify the flavour.
        self._f.attrs["_NCProperties"] = np.bytes_(
            b"version=2,ecckd_tpu=" + b"0.1")

    # -- dimensions ------------------------------------------------------
    def define_dimension(self, name: str, length: Optional[int] = None):
        """Define a dimension; ``length=None`` means unlimited."""
        if name in self._dims:
            return
        self._dims[name] = length
        self._dim_order.append(name)

    def _ensure_dim_dataset(self, name: str):
        """Create the HDF5 dimension-scale dataset for dimension ``name``.

        If a coordinate variable with the same name was defined, that dataset
        is the scale; otherwise create a stub scale.
        """
        if name in self._f:
            ds = self._f[name]
            if "CLASS" not in ds.attrs:
                ds.make_scale(name)
        else:
            length = self._dims[name]
            if length is None:
                ds = self._f.create_dataset(
                    name, shape=(0,), maxshape=(None,), dtype=np.float32)
            else:
                ds = self._f.create_dataset(
                    name, shape=(length,), dtype=np.float32)
            # netcdf-c writes the sentinel as the scale NAME itself
            ds.make_scale((_DIM_WITHOUT_VAR + b" %10d" % ds.shape[0]
                           ).decode())
        return ds

    # -- variables -------------------------------------------------------
    def define_variable(self, name: str, dtype: str = "float",
                        *dims: str, deflate: Optional[int] = None,
                        chunks: Optional[Tuple[int, ...]] = None,
                        fill_value: Optional[float] = None):
        for d in dims:
            if d not in self._dims:
                raise ValueError(f"Dimension {d!r} not defined")
        # netcdf-c convention: a variable sharing a dimension's name that is
        # NOT its 1-D coordinate variable is stored as _nc4_non_coord_<name>
        store_name = name
        if name in self._dims and tuple(dims) != (name,):
            store_name = "_nc4_non_coord_" + name
        if store_name in self._f:
            raise ValueError(f"Variable {name!r} already defined")
        if dtype == "string":
            h5type: Any = _import_h5py().string_dtype("utf-8")
        else:
            h5type = _TYPE_MAP[dtype]
        shape = tuple(self._dims[d] if self._dims[d] is not None else 0
                      for d in dims)
        maxshape = tuple(self._dims[d] for d in dims)  # None => unlimited
        kwargs: Dict[str, Any] = {}
        level = self._deflate if deflate is None else deflate
        if level > 0 and shape and all(s > 0 for s in shape):
            kwargs["compression"] = "gzip"
            kwargs["compression_opts"] = level
            kwargs["shuffle"] = True
        if chunks is not None:
            kwargs["chunks"] = chunks
        elif any(m is None for m in maxshape) or "compression" in kwargs:
            kwargs["chunks"] = True
        if fill_value is not None:
            kwargs["fillvalue"] = fill_value
        ds = self._f.create_dataset(store_name, shape=shape,
                                    maxshape=maxshape, dtype=h5type, **kwargs)
        self._var_dims[store_name] = tuple(dims)
        # Scale attachment is deferred to close(): a coordinate variable may
        # be defined after variables that use its dimension, and HDF5 forbids
        # attaching scales to a dataset that is itself a scale.
        for axis, d in enumerate(dims):
            self._pending_attach.append((store_name, axis, d))
        return ds

    def _attach_scales(self):
        """Create/choose dimension-scale datasets and attach them.

        A 1-D variable whose single dimension shares its name becomes the
        coordinate variable (the netCDF convention); other dimensions get
        stub scales.  Self-attachment and scale-on-scale attachment are
        skipped (HDF5 restriction; netCDF tools resolve these by name).
        """
        is_coord = {}
        for dim in self._dims:
            is_coord[dim] = (dim in self._f
                             and self._var_dims.get(dim) == (dim,))
            if is_coord[dim]:
                self._f[dim].make_scale(dim)
        for var, axis, dim in self._pending_attach:
            if var == dim:
                continue
            if var in self._dims and is_coord.get(var):
                continue    # var is itself a scale; cannot attach to it
            scale = self._ensure_dim_dataset(dim)
            try:
                self._f[var].dims[axis].attach_scale(scale)
            except (RuntimeError, OSError):
                pass
        self._pending_attach = []

    def write(self, data: Any, name: str, index: Optional[int] = None):
        """Write data to a defined variable (or define-and-write a scalar).

        ``index`` writes one slice along the leading dimension, growing it if
        unlimited (the reference's per-concentration LUT writes and lw_spectra
        unlimited-column writes).
        """
        alt = "_nc4_non_coord_" + name
        if alt in self._f:
            name = alt
        if name not in self._f:
            # Auto-define scalars/strings for convenience
            if isinstance(data, str):
                self._f.create_dataset(name, data=np.bytes_(data))
                return
            arr = np.asarray(data)
            if arr.ndim == 0:
                self._f.create_dataset(name, data=arr)
                return
            raise ValueError(f"Variable {name!r} not defined")
        ds = self._f[name]
        if isinstance(data, str):
            ds[()] = data
            return
        arr = np.asarray(data)
        if index is None:
            if ds.shape == ():
                ds[()] = arr
            else:
                if any(m is None for m in ds.maxshape) and ds.shape != arr.shape:
                    ds.resize(arr.shape)
                ds[...] = arr
        else:
            if ds.maxshape[0] is None and ds.shape[0] <= index:
                ds.resize((index + 1,) + ds.shape[1:])
            ds[index, ...] = arr

    # -- attributes ------------------------------------------------------
    def write_attribute(self, value: Any, attr: str,
                        var: Optional[str] = None):
        if var is not None and var not in self._f \
                and "_nc4_non_coord_" + var in self._f:
            var = "_nc4_non_coord_" + var
        obj = self._f if var is None else self._f[var]
        if isinstance(value, str):
            obj.attrs[attr] = np.bytes_(value.encode("utf-8"))
        else:
            obj.attrs[attr] = value

    def write_units(self, units: str, var: str):
        self.write_attribute(units, "units", var)

    def write_long_name(self, long_name: str, var: str):
        self.write_attribute(long_name, "long_name", var)

    def write_comment(self, comment: str, var: str):
        self.write_attribute(comment, "comment", var)

    def append_history(self, argv: Sequence[str],
                       existing: Optional[str] = None):
        """Append 'timestamp: command line' to the global history attribute
        (ref OutputDataFile.cpp:1005-1048)."""
        from ..config import command_line_string
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S %z").strip()
        entry = f"{stamp}: {command_line_string(argv)}"
        prev = existing
        if prev is None:
            prev = self._global_attribute("history")
        history = f"{prev}\n{entry}" if prev else entry
        self.write_attribute(history, "history")

    def _global_attribute(self, attr: str) -> Any:
        if attr in self._f.attrs:
            return _decode(self._f.attrs[attr])
        return None

    def close(self):
        if self._pending_attach:
            self._attach_scales()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# The classic container (CDF-2) through scipy.io.netcdf_file
# ---------------------------------------------------------------------------

_CLASSIC_TYPES = {"double": "d", "float": "f", "int": "i", "short": "h",
                  "byte": "b"}
# The largest variable (or record) of CDF-2: 2^32 - 4 bytes.
_CDF2_MAX_BYTES = 2 ** 32 - 4
_deflate_noted = False


def _note_no_deflate():
    global _deflate_noted
    if not _deflate_noted:
        _deflate_noted = True
        logs.log("The classic NetCDF container has no compression: deflate "
                 "is not written (the values are the same)")


def _native(array) -> np.ndarray:
    """A copy of ``array`` in native byte order: classic files are
    big-endian, and a view would keep the file's memory map open."""
    array = np.asarray(array)
    return np.array(array, dtype=array.dtype.newbyteorder("="))


def _classic_value(value: Any) -> Any:
    """An attribute value as the classic container stores it: text as
    UTF-8 bytes, a Python float as a double (scipy would write a float),
    integers as int32 (CDF-2 has no 64-bit integer)."""
    if isinstance(value, str):
        return value.encode("utf-8")
    if isinstance(value, bytes):
        return value
    array = np.asarray(value)
    if array.dtype.kind in "iub":
        if array.size and (array.min() < np.iinfo(np.int32).min
                           or array.max() > np.iinfo(np.int32).max):
            raise OverflowError(f"attribute {value!r} does not fit the "
                                "classic container's 32-bit integers")
        array = array.astype(np.int32)
    elif array.dtype.kind == "f" and array.dtype.itemsize != 4:
        array = array.astype(np.float64)
    elif array.dtype.kind != "f":
        raise TypeError(f"attribute of type {array.dtype} has no classic "
                        "NetCDF type")
    return array.reshape(-1) if array.ndim else array


class _ClassicFile(NcFile):
    """A classic (CDF-1 or CDF-2) file read through ``scipy.io.netcdf_file``.
    Every array returned is a copy, so it outlives :meth:`close`."""

    def __init__(self, path: str):
        from scipy.io import netcdf_file
        self.path = path
        self._f = netcdf_file(path, "r", mmap=True)

    def exist(self, name: str) -> bool:
        return name in self._f.variables

    def size(self, name: str) -> Tuple[int, ...]:
        return tuple(self._f.variables[name].shape)

    def names(self) -> List[str]:
        return list(self._f.variables)

    def read(self, name: str, index: Optional[int] = None,
             index2: Optional[int] = None) -> np.ndarray:
        data = self._f.variables[name].data
        if data.shape == ():
            return _decode(_native(data)[()])
        if index is not None:
            data = data[index] if index2 is None else data[index, index2]
        if data.dtype.kind == "S":
            return _decode(data)
        return _native(data)

    def read_slice(self, name: str, index: Optional[int],
                   start: int, stop: int) -> np.ndarray:
        data = self._f.variables[name].data
        if index is not None:
            data = data[index]
        return _native(data[..., start:stop])

    def attribute(self, attr: str, var: Optional[str] = None,
                  default: Any = None) -> Any:
        obj = self._f if var is None else self._f.variables[var]
        if attr in obj._attributes:
            value = obj._attributes[attr]
            if isinstance(value, np.ndarray) and value.dtype.kind != "S":
                return _native(value)
            return _decode(value)
        return default

    def global_attributes(self) -> Dict[str, Any]:
        return {k: self.attribute(k) for k in self._f._attributes
                if not k.startswith("_")}


class _ClassicWriter(NcWriter):
    """A classic CDF-2 (64-bit offset) file written through
    ``scipy.io.netcdf_file``: the same calls as the NetCDF-4 writer, within
    the limits listed in the module docstring.  The data stays in memory
    until :meth:`close` writes the file."""

    def __init__(self, path: str, deflate_level: int = 0,
                 format: str = "classic"):
        from scipy.io import netcdf_file
        self.path = path
        self._f = netcdf_file(path, "w", version=2)
        self._dims: Dict[str, Optional[int]] = {}
        self._deflate = deflate_level
        if deflate_level > 0:
            _note_no_deflate()

    def define_dimension(self, name: str, length: Optional[int] = None):
        """Define a dimension; ``length=None`` means unlimited, of which the
        classic container has one."""
        if name in self._dims:
            return
        if length is None and None in self._dims.values():
            raise ValueError(
                f"Dimension {name!r}: the classic NetCDF container has one "
                "unlimited dimension (use netcdf_format=netcdf4)")
        self._f.createDimension(name, length)
        self._dims[name] = length

    def define_variable(self, name: str, dtype: str = "float",
                        *dims: str, deflate: Optional[int] = None,
                        chunks: Optional[Tuple[int, ...]] = None,
                        fill_value: Optional[float] = None):
        for d in dims:
            if d not in self._dims:
                raise ValueError(f"Dimension {d!r} not defined")
        if name in self._f.variables:
            raise ValueError(f"Variable {name!r} already defined")
        if dtype == "string":
            raise ValueError(
                f"Variable {name!r}: the classic NetCDF container has no "
                "string type (use netcdf_format=netcdf4)")
        typecode = _CLASSIC_TYPES[dtype]
        if any(self._dims[d] is None for d in dims[1:]):
            raise ValueError(
                f"Variable {name!r}: the unlimited dimension must be the "
                "first of a classic NetCDF variable")
        nbytes = np.dtype(typecode).itemsize * int(np.prod(
            [self._dims[d] for d in dims if self._dims[d] is not None]))
        if nbytes > _CDF2_MAX_BYTES:
            raise ValueError(
                f"Variable {name!r} holds {nbytes} bytes: the classic NetCDF "
                "container (CDF-2) caps a variable at 4 GiB (use "
                "netcdf_format=netcdf4)")
        if (self._deflate if deflate is None else deflate) > 0:
            _note_no_deflate()
        var = self._f.createVariable(name, typecode, dims)
        if not dims:
            # scipy writes variables in the order of their shapes, which
            # puts a scalar's () after the record variables, so that its
            # data lands in their first record; a (0,) shape puts it with
            # the fixed-size variables, and a scalar is never a record
            var.__dict__["_shape"] = (0,)
        # scipy leaves a new variable's memory as it finds it; HDF5 fills
        # with zeros (or the fill value) until written
        var.data[...] = 0 if fill_value is None else fill_value
        if fill_value is not None:
            var._attributes["_FillValue"] = np.asarray(
                [fill_value], var.data.dtype)
        return var

    def write(self, data: Any, name: str, index: Optional[int] = None):
        """As :meth:`NcWriter.write`; ``index`` past the last record grows
        the unlimited dimension, zero-filling any records skipped."""
        if name not in self._f.variables:
            if isinstance(data, str):
                raise ValueError(
                    f"Variable {name!r}: the classic NetCDF container has "
                    "no string type (use netcdf_format=netcdf4)")
            arr = np.asarray(data)
            if arr.ndim == 0:
                dtype = {"f": "double" if arr.dtype.itemsize == 8 else
                         "float"}.get(arr.dtype.kind, "int")
                self.define_variable(name, dtype)
                self._f.variables[name][()] = arr
                return
            raise ValueError(f"Variable {name!r} not defined")
        var = self._f.variables[name]
        arr = np.asarray(data)
        if var.data.shape == ():
            var[()] = arr
        elif var.isrec:
            # grown here, not by scipy, whose growth leaves the new records
            # as it finds them
            nrec = arr.shape[0] if index is None else index + 1
            old = var.data
            if nrec > old.shape[0]:
                grown = np.zeros((nrec,) + old.shape[1:], old.dtype)
                grown[:old.shape[0]] = old
                var.__dict__["data"] = grown
            var.data[slice(None, nrec) if index is None else index] = arr
        elif index is None:
            var[...] = arr
        else:
            var[index] = arr

    def write_attribute(self, value: Any, attr: str,
                        var: Optional[str] = None):
        obj = self._f if var is None else self._f.variables[var]
        obj._attributes[attr] = _classic_value(value)

    def _global_attribute(self, attr: str) -> Any:
        value = self._f._attributes.get(attr)
        return None if value is None else _decode(value)

    def close(self):
        self._f.close()


def write_standard_attributes(writer: NcWriter, title: str):
    """Write title/institution/conventions globals
    (ref src/ecckd/write_standard_attributes.h)."""
    writer.write_attribute("CF-1.7", "Conventions")
    writer.write_attribute(title, "title")
    writer.write_attribute("ecckd_tpu gas-optics toolkit", "source")
