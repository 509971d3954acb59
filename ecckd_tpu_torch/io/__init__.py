"""NetCDF input and output of the port's tools: its own copy of
``ecckd_tpu/io`` (``ncio``, ``order``, ``spectrum``, ``lbl_fluxes``),
without the ``.spbin`` shard reader.  The file modules import h5py, so this
package loads them only when one of their names is first used, and the
tools use them only inside their file functions; ``lbl_fluxes`` needs
h5py only to read a file."""

import importlib

_EXPORTS = {
    "NcFile": "ncio", "NcWriter": "ncio", "write_standard_attributes": "ncio",
    "Spectrum": "spectrum", "read_spectrum": "spectrum",
    "read_merged_spectrum": "spectrum",
    "SpectralOrder": "order", "read_order": "order", "write_order": "order",
    "LblFluxes": "lbl_fluxes",
}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__),
                    name)
    globals()[name] = value
    return value
