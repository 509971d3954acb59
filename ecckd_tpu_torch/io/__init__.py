"""File input and output of the port's tools: its own copy of
``ecckd_tpu/io`` (``ncio``, ``order``, ``spectrum``, ``lbl_fluxes``, and the
``.spbin`` shards: ``shards``, ``native``, ``prefetch``).  The NetCDF
modules import h5py, so this package loads its modules only when one of
their names is first used, and the tools use them only inside their file
functions; ``spectrum`` and ``lbl_fluxes`` need h5py only to read a NetCDF
file, and a shard needs none."""

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
