"""NetCDF input and output of the port's tools: its own copy of
``ecckd_tpu/io`` (``ncio``, ``order``, ``spectrum``), without the ``.spbin``
shard reader.  Importing it imports h5py, so the tools import it only inside
their file functions."""

from .ncio import NcFile, NcWriter, write_standard_attributes
from .spectrum import Spectrum, read_spectrum, read_merged_spectrum
from .order import SpectralOrder, read_order, write_order
