"""Meshes of logical shards, their collectives and the sharded averaging
(counterpart of ``ecckd_tpu/parallel``)."""

from .mesh import (Mesh, make_mesh, pad_to_multiple, profile_slices,
                   slice_wavenumbers, spectral_slices)
from .sharded_average import (
    sharded_average_od_to_gpoints, sharded_average_od_to_gpoints_multihost,
    streaming_sharded_average_od_to_gpoints,
    streaming_sharded_average_od_to_gpoints_multihost)
