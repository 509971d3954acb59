from .._shared import equipartition as _ep, gas_data as _gd
from .cost_kernel import CandidateCostLw, CandidateCostSw, CkdEquipartition

Equipartition = _ep.Equipartition
SingleGasData = _gd.SingleGasData
overlap_g_points = _gd.overlap_g_points
merged_g_point_map = _gd.merged_g_point_map
