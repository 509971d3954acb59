from .equipartition import Equipartition, EpStatus, ep_stats
from .gas_data import SingleGasData, merged_g_point_map, overlap_g_points
from .cost_kernel import CandidateCostLw, CandidateCostSw, CkdEquipartition
