from .planck import planck_function
from .heating_rate import heating_rate
from .rt_lw import rt_lw, rt_lw_bb_intervals
from .rt_sw import rt_direct_sw, rt_norayleigh_sw, rt_sw_bb_intervals
from .rayleigh import rayleigh_molar_scattering_coeff
from .segments import (interval_sum, interval_sum_fused, interval_count,
                       gpoint_onehot, part_of)
from .average import (fit_optical_depth_lw, fit_optical_depth_sw,
                      fit_optical_depth_sw_total_trans, od_to_molar_abs)
from .streaming import average_od_to_gpoints
