from .gas_optics import (ConcDependence, LutInterpolation, calc_optical_depth,
                         lut_interpolation, planck_from_lut,
                         rayleigh_optical_depth, temperature_fl_from_hl)
from .ckd_model import CkdModel, GasData
