"""Physical constants shared across the framework.

Values match the reference ecCKD so generated models are numerically
comparable (ref: src/ecckd/constants.h:21-26, src/ecckd/planck_function.cpp:28-33,
src/ecckd/calc_cost_function_sw.h:20).

The port's own copy of ``ecckd_tpu/constants.py``: the port imports nothing
of the JAX package.
"""

# Name used for molar absorption coefficient variables in ckd-definition files
K_NAME = "molar_absorption_coeff"

ACCEL_GRAVITY = 9.80665          # m s-2
SPECIFIC_HEAT_AIR = 1004.0       # J kg-1 K-1
LW_DIFFUSIVITY = 1.66            # longwave two-stream diffusivity factor
MOLAR_MASS_DRY_AIR = 28.970      # g mol-1
AVOGADRO_CONSTANT = 6.02214076e23  # mol-1

# Planck-function constants (ref: planck_function.cpp:28-33)
PLANCK_H = 6.62606896e-34        # J s
SPEED_OF_LIGHT = 2.99792458e8    # m s-1
BOLTZMANN_K = 1.3806504e-23      # J K-1
PI = 3.14159265358979323846

# Heating-rate error weight: converts K s-1 to K day-1 in cost functions
# (ref: calc_cost_function_lw.cpp:40)
HR_WEIGHT = 3600.0 * 24.0

# Reference cosine of solar zenith angle used for per-g-point Rayleigh
# coefficients and run_ckd SW evaluation (ref: calc_cost_function_sw.h:20)
REFERENCE_COS_SZA = 0.5

# Negative of secant of the SW two-stream zenith angle, Zdunkowski (1980)
# (ref: radiative_transfer_sw.cpp:70)
SW_DIFFUSE_SECANT = 2.0

# Moles of dry air per m2 per Pa of pressure thickness:
# 1 / (g * 0.001 * M_air)  [mol m-2 Pa-1]
MOLES_PER_PA = 1.0 / (ACCEL_GRAVITY * 0.001 * MOLAR_MASS_DRY_AIR)
