"""Rayleigh molar scattering coefficient, Bucholtz (1995) model.

Counterpart of ``ecckd_tpu/ops/rayleigh.py``
(ref rayleigh_scattering.h:23-43), on numpy or torch input.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import AVOGADRO_CONSTANT


def rayleigh_molar_scattering_coeff(wavenumber_cm_1):
    """Rayleigh molar scattering coefficient (m2 mol-1) versus wavenumber
    (cm-1); a tensor in gives a tensor out, anything else a numpy array."""
    if isinstance(wavenumber_cm_1, torch.Tensor):
        where = torch.where
    else:
        wavenumber_cm_1 = np.asarray(wavenumber_cm_1, np.float64)
        where = np.where
    wavelength_um = 10000.0 / wavenumber_cm_1
    short = 3.01577e-32 * wavelength_um ** -(
        3.55212 + 1.35579 * wavelength_um + 0.11563 / wavelength_um)
    long_ = 4.01061e-32 * wavelength_um ** -(
        3.99668 + 0.00110298 * wavelength_um + 0.0271393 / wavelength_um)
    return where(wavelength_um < 0.5, short, long_) * AVOGADRO_CONSTANT
