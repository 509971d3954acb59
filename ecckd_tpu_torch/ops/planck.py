"""Planck function integrated over wavenumber intervals.

PyTorch counterpart of ``ecckd_tpu/ops/planck.py``
(ref planck_function.cpp:21-54).
"""

from __future__ import annotations

import torch

from ..constants import BOLTZMANN_K, PI, PLANCK_H, SPEED_OF_LIGHT


def planck_function(temperature, wavenumber_cm_1, d_wavenumber_cm_1):
    """Planck irradiance integrated over each wavenumber interval, W m-2.

    Args:
      temperature: (..., nt) temperatures in K.
      wavenumber_cm_1, d_wavenumber_cm_1: (nwav,) tensors, cm-1.

    Returns:
      (..., nt, nwav) tensor on the device of ``wavenumber_cm_1``.
    """
    h, c, k = PLANCK_H, SPEED_OF_LIGHT, BOLTZMANN_K
    inv_cm_2_hz = 100.0 * c
    freq = wavenumber_cm_1 * inv_cm_2_hz
    prefactor = (d_wavenumber_cm_1 * (2.0 * h * inv_cm_2_hz * PI / (c * c))
                 * freq * freq * freq)
    t = torch.as_tensor(temperature, dtype=freq.dtype,
                        device=freq.device)[..., None]
    return prefactor / torch.expm1((h / k) * (freq / t))
