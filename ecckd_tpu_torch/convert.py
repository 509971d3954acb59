"""Carry state from host arrays into the port.

The state of a band is the set of arrays a candidate-cost kernel binds.
:func:`lw_band_state` and :func:`sw_band_state` turn the numpy arrays (the
same ones the JAX package's ``CandidateCostLw`` and ``CandidateCostSw``
take) into tensors on one device, so both packages can be bound to
identical inputs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: Array arguments of ``CandidateCostLw.__init__`` in both packages
#: (ecckd_tpu/partition/cost_kernel.py:316-322).
LW_BAND_ARRAYS = ("layer_weight", "pressure_hl", "surf_emissivity",
                  "surf_planck", "flux_dn_surf", "flux_up_toa", "planck_hl",
                  "bg_od", "metric", "hr")


def lw_band_state(arrays: Dict[str, np.ndarray], device,
                  dtype) -> Dict[str, torch.Tensor]:
    """Contiguous ``dtype`` tensors on ``device`` for every LW band array.

    ``arrays`` must hold exactly the keys of :data:`LW_BAND_ARRAYS`; each
    is copied, so read-only and broadcast numpy views (e.g. lazy zeros)
    are fine."""
    missing = set(LW_BAND_ARRAYS) - set(arrays)
    extra = set(arrays) - set(LW_BAND_ARRAYS)
    if missing or extra:
        raise KeyError(f"lw_band_state: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    return {k: torch.tensor(np.asarray(arrays[k]), dtype=dtype,
                            device=device).contiguous()
            for k in LW_BAND_ARRAYS}


#: Array arguments of ``CandidateCostSw.__init__`` in both packages
#: (ecckd_tpu/partition/cost_kernel.py:440-443); ``surf_albedo`` may be a
#: scalar.
SW_BAND_ARRAYS = ("layer_weight", "pressure_hl", "ssi", "surf_albedo",
                  "flux_dn_surf", "flux_up_toa", "bg_od", "metric", "hr")


def sw_band_state(arrays: Dict[str, np.ndarray], extras, device,
                  dtype) -> Dict[str, object]:
    """Keyword arguments of :class:`~ecckd_tpu_torch.partition.
    CandidateCostSw` besides the method, flux weight and cos_sza.

    ``arrays`` must hold exactly the keys of :data:`SW_BAND_ARRAYS`;
    ``extras`` is the JAX kernel's dict of the total-transmission truth
    arrays and its scalar ``min_scaling``/``max_scaling``, or None.  Arrays
    become contiguous ``dtype`` tensors on ``device`` (a scalar albedo
    becomes a vector); the scalars stay floats."""
    missing = set(SW_BAND_ARRAYS) - set(arrays)
    extra = set(arrays) - set(SW_BAND_ARRAYS)
    if missing or extra:
        raise KeyError(f"sw_band_state: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    nwav = np.shape(arrays["ssi"])[-1]
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype,
                                  device=device).contiguous()
    state = {k: as_t(arrays[k]) for k in SW_BAND_ARRAYS}
    state["surf_albedo"] = as_t(np.broadcast_to(arrays["surf_albedo"],
                                                (nwav,)))
    state["extras"] = None if extras is None else {
        k: float(v) if np.ndim(v) == 0 else as_t(v)
        for k, v in extras.items()}
    return state
