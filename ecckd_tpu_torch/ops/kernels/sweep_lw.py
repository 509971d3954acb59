"""Kernel K1: the LW broadband sweep with per-interval flux sums.

Wrapper of ``csrc/sweep_lw.cu`` (CUDA C++ for sm_90a), which replaces the
Pallas TPU kernel ``ecckd_tpu/ops/pallas/sweep_lw.py``.  For tensors on the
CPU the wrapper runs the plain version :func:`sweep_lw_plain`; for CUDA
tensors it launches the kernel (:func:`.interval_stream.launch_sweep`) or
raises.
"""

from __future__ import annotations

import torch

from ..rt_lw import rt_lw_bb_intervals
from .interval_stream import check_tensor, launch_sweep


def sweep_lw_plain(planck_hl, bg_od, od_fit, seg_of_wav, surf_emissivity,
                   surf_planck, i1, i2):
    """Plain PyTorch version of K1: gather each wavenumber's fitted od
    (none for a segment outside [0, nseg)) and run
    :func:`~ecckd_tpu_torch.ops.rt_lw.rt_lw_bb_intervals`."""
    nseg = od_fit.shape[1]
    seg = seg_of_wav.long()
    has_fit = (seg >= 0) & (seg < nseg)
    grey = torch.where(has_fit[None, :], od_fit[:, seg.clamp(0, nseg - 1)],
                       0.0)
    return rt_lw_bb_intervals(planck_hl, bg_od, grey, surf_emissivity,
                              surf_planck, i1, i2)


def check_lw(kernel, planck_hl, bg_od, od_fit, seg_of_wav, surf_emissivity,
             surf_planck, i1, i2):
    """Raise unless the arguments are what a LW sweep kernel (K1, E1)
    takes; return (nlay, n, nseg)."""
    if planck_hl.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {planck_hl.device}")
    dtype = planck_hl.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel}: unsupported dtype {dtype}")
    nlev1, n = planck_hl.shape
    nlay = nlev1 - 1
    if nlay < 1:
        raise ValueError(f"{kernel}: {nlay} layers; the kernel takes 1 or "
                         "more")
    nseg = i1.shape[0]
    dev = planck_hl.device
    check_tensor(kernel, "planck_hl", planck_hl, dtype, (nlev1, n), dev)
    check_tensor(kernel, "bg_od", bg_od, dtype, (nlay, n), dev)
    check_tensor(kernel, "od_fit", od_fit, dtype, (nlay, nseg), dev)
    check_tensor(kernel, "seg_of_wav", seg_of_wav, torch.int32, (n,), dev)
    check_tensor(kernel, "surf_emissivity", surf_emissivity, dtype, (n,),
                 dev)
    check_tensor(kernel, "surf_planck", surf_planck, dtype, (n,), dev)
    check_tensor(kernel, "i1", i1, torch.int32, (nseg,), dev)
    check_tensor(kernel, "i2", i2, torch.int32, (nseg,), dev)
    return nlay, n, nseg


def sweep_lw_intervals(planck_hl, bg_od, od_fit, seg_of_wav,
                       surf_emissivity, surf_planck, i1, i2):
    """Per-interval broadband LW fluxes.

    Args:
      planck_hl: (nlay+1, nwav); bg_od: (nlay, nwav);
      od_fit: (nlay, nseg) fitted od per interval;
      seg_of_wav: (nwav,) int32, the interval whose fit each wavenumber
        carries (outside [0, nseg): no fitted od);
      surf_emissivity, surf_planck: (nwav,);
      i1, i2: (nseg,) int32 inclusive interval bounds; a wavenumber's flux
        counts towards every interval that holds it.

    Returns:
      (flux_dn, flux_up), each (nlay+1, nseg).
    """
    if planck_hl.device.type == "cpu":
        return sweep_lw_plain(planck_hl, bg_od, od_fit, seg_of_wav,
                              surf_emissivity, surf_planck, i1, i2)
    nlay, _, _ = check_lw("sweep_lw", planck_hl, bg_od, od_fit, seg_of_wav,
                          surf_emissivity, surf_planck, i1, i2)
    out = launch_sweep("sweep_lw", "ecckd_sweep_lw",
                       (planck_hl, bg_od, od_fit, seg_of_wav,
                        surf_emissivity, surf_planck), i1, i2,
                       2 * (nlay + 1), nlay)
    sweep_lw_intervals.launches += 1
    return out[:nlay + 1], out[nlay + 1:]


sweep_lw_intervals.launches = 0
