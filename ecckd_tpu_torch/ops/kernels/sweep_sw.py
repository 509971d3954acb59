"""Kernel K2: the SW broadband sweep with per-interval flux sums.

Wrapper of ``csrc/sweep_sw.cu`` (CUDA C++ for sm_90a), which replaces the
Pallas TPU kernel ``ecckd_tpu/ops/pallas/sweep_sw.py``.  For tensors on the
CPU the wrapper runs the plain version :func:`sweep_sw_plain`; for CUDA
tensors it launches the kernel (:func:`.interval_stream.launch_sweep`) or
raises.
"""

from __future__ import annotations

import torch

from ..rt_sw import rt_sw_bb_intervals
from .interval_stream import check_tensor, launch_sweep


def sweep_sw_plain(ssi, bg_od, od_fit, seg_of_wav, i1, i2, cos_sza, albedo,
                   with_upwelling):
    """Plain PyTorch version of K2: gather each wavenumber's fitted od
    (none for a segment outside [0, nseg)) and run
    :func:`~ecckd_tpu_torch.ops.rt_sw.rt_sw_bb_intervals`."""
    nseg = od_fit.shape[1]
    seg = seg_of_wav.long()
    has_fit = (seg >= 0) & (seg < nseg)
    grey = torch.where(has_fit[None, :], od_fit[:, seg.clamp(0, nseg - 1)],
                       0.0)
    return rt_sw_bb_intervals(cos_sza, ssi, bg_od, grey, albedo, i1, i2,
                              with_upwelling=with_upwelling)


def sweep_sw_intervals(ssi, bg_od, od_fit, seg_of_wav, i1, i2, cos_sza,
                       albedo, with_upwelling):
    """Per-interval broadband SW fluxes.

    Args:
      ssi: (nwav,) solar irradiance; bg_od: (nlay, nwav);
      od_fit: (nlay, nseg) fitted od per interval;
      seg_of_wav: (nwav,) int32, the interval whose fit each wavenumber
        carries (outside [0, nseg): no fitted od);
      i1, i2: (nseg,) int32 inclusive interval bounds; a wavenumber's flux
        counts towards every interval that holds it;
      cos_sza: float; albedo: float or (nwav,) surface albedo;
      with_upwelling: bool, whether to run the reflected beam.

    Returns:
      (flux_dn, flux_up), each (nlay+1, nseg); flux_up is zeros without
      upwelling.
    """
    if ssi.device.type == "cpu":
        return sweep_sw_plain(ssi, bg_od, od_fit, seg_of_wav, i1, i2,
                              cos_sza, albedo, with_upwelling)
    if ssi.device.type != "cuda":
        raise ValueError(f"sweep_sw: no kernel for device {ssi.device}")
    dtype = ssi.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sweep_sw: unsupported dtype {dtype}")
    nlay, n = bg_od.shape
    if nlay < 1:
        raise ValueError(f"sweep_sw: {nlay} layers; the kernel takes 1 or "
                         "more")
    nlev1 = nlay + 1
    nseg = i1.shape[0]
    dev = ssi.device
    if not isinstance(albedo, torch.Tensor) or albedo.ndim == 0:
        albedo = torch.full((n,), float(albedo), dtype=dtype, device=dev)
    for name, t, want_dtype, shape in (
            ("ssi", ssi, dtype, (n,)), ("bg_od", bg_od, dtype, (nlay, n)),
            ("od_fit", od_fit, dtype, (nlay, nseg)),
            ("seg_of_wav", seg_of_wav, torch.int32, (n,)),
            ("i1", i1, torch.int32, (nseg,)), ("i2", i2, torch.int32, (nseg,)),
            ("albedo", albedo, dtype, (n,))):
        check_tensor("sweep_sw", name, t, want_dtype, shape, dev)
    out = launch_sweep("sweep_sw", "ecckd_sweep_sw",
                       (ssi, bg_od, od_fit, seg_of_wav, albedo), i1, i2,
                       (2 if with_upwelling else 1) * nlev1, nlay,
                       (float(cos_sza), int(bool(with_upwelling))))
    sweep_sw_intervals.launches += 1
    sweep_sw_intervals.upwelling_launches += bool(with_upwelling)
    if not with_upwelling:
        return out, torch.zeros_like(out)
    return out[:nlev1], out[nlev1:]


sweep_sw_intervals.launches = 0
#: Launches with the reflected beam, a subset of ``launches``
sweep_sw_intervals.upwelling_launches = 0
