"""Kernel K1: the LW broadband sweep with per-interval flux sums.

Wrapper of ``csrc/sweep_lw.cu`` (CUDA C++ for sm_90a), which replaces the
Pallas TPU kernel ``ecckd_tpu/ops/pallas/sweep_lw.py``.  For tensors on the
CPU the wrapper runs the plain version :func:`sweep_lw_plain`; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..rt_lw import rt_lw_bb_intervals
from . import _build


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


def _check(kernel, name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and
    ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


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
    out = launch_lw("sweep_lw", "ecckd_sweep_lw", planck_hl, bg_od, od_fit,
                    seg_of_wav, surf_emissivity, surf_planck, i1, i2)
    sweep_lw_intervals.launches += 1
    return out


def launch_lw(kernel, entry, planck_hl, bg_od, od_fit, seg_of_wav,
              surf_emissivity, surf_planck, i1, i2):
    """Check the arguments of a LW sweep kernel (K1, E1), launch the entry
    point ``entry`` + ``_f64`` or ``_f32`` on the current stream and return
    (flux_dn, flux_up)."""
    if planck_hl.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {planck_hl.device}")
    dtype = planck_hl.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel}: unsupported dtype {dtype}")
    nlev1, n = planck_hl.shape
    nlay = nlev1 - 1
    nseg = i1.shape[0]
    dev = planck_hl.device
    _check(kernel, "planck_hl", planck_hl, dtype, (nlev1, n), dev)
    _check(kernel, "bg_od", bg_od, dtype, (nlay, n), dev)
    _check(kernel, "od_fit", od_fit, dtype, (nlay, nseg), dev)
    _check(kernel, "seg_of_wav", seg_of_wav, torch.int32, (n,), dev)
    _check(kernel, "surf_emissivity", surf_emissivity, dtype, (n,), dev)
    _check(kernel, "surf_planck", surf_planck, dtype, (n,), dev)
    _check(kernel, "i1", i1, torch.int32, (nseg,), dev)
    _check(kernel, "i2", i2, torch.int32, (nseg,), dev)
    lib = _build.library()
    nblocks = -(-n // lib.ecckd_chunk_size())
    out = torch.empty((2 * nlev1, nseg), dtype=dtype, device=dev)
    partial = torch.empty(max(1, nblocks * 2 * nlev1 * nseg), dtype=dtype,
                          device=dev)
    fn = getattr(lib, entry + ("_f64" if dtype == torch.float64 else "_f32"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(planck_hl.data_ptr(), bg_od.data_ptr(), od_fit.data_ptr(),
                 seg_of_wav.data_ptr(), surf_emissivity.data_ptr(),
                 surf_planck.data_ptr(), i1.data_ptr(), i2.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), nlay, n, nseg, stream)
    _build.check(err, kernel)
    return out[:nlev1], out[nlev1:]


sweep_lw_intervals.launches = 0
