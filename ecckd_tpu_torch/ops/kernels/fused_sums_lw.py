"""Kernel E2: the interval sums of the LW candidate cost in one pass.

Wrapper of ``csrc/fused_sums_lw.cu`` (CUDA C++ for sm_90a), which replaces
the Pallas TPU kernel ``scripts/exp_kernels.py:fused_sums_pallas`` (body
``_isum_kernel``): K3 specialised to the LW fit numerator and denominator,
the truth heating rates and the two boundary fluxes.  For tensors on the
CPU the wrapper runs the plain version :func:`fused_sums_lw_plain`; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..segments import interval_sum_fused
from . import _build
from .interval_stream import (check_buffers, check_library, check_tensor,
                              device_table)


def fused_sums_lw_plain(metric, planck_hl, hr, fd_surf, fu_toa, i1, i2):
    """Plain PyTorch version of E2, the rows of ``_isum_kernel`` (metric *
    planck[1:], planck[1:], hr, fd_surf, fu_toa) stacked per wavenumber
    tile and summed over each [i1, i2] by a 0/1 membership matmul."""
    def rows(start, size):
        sl = lambda a: a.narrow(a.ndim - 1, start, size)
        w_num = sl(planck_hl)[1:]
        return torch.cat([sl(metric) * w_num, w_num, sl(hr),
                          sl(fd_surf)[None, :], sl(fu_toa)[None, :]])

    return interval_sum_fused([rows], metric.shape[-1], i1, i2,
                              dtype=metric.dtype)


def fused_sums_lw_intervals(metric, planck_hl, hr, fd_surf, fu_toa, i1, i2):
    """Interval sums of the LW transmission fit and truth rows.

    Args:
      metric, hr: (nlay, nwav); planck_hl: (nlay+1, nwav);
      fd_surf, fu_toa: (nwav,);
      i1, i2: (nseg,) int32 inclusive interval bounds.

    Returns:
      (3*nlay+2, nseg): sums of metric * planck_hl[1:], planck_hl[1:] and
      hr (nlay rows each), then of fd_surf and fu_toa.
    """
    if metric.device.type == "cpu":
        return fused_sums_lw_plain(metric, planck_hl, hr, fd_surf, fu_toa,
                                   i1, i2)
    if metric.device.type != "cuda":
        raise ValueError(f"fused_sums_lw: no kernel for device "
                         f"{metric.device}")
    dtype = metric.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_sums_lw: unsupported dtype {dtype}")
    nlay, n = metric.shape
    nseg = i1.shape[0]
    dev = metric.device
    for name, t, want_dtype, shape in (
            ("metric", metric, dtype, (nlay, n)),
            ("planck_hl", planck_hl, dtype, (nlay + 1, n)),
            ("hr", hr, dtype, (nlay, n)), ("fd_surf", fd_surf, dtype, (n,)),
            ("fu_toa", fu_toa, dtype, (n,)),
            ("i1", i1, torch.int32, (nseg,)),
            ("i2", i2, torch.int32, (nseg,))):
        check_tensor("fused_sums_lw", name, t, want_dtype, shape, dev)
    lib = _build.library()
    check_library(lib)
    nrows = 3 * nlay + 2
    fn = (lib.ecckd_fused_sums_lw_f64 if dtype == torch.float64
          else lib.ecckd_fused_sums_lw_f32)
    with torch.cuda.device(dev):
        table_d, tab = device_table(i1, i2, n, dev)
        out = torch.empty((nrows, nseg), dtype=dtype, device=dev)
        partial = torch.empty(max(1, tab.nentries * nrows), dtype=dtype,
                              device=dev)
        if _build.checked_mode():
            check_buffers("fused_sums_lw", table_d, tab, nseg, nrows,
                          partial, out)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(metric.data_ptr(), planck_hl.data_ptr(), hr.data_ptr(),
                 fd_surf.data_ptr(), fu_toa.data_ptr(), table_d.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), nlay, n, nseg,
                 tab.nentries, tab.cmax, stream)
    _build.check(err, "fused_sums_lw")
    fused_sums_lw_intervals.launches += 1
    return out


fused_sums_lw_intervals.launches = 0
