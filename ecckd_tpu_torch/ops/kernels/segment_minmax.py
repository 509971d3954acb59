"""Kernel K4: the per-(layer, g-point) least and largest od of a block.

Wrapper of ``csrc/segment_minmax.cu`` (CUDA C++ for sm_90a), which takes
the place of ``jax.ops.segment_min`` / ``segment_max`` in
``ecckd_tpu/ops/average.py:gpoint_block_partials``; no Pallas kernel.  For
tensors on the CPU the wrapper runs the plain version
:func:`ecckd_tpu_torch.ops.average._segment_min_max` (two
``scatter_reduce`` calls); for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build
from .interval_stream import check_tensor


def segment_min_max(ng, g_point, od):
    """Per-(layer, g) min and max of ``od`` over the wavenumbers of each
    g-point: ``(min, max)``, each (nz, ng) in ``od``'s dtype.

    Args:
      ng: number of g-points; a g-point below 0 is unassigned and skipped,
        and a segment with no member keeps +inf (min) / -inf (max).
      g_point: (nb,) integer tensor on ``od``'s device (taken as int64).
      od: (nz, nb) float64 or float32, C-contiguous on the card.
    """
    dev = od.device
    if dev.type == "cpu":
        from ..average import _segment_min_max
        return _segment_min_max(ng, g_point, od)
    if dev.type != "cuda":
        raise ValueError(f"segment_minmax: no kernel for device {dev}")
    dtype = od.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segment_minmax: unsupported dtype {dtype}")
    if od.ndim != 2:
        raise ValueError(f"segment_minmax: od must be (nz, nb), not "
                         f"{tuple(od.shape)}")
    nz, nb = od.shape
    check_tensor("segment_minmax", "od", od, dtype, (nz, nb), dev)
    g_point = g_point.to(torch.int64).contiguous()
    check_tensor("segment_minmax", "g_point", g_point, torch.int64, (nb,),
                 dev)
    out = torch.empty((2, nz, ng), dtype=dtype, device=dev)
    if nz * ng == 0:
        return out[0], out[1]
    lib = _build.library()
    aligned = (od.data_ptr() % 16 == 0 and g_point.data_ptr() % 16 == 0
               and nb % (16 // od.element_size()) == 0)
    fn = (lib.ecckd_segment_minmax_f64 if dtype == torch.float64
          else lib.ecckd_segment_minmax_f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(od.data_ptr(), g_point.data_ptr(), out.data_ptr(), nz, nb,
                 ng, int(aligned), stream)
    _build.check(err, "segment_minmax")
    segment_min_max.launches += 1
    return out[0], out[1]


segment_min_max.launches = 0
