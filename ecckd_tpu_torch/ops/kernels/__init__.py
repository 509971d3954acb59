"""Python wrappers of the hand-written Hopper kernels in ``csrc/``.

Each wrapper checks its inputs, launches its kernel on the current CUDA
stream and counts the launch in its ``launches`` attribute; for tensors on
the CPU it runs the kernel's plain PyTorch version instead.
"""

from .sweep_lw import sweep_lw_intervals, sweep_lw_plain
from .sweep_sw import sweep_sw_intervals, sweep_sw_plain
from .interval_sum import fused_interval_sum
from .sweep_lw_scan import sweep_lw_scan_intervals, sweep_lw_scan_plain
from .fused_sums_lw import fused_sums_lw_intervals, fused_sums_lw_plain
from .segment_minmax import segment_min_max

KERNELS = (sweep_lw_intervals, sweep_sw_intervals, fused_interval_sum,
           sweep_lw_scan_intervals, fused_sums_lw_intervals, segment_min_max)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
    sweep_sw_intervals.upwelling_launches = 0
