"""Kernel E1: the LW broadband sweep as affine scans across layers.

Wrapper of ``csrc/sweep_lw_scan.cu`` (CUDA C++ for sm_90a), which replaces
the Pallas TPU kernel ``scripts/exp_kernels.py:rt_lw_bb_intervals_scan``
(body ``_sweep_scan_kernel``), the round-5 experiment that computes K1's
function with the layer recurrences written as doubling scans.  For tensors
on the CPU the wrapper runs the plain version :func:`sweep_lw_scan_plain`;
for CUDA tensors it launches the kernel (:func:`.interval_stream.
launch_sweep`, on strips of ``ecckd_scan_strip_size()`` wavenumbers) or
raises.
"""

from __future__ import annotations

import torch

from ..rt_lw import _emissivity_factor_bb
from ..segments import interval_sum_fused
from . import _build
from .interval_stream import launch_sweep
from .sweep_lw import check_lw


def _affine_scan_down(a, b):
    """Inclusive prefix composition of the maps x -> a[i] x + b[i] along
    axis 0 by doubling: row i becomes f_i o ... o f_0."""
    s = 1
    while s < a.shape[0]:
        ash = torch.cat([torch.ones_like(a[:s]), a[:-s]])
        bsh = torch.cat([torch.zeros_like(b[:s]), b[:-s]])
        b = b + a * bsh
        a = a * ash
        s *= 2
    return a, b


def _affine_scan_up(a, b):
    """Suffix composition by doubling: row i becomes f_i o ... o f_last."""
    s = 1
    while s < a.shape[0]:
        ash = torch.cat([a[s:], torch.ones_like(a[:s])])
        bsh = torch.cat([b[s:], torch.zeros_like(b[:s])])
        b = a * bsh + b
        a = a * ash
        s *= 2
    return a, b


def sweep_lw_scan_plain(planck_hl, bg_od, od_fit, seg_of_wav,
                        surf_emissivity, surf_planck, i1, i2):
    """Plain PyTorch version of E1, what ``_sweep_scan_kernel`` computes:
    the grey od of interval ``seg_of_wav`` (none outside [0, nseg)), the
    layers padded to a power of two with identity maps, the downward fluxes
    as the inclusive prefix compositions of the affine layer maps applied to
    0, the upward ones as the suffix compositions applied to the surface
    boundary, and every flux level summed over each [i1, i2].  The
    emissivity is ``-expm1``, not the TPU kernel's ``1 - exp``."""
    nlay, n = bg_od.shape
    nseg = od_fit.shape[1]
    npad = 1 << (nlay - 1).bit_length()
    seg = seg_of_wav.long()
    has_fit = (seg >= 0) & (seg < nseg)
    seg = seg.clamp(0, nseg - 1)

    def levels(start, size):
        sl = lambda a: a.narrow(a.ndim - 1, start, size)
        od = sl(bg_od) + torch.where(sl(has_fit)[None, :],
                                     od_fit[:, sl(seg)], 0.0)
        emissivity, factor = _emissivity_factor_bb(od)
        trans = 1.0 - emissivity
        coeff_top = emissivity - factor
        p = sl(planck_hl)
        src_dn = p[:-1] * coeff_top + p[1:] * factor
        src_up = p[1:] * coeff_top + p[:-1] * factor
        ident_a = torch.ones((npad - nlay, size), dtype=od.dtype,
                             device=od.device)
        ident_b = torch.zeros_like(ident_a)
        a0 = torch.cat([trans, ident_a])
        _, b_dn = _affine_scan_down(a0, torch.cat([src_dn, ident_b]))
        dn = torch.cat([torch.zeros_like(b_dn[:1]), b_dn[:nlay]])
        a_up, b_up = _affine_scan_up(a0, torch.cat([src_up, ident_b]))
        emis = sl(surf_emissivity)
        boundary = sl(surf_planck) * emis + (1.0 - emis) * dn[nlay]
        up = torch.cat([a_up[:nlay] * boundary + b_up[:nlay],
                        boundary[None, :]])
        return torch.cat([dn, up])

    sums = interval_sum_fused([levels], n, i1, i2, dtype=planck_hl.dtype)
    return sums[:nlay + 1], sums[nlay + 1:]


def sweep_lw_scan_intervals(planck_hl, bg_od, od_fit, seg_of_wav,
                            surf_emissivity, surf_planck, i1, i2):
    """Per-interval broadband LW fluxes, K1's function
    (:func:`~ecckd_tpu_torch.ops.kernels.sweep_lw.sweep_lw_intervals`, same
    arguments and outputs) by scans across layers.  The kernel takes 1 to
    128 layers."""
    if planck_hl.device.type == "cpu":
        return sweep_lw_scan_plain(planck_hl, bg_od, od_fit, seg_of_wav,
                                   surf_emissivity, surf_planck, i1, i2)
    nlay, _, _ = check_lw("sweep_lw_scan", planck_hl, bg_od, od_fit,
                          seg_of_wav, surf_emissivity, surf_planck, i1, i2)
    lib = _build.library()
    most = lib.ecckd_scan_max_layers()
    if not 1 <= nlay <= most:
        raise ValueError(f"sweep_lw_scan: {nlay} layers; the kernel takes 1 "
                         f"to {most}")
    out = launch_sweep("sweep_lw_scan", "ecckd_sweep_lw_scan",
                       (planck_hl, bg_od, od_fit, seg_of_wav, surf_emissivity,
                        surf_planck), i1, i2, 2 * (nlay + 1), nlay,
                       strip=lib.ecckd_scan_strip_size())
    sweep_lw_scan_intervals.launches += 1
    return out[:nlay + 1], out[nlay + 1:]


sweep_lw_scan_intervals.launches = 0
