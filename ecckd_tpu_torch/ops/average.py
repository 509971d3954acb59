"""Spectral averaging: LW and SW candidate-interval fits and g-point LUT
averaging.

PyTorch counterpart of ``ecckd_tpu/ops/average.py``
(ref find_g_points.cpp:54-204, average_optical_depth.cpp:21-197).
Reference quirks reproduced deliberately: the 0.9999999999999999
transmission clamp (average_optical_depth.cpp:48), the LW logarithmic fit's
Planck weights at the layer base for the numerator and the layer top for
the denominator (find_g_points.cpp:85-99), and ``abs(-log(1-x))`` to strip
the sign of a negative zero (average_optical_depth.cpp:168).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import ACCEL_GRAVITY, LW_DIFFUSIVITY, MOLAR_MASS_DRY_AIR
from .kernels.interval_sum import fused_interval_sum
from .kernels.segment_minmax import segment_min_max
from .segments import part_of

_TRANS_CLAMP = 0.9999999999999999

# Scale factor of the transmission applied per method name
_METHOD_SCALE = {
    "transmission": 1.0,
    "transmission-2": 2.0,
    "transmission-3": 3.0,
    "transmission-10": 10.0,
}


def _trans_clamp(dtype):
    """Largest representable transmission mean below 1 for the dtype.

    The reference's double constant rounds to exactly 1.0f in float32,
    which would make -log1p(-mean) infinite; float32 is capped at 1 - 1e-6
    (od cap ~8.3 at the LW diffusivity), float64 keeps reference parity.
    """
    if dtype == torch.float64:
        return _TRANS_CLAMP
    return 1.0 - 1.0e-6


def _trans_od(mean, scale, limits=None):
    """Fitted od from a mean transmission-like quantity, clamped below 1
    (the clamp of ``limits``, by default of the mean's dtype)."""
    mean = torch.clamp(mean, max=_trans_clamp(limits or mean.dtype))
    return torch.abs(-torch.log1p(-mean) / (LW_DIFFUSIVITY * scale))


def fit_parts_lw(averaging_method, planck_hl, metric, limits=None):
    """Decomposed LW interval fit: ``(parts, rows, finish)``.

    ``parts`` are :func:`~ecckd_tpu_torch.ops.segments.part_of` products
    covering ``rows`` output rows, so kernel K3 can reduce them together
    with the truth rows in one pass; ``finish(sums, i1, i2)`` maps the
    (rows, nseg) sums to the fitted od (nlay, nseg).  ``limits`` is the
    float dtype whose transmission clamp the fit takes, by default the
    metric's (a float64 fit given float32's shows what the clamp alone
    does to a float32 fit)."""
    w_num = planck_hl[1:]   # weights at layer base (ref :61-63)
    nlay = metric.shape[0]

    if averaging_method in ("linear", "transmission", "transmission-2",
                            "square-root"):
        parts = [part_of(metric, w_num), part_of(w_num)]

        def finish(sums, i1, i2):
            mean = sums[:nlay] / sums[nlay:2 * nlay]
            if averaging_method == "linear":
                return mean
            if averaging_method == "square-root":
                return mean * mean
            return _trans_od(mean, _METHOD_SCALE[averaging_method], limits)

        return parts, 2 * nlay, finish

    if averaging_method == "logarithmic":
        return _log_fit_parts(metric, w_num, planck_hl[:-1])
    raise ValueError(f"Averaging method {averaging_method!r} not understood")


def _log_fit_parts(metric, w_num, w_den):
    """Logarithmic average handling zeros (ref find_g_points.cpp:80-110).

    Pure log-average over nonzero entries, scaled by the nonzero fraction
    when some entries are zero; zero when all are zero.  The log of the
    metric and its nonzero mask are materialised once, so all three
    reductions (log-weighted sum, masked denominator weights, nonzero
    count) are plain :func:`part_of` products that kernel K3 takes."""
    nlay = metric.shape[0]
    nonzero = metric > 0.0
    nz = nonzero.to(metric.dtype)
    log_m = torch.where(nonzero, torch.log(torch.where(nonzero, metric, 1.0)),
                        0.0)
    parts = [part_of(log_m, w_num), part_of(w_den, nz), part_of(nz)]

    def finish(sums, i1, i2):
        sum_log = sums[:nlay]
        sum_w_den_nz = sums[nlay:2 * nlay]
        count_nz = sums[2 * nlay:3 * nlay]
        count_all = (i2 - i1 + 1).to(metric.dtype)
        all_nonzero = count_nz >= count_all
        none_nonzero = count_nz <= 0.0
        denom = torch.where(none_nonzero, 1.0, sum_w_den_nz)
        fit = torch.exp(sum_log / denom)
        fit = torch.where(all_nonzero, fit, fit * (count_nz / count_all))
        return torch.where(none_nonzero, 0.0, fit)

    return parts, 3 * nlay, finish


def fit_optical_depth_lw(averaging_method, planck_hl, metric, i1, i2):
    """Fitted (grey) od (nlay, nseg) per layer for each rank interval
    [i1, i2] with LW Planck weighting (ref find_g_points.cpp:54-110)."""
    parts, rows, finish = fit_parts_lw(averaging_method, planck_hl, metric)
    sums = fused_interval_sum(parts, metric.shape[-1], i1, i2,
                              dtype=metric.dtype)
    return finish(sums, i1, i2)


def fit_parts_sw(averaging_method, ssi, metric, limits=None):
    """Decomposed SW interval fit with solar-irradiance weights (ref
    find_g_points.cpp:113-168); see :func:`fit_parts_lw`."""
    nlay = metric.shape[0]
    if averaging_method in ("linear", "transmission", "transmission-2",
                            "square-root"):
        parts = [part_of(metric, ssi), part_of(ssi)]

        def finish(sums, i1, i2):
            wsum_m, wsum = sums[:nlay], sums[nlay]
            norm = 1.0 / wsum
            if averaging_method == "linear":
                return wsum_m * norm
            if averaging_method == "square-root":
                fit = wsum_m * norm
                return fit * fit
            # The clamp goes before the normalisation, as in the reference
            mean = torch.clamp(
                wsum_m, max=_trans_clamp(limits or metric.dtype)) * norm
            return torch.abs(-torch.log1p(-mean) / (
                LW_DIFFUSIVITY * _METHOD_SCALE[averaging_method]))

        return parts, nlay + 1, finish

    if averaging_method in ("logarithmic", "total-transmission"):
        return _log_fit_parts(metric, ssi, ssi)
    raise ValueError(f"Averaging method {averaging_method!r} not understood")


def fit_optical_depth_sw(averaging_method, ssi, metric, i1, i2):
    """Fitted (grey) od (nlay, nseg) per layer for each rank interval
    [i1, i2] with SW solar-irradiance weighting."""
    parts, rows, finish = fit_parts_sw(averaging_method, ssi, metric)
    sums = fused_interval_sum(parts, metric.shape[-1], i1, i2,
                              dtype=metric.dtype)
    return finish(sums, i1, i2)


def total_trans_fallback(sums, nlay):
    """Per interval, from the (rows, nseg) sums of
    :func:`total_trans_fit_parts`' parts, whether the fit falls back to the
    linear fit: some level flux of the interval is not positive."""
    return torch.any(~(sums[1:2 * nlay + 1] > 0.0), dim=0)


def total_trans_fit_parts(ssi, bg_od, od, limits=None):
    """Decomposed total-transmission fit (ref find_g_points.cpp:173-204):
    ``(parts, rows, finish)`` as :func:`fit_parts_lw`.

    The fit needs, per interval, the broadband direct flux at secant 2 at
    every level with and without the target gas.  Those 2*nlay+1 rows
    depend on the spectrum alone, not on the interval bounds, so they are
    materialised once (ssi, then the background-only fluxes, then the
    fluxes with the gas) and every probe reduces them as plain
    :func:`part_of` rows that kernel K3 takes, together with the linear
    fallback numerator ``od * ssi``.  With ``limits``, a float dtype, a
    level flux below its smallest normal number is zero, as it underflows
    in that dtype."""
    sec = 2.0
    nlay = od.shape[0]
    levels = torch.cat([ssi[None, :],
                        ssi * torch.exp(-sec * torch.cumsum(bg_od, dim=0)),
                        ssi * torch.exp(-sec * torch.cumsum(bg_od + od,
                                                            dim=0))])
    if limits is not None:
        levels = torch.where(levels < torch.finfo(limits).tiny, 0.0, levels)

    def finish(sums, i1, i2):
        top = sums[0]
        bb_bg = sums[1:nlay + 1]
        bb = sums[nlay + 1:2 * nlay + 1]
        bb_bg_above = torch.cat([top[None], bb_bg[:-1]])
        bb_above = torch.cat([top[None], bb[:-1]])
        ok = (bb_bg > 0.0) & (bb > 0.0)
        safe_bg = torch.where(ok, bb_bg, 1.0)
        safe = torch.where(ok, bb, 1.0)
        # The floor is 1e-300 rounded to the dtype: 0 in float32, as in JAX
        bg_fit = -0.5 * torch.log(safe_bg / torch.clamp(bb_bg_above,
                                                        min=1e-300))
        fit = (-0.5 * torch.log(safe / torch.clamp(bb_above, min=1e-300))
               - bg_fit)
        linear = sums[2 * nlay + 1:] / top
        # A profile with any empty flux falls back to the linear fit
        # whole, as the reference overwrites the whole vector
        return torch.where(total_trans_fallback(sums, nlay)[None, :],
                           linear, fit)

    return [part_of(levels), part_of(od, ssi)], 3 * nlay + 1, finish


def fit_optical_depth_sw_total_trans(ssi, bg_od, od, i1, i2):
    """Total-transmission fitted od (nlay, nseg) (ref
    find_g_points.cpp:173-204)."""
    parts, rows, finish = total_trans_fit_parts(ssi, bg_od, od)
    sums = fused_interval_sum(parts, od.shape[-1], i1, i2, dtype=od.dtype)
    return finish(sums, i1, i2)


#: Every method average_optical_depth_to_g_point supports
#: (average_optical_depth.cpp:120-197), all expressible as accumulated
#: weighted sums plus a final host-side transform.
GPOINT_AVERAGING_METHODS = (
    "linear", "transmission", "transmission-2", "transmission-3",
    "transmission-10", "square-root", "logarithmic",
    "hybrid-logarithmic-transmission-3")

# Wavenumbers of one one-hot matmul of the segment sums
_SEG_CHUNK = 65536


def _segment_min_max(ng, g_point, od):
    """Per-(layer, g) min and max od over member wavenumbers: flattened
    ``scatter_reduce`` amin/amax.  Empty segments keep the +/-inf identity,
    which survives min/max combination across blocks.  The plain version
    of kernel K4 (:func:`~ecckd_tpu_torch.ops.kernels.segment_minmax.
    segment_min_max`), which runs it on the CPU."""
    nz = od.shape[0]
    valid = g_point >= 0
    layer = ng * torch.arange(nz, device=od.device, dtype=torch.int64)
    seg_ids = torch.where(valid[None, :], g_point.to(torch.int64)[None, :]
                          + layer[:, None], nz * ng).reshape(-1)
    flat = od.reshape(-1)
    out = []
    for init, how in ((float("inf"), "amin"), (-float("inf"), "amax")):
        out.append(torch.full((nz * ng + 1,), init, dtype=od.dtype,
                              device=od.device).scatter_reduce(
            0, seg_ids, flat, how)[:-1].reshape(nz, ng))
    return out


def gpoint_block_partials(ng, g_point, od, weight, averaging_method):
    """Partial sums for one wavenumber block: a dict of (nz, ng) tensors
    on the block's device, in its dtype.

    Every g-point averaging reduction decomposes into weighted sums
    accumulated over wavenumber blocks (streamed from disk or cut from
    arrays in memory, :mod:`ecckd_tpu_torch.ops.streaming`) plus a final
    transform (:func:`finalize_gpoint_partials`).  The blocks' partials
    combine by :func:`combine_partials`.  The sums are chunked
    one-hot matmuls (exact with TF32 off), ``min``/``max`` kernel K4 on
    the card (:func:`_segment_min_max` on the CPU).

    The logarithmic method (average_optical_depth.cpp:127-141) needs three
    extra accumulators: sum of w*log(od) over od>0, sum of w over od>0,
    and the nonzero count; the hybrid method accumulates both those and
    the transmission-3 numerator so the finalizer can blend per layer.

    Args:
      g_point: (nb,) integer tensor on ``od``'s device (<0 = unassigned).
      od: (nz, nb); weight: broadcastable to it.
    """
    # Row-major operands whatever the block's origin (a slice of an array,
    # a transposed shard block), so that the matmuls of a block take the
    # same path, and sum in the same order, in the dense and streamed runs
    od = od.contiguous()
    nz, nb = od.shape
    dtype = od.dtype
    w = torch.broadcast_to(weight, od.shape).contiguous()
    g_range = torch.arange(ng, device=g_point.device, dtype=g_point.dtype)

    def seg(v):
        acc = torch.zeros((nz, ng), dtype=dtype, device=od.device)
        for c0 in range(0, nb, _SEG_CHUNK):
            onehot = (g_point[c0:c0 + _SEG_CHUNK, None]
                      == g_range[None, :]).to(dtype)
            acc = acc + v[:, c0:c0 + _SEG_CHUNK] @ onehot
        return acc

    out = {"w_sum": seg(w), "count": seg(torch.ones_like(od))}
    method = averaging_method
    hybrid = method == "hybrid-logarithmic-transmission-3"
    if method == "linear":
        out["num"] = seg(od * w)
    elif method in _METHOD_SCALE or hybrid:
        scale = 3.0 if hybrid else _METHOD_SCALE[method]
        out["num"] = seg(-torch.expm1(-od * (LW_DIFFUSIVITY * scale)) * w)
    elif method == "square-root":
        out["num"] = seg(torch.sqrt(od) * w)
    elif method != "logarithmic":
        raise ValueError(
            f"averaging_method {method!r} not understood; choose from "
            f"{GPOINT_AVERAGING_METHODS}")
    if method == "logarithmic" or hybrid:
        nonzero = od > 0.0
        log_od = torch.where(nonzero,
                             torch.log(torch.where(nonzero, od, 1.0)), 0.0)
        out["sum_log"] = seg(log_od * w * nonzero)
        out["sum_w_nz"] = seg(w * nonzero)
        out["count_nz"] = seg(nonzero.to(dtype))
    out["min"], out["max"] = segment_min_max(ng, g_point, od)
    return out


def combine_partials(acc, part):
    """In-place combination of per-block partials (dicts of numpy arrays):
    ``min``/``max`` by elementwise extremum, every other key by addition."""
    for key, v in part.items():
        if key == "min":
            acc[key] = np.minimum(acc[key], v)
        elif key == "max":
            acc[key] = np.maximum(acc[key], v)
        else:
            acc[key] = acc[key] + v
    return acc


def finalize_gpoint_partials(acc, averaging_method, pressure_fl=None):
    """(od_fit, min_od, max_od), numpy (nz, ng), from fully combined
    partial sums.

    Host numpy, as in the JAX package: the output is tiny and this runs
    once per profile, after the accumulation.  Semantics of
    average_optical_depth.cpp:120-197, incl. the clamp-to-bounds and the
    degenerate-bound widening at :139-163.
    """
    acc = {k: np.asarray(v) for k, v in acc.items()}
    w_sum = acc["w_sum"]
    safe = np.where(w_sum > 0.0, w_sum, 1.0)
    method = averaging_method
    clamp = (_TRANS_CLAMP if acc["w_sum"].dtype == np.float64
             else 1.0 - 1.0e-6)

    def trans_fit(scale):
        mean = np.minimum(clamp, acc["num"] / safe)
        return np.abs(-np.log1p(-mean) / (LW_DIFFUSIVITY * scale))

    def log_fit():
        count_nz, count_all = acc["count_nz"], acc["count"]
        all_nz = count_nz >= count_all
        none_nz = count_nz <= 0.0
        denom = np.where(none_nz, 1.0,
                         np.where(all_nz, safe, acc["sum_w_nz"]))
        with np.errstate(over="ignore"):
            fit = np.exp(acc["sum_log"] / denom)
        fit = np.where(all_nz, fit,
                       fit * count_nz / np.maximum(count_all, 1.0))
        return np.where(none_nz, 0.0, fit)

    if method == "linear":
        fit = acc["num"] / safe
    elif method in _METHOD_SCALE:
        fit = trans_fit(_METHOD_SCALE[method])
    elif method == "square-root":
        mean = acc["num"] / safe
        fit = mean * mean
    elif method == "logarithmic":
        fit = log_fit()
    elif method == "hybrid-logarithmic-transmission-3":
        if pressure_fl is None:
            raise ValueError("hybrid method requires pressure_fl")
        use_log = (np.asarray(pressure_fl) > 100.0e2)[:, None]
        fit = np.where(use_log, log_fit(), trans_fit(3.0))
    else:
        raise ValueError(
            f"averaging_method {method!r} not understood; choose from "
            f"{GPOINT_AVERAGING_METHODS}")

    empty = acc["count"][0] <= 0.0
    min_od = np.where(empty[None, :] | ~np.isfinite(acc["min"]), 0.0,
                      acc["min"])
    max_od = np.where(empty[None, :] | ~np.isfinite(acc["max"]), 0.0,
                      acc["max"])
    fit = np.where(empty[None, :], 0.0, fit)
    fit = np.maximum(min_od, np.minimum(fit, max_od))
    degenerate = (min_od > 0.0) & (min_od >= max_od)
    min_od = np.where(degenerate, min_od * 0.99, min_od)
    max_od = np.where(degenerate, max_od * 1.01, max_od)
    return fit, min_od, max_od


def od_to_molar_abs(od_fit, pressure_hl, reference_surface_vmr):
    """Per-layer od to molar absorption coefficient (m2 mol-1):
    k = (g * 0.001 * M_air / vmr) * od / dp (ref
    average_optical_depth.cpp:168-187).  With reference_surface_vmr <= 0 the
    od is returned unchanged (mean-od mode)."""
    if reference_surface_vmr is None or reference_surface_vmr <= 0.0:
        return od_fit
    dp = (pressure_hl[1:] - pressure_hl[:-1])[:, None]
    return ((ACCEL_GRAVITY * 0.001 * MOLAR_MASS_DRY_AIR)
            / reference_surface_vmr) * od_fit / dp
