"""Plain reference of a g-point search's answers.

The search itself is a sequence of several hundred probes that depends on
every bit of the costs before it, so no reference replays it in the time
of a run.  The reference checks its answers instead, by their definitions:

* reorder_spectrum's sorting variable, computed again for every
  wavenumber, and the program's rank order held to it: ranks that sort
  the reference's sorting variable within each band;
* the g-points: rank intervals that tile each band, as many in a band as
  its ``min_g_points`` asks at least, no cost reported only for the
  pieces of a ``base_split``; the cost of each interval (the heating-rate
  error of its averaged optical depth against the line-by-line truth,
  ecCKD's ``calc_error``), computed again from the spectrum and held to
  the cost the program reports for it;
* what the search decides, by its own rule, from those recomputed
  costs: the balance of the costs of a band's g-points, as the
  equipartition's stopping number (the range of the costs over their
  mean; for two intervals half their difference over their sum) over
  ``partition_tolerance``, where it stops.  The number of g-points in all
  is held to the configuration's by the job.

A wavenumber that two neighbouring intervals share (both bounds of one
rank, as the reference's index rule allows) carries the fit of the later
interval when both ride one probe, and its own interval's fit when the
earlier one was probed without the later (a pairwise refinement).  Its
interval's cost is therefore held to the nearer of those two readings.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .physics import (LW_DIFFUSIVITY, TRANS_CLAMP, cost, heating_rate,
                      layer_weight, lw_fluxes, planck, sw_direct,
                      sw_reflected)

BLOCK = 1 << 20
REFERENCE_ALBEDO = 0.15
REFERENCE_COS_SZA = 0.5


# ------------------------------------------------------ sorting variable

def lw_sorting_variable(p_hl, wav, dwav, od, threshold):
    """reorder_spectrum.cpp:98-228: the pseudo-height of peak cooling in an
    idealised atmosphere, or column od minus the threshold where the
    column is thinner."""
    log_p = torch.log(p_hl)
    t_hl = 173.15 + (log_p / math.log(1.0e5)) * (288.15 - 173.15)
    t_hl = torch.clamp(t_hl, 173.15, 288.15)
    pl = planck(t_hl, wav, dwav)
    fd, fu = lw_fluxes(pl, od, pl[-1])
    hr = torch.clamp(heating_rate(p_hl, fd, fu), max=0.0)
    height = log_p[-1] - 0.5 * (log_p[:-1] + log_p[1:])
    dh = (log_p[1:] - log_p[:-1])[:, None]
    num = (hr * dh * height[:, None]).sum(0)
    den = (hr * dh).sum(0)
    peak = torch.where(den != 0.0, num / torch.where(den != 0.0, den, 1.0),
                       torch.zeros_like(den))
    col = od.sum(0)
    return torch.where(col < threshold, col - threshold, peak)


def sw_sorting_variable(p_hl, od, threshold):
    """reorder_spectrum.cpp:196-222: the pseudo-height at which the od
    summed from the top reaches the threshold, or column od minus the
    threshold."""
    log_p = torch.log(p_hl)
    height = log_p[-1] - log_p
    cum = torch.cat([torch.zeros_like(od[:1]), torch.cumsum(od, 0)])
    col = cum[-1]
    first = torch.argmax((cum[1:] >= threshold).to(torch.int32), 0)
    above = cum.gather(0, first[None])[0]
    lay = od.gather(0, first[None])[0]
    h = (((threshold - above) * height[first + 1]
          + (above + lay - threshold) * height[first])
         / torch.clamp(lay, min=1.0e-12))
    return torch.where(col <= threshold, col - threshold, h)


def sorting_variable(cfg, p_hl, wav, dwav, od, device):
    """The sorting variable of every wavenumber, float64 on ``device``,
    in blocks."""
    out = torch.empty(od.shape[1], dtype=torch.float64, device=device)
    for i0 in range(0, od.shape[1], BLOCK):
        s = slice(i0, i0 + BLOCK)
        o = torch.as_tensor(od[:, s], device=device)
        if cfg.get("shortwave"):
            out[s] = sw_sorting_variable(p_hl, o, cfg["reorder_threshold"])
        else:
            out[s] = lw_sorting_variable(p_hl, wav[s], dwav[s], o,
                                         cfg["reorder_threshold"])
    return out


def order_disorder(sv, rank, band_number):
    """How far the rank order departs from sorting ``sv`` within each
    band: the largest drop of ``sv`` from one rank to the next, over the
    largest |sv|; 0 for a sorted order."""
    order = torch.empty_like(rank)
    order[rank] = torch.arange(rank.numel(), device=rank.device)
    s = sv[order]
    same_band = band_number[order][1:] == band_number[order][:-1]
    drop = torch.where(same_band, s[:-1] - s[1:], torch.zeros_like(s[1:]))
    return float(torch.clamp(drop.max(), min=0.0) / sv.abs().max())


# ---------------------------------------------------------- g-point cost

class _Gas:
    """One gas's spectrum in the program's rank order, on the device."""

    def __init__(self, cfg, spec, gas, bg_od, rank, device):
        self.cfg = cfg
        rank = torch.as_tensor(rank, dtype=torch.int64, device=device)
        self.order = torch.empty_like(rank)
        self.order[rank] = torch.arange(rank.numel(), device=device)
        take = lambda a: torch.as_tensor(a, device=device)[..., self.order]
        self.p_hl = torch.as_tensor(spec.pressure_hl, device=device)
        self.t_hl = torch.as_tensor(gas.temperature_hl, device=device)
        self.wav = take(spec.wavenumber)
        self.dwav = take(spec.d_wavenumber)
        self.od = take(gas.optical_depth)
        self.bg = (torch.zeros_like(self.od) if bg_od is None
                   else take(bg_od))
        self.lw = layer_weight(self.p_hl, cfg["min_pressure_pa"])
        if cfg.get("shortwave"):
            self.ssi = take(spec.ssi)
            albedo = torch.where(
                torch.as_tensor(spec.wavenumber, device=device)
                < cfg["max_no_rayleigh_wavenumber"],
                REFERENCE_ALBEDO, 0.0).to(torch.float64)
            self.albedo = albedo[self.order]

    def lw_cost(self, a, b, fit_last=None):
        """Cost of ranks [a, b]; ``fit_last`` (nlay,) is the fitted od its
        last wavenumber carries instead of the interval's own."""
        s = slice(a, b + 1)
        od, bg = self.od[:, s], self.bg[:, s]
        pl = planck(self.t_hl, self.wav[s], self.dwav[s])
        fd, fu = lw_fluxes(pl, bg + od, pl[-1])
        hr_true = heating_rate(self.p_hl, fd, fu).sum(1)
        fd_true, fu_true = fd[-1].sum(), fu[0].sum()
        w = pl[1:]
        metric = -torch.expm1(-LW_DIFFUSIVITY * od)
        mean = torch.clamp((metric * w).sum(1) / w.sum(1), max=TRANS_CLAMP)
        fit = torch.abs(-torch.log1p(-mean) / LW_DIFFUSIVITY)
        grey = fit[:, None].expand_as(od).clone()
        if fit_last is not None:
            grey[:, -1] = fit_last
        dn, up = lw_fluxes(pl, bg + grey, pl[-1], clamped=True)
        dn, up = dn.sum(1), up.sum(1)
        return (cost(self.p_hl, self.lw, self.cfg["flux_weight"],
                     heating_rate(self.p_hl, dn, up), hr_true,
                     dn[-1] - fd_true, up[0] - fu_true), fit)

    def _sw_fit(self, s):
        """Total-transmission fit (find_g_points.cpp:173-204) of the
        ranks ``s``: from the broadband direct flux at secant 2 with and
        without the gas, or the linear fit where any of it is empty."""
        od, bg, ssi = self.od[:, s], self.bg[:, s], self.ssi[s]
        top = ssi.sum()
        bb_bg = (ssi * torch.exp(-2.0 * torch.cumsum(bg, 0))).sum(1)
        bb = (ssi * torch.exp(-2.0 * torch.cumsum(bg + od, 0))).sum(1)
        if not (bool((bb_bg > 0).all()) and bool((bb > 0).all())):
            return (od * ssi).sum(1) / top
        above = lambda x: torch.cat([top[None], x[:-1]])
        return (-0.5 * torch.log(bb / torch.clamp(above(bb), min=1e-300))
                + 0.5 * torch.log(bb_bg / torch.clamp(above(bb_bg),
                                                      min=1e-300)))

    def sw_cost(self, a, b, fit_last=None):
        """Total-transmission cost of ranks [a, b]: the mean of the costs
        of the gas scaled by the low and the high scaling, each against
        its own truth (find_g_points.cpp:340-394).  The candidate's
        reflected beam is off: no band of the configuration lies below
        the no-Rayleigh limit."""
        s = slice(a, b + 1)
        od, bg, ssi = self.od[:, s], self.bg[:, s], self.ssi[s]
        fit = self._sw_fit(s)
        out = 0.0
        for scaling in (self.cfg["min_scaling"], self.cfg["max_scaling"]):
            tot = bg + scaling * od
            fd = sw_direct(REFERENCE_COS_SZA, ssi, tot)
            fu = sw_reflected(fd, tot, self.albedo[s])
            hr_true = heating_rate(self.p_hl, fd).sum(1)
            grey = (scaling * fit)[:, None].expand_as(od).clone()
            if fit_last is not None:
                grey[:, -1] = scaling * fit_last
            dn = sw_direct(REFERENCE_COS_SZA, ssi, bg + grey).sum(1)
            out = out + 0.5 * cost(
                self.p_hl, self.lw, self.cfg["flux_weight"],
                heating_rate(self.p_hl, dn), hr_true,
                dn[-1] - fd[-1].sum(), -fu[0].sum())
        return out, fit

    def costs(self, rank1, rank2):
        """Per interval the pair of reference costs: alone, and with its
        last wavenumber carrying the next interval's fit where the next
        interval starts on it (else the same)."""
        fn = self.sw_cost if self.cfg.get("shortwave") else self.lw_cost
        alone, fits = [], []
        for a, b in zip(rank1, rank2):
            c, fit = fn(int(a), int(b))
            alone.append(float(c))
            fits.append(fit)
        beside = list(alone)
        for k in range(len(rank1) - 1):
            if rank1[k + 1] == rank2[k] and rank2[k] > rank1[k]:
                beside[k] = float(fn(int(rank1[k]), int(rank2[k]),
                                     fit_last=fits[k + 1])[0])
        return np.array(alone), np.array(beside)


def partition_faults(rank1, rank2, band, band_ranges, error,
                     min_g_points, base_split):
    """Breaches of the tiling of each band by its g-points' rank
    intervals: a band's first interval starts at the band's first rank,
    its last ends at the band's last, each starts at or just after the
    end of the one before, and none is empty.  Besides, a band with fewer
    g-points than its ``min_g_points``, and costs left unreported (below
    0) anywhere but on the ``base_split`` pieces, which open the band."""
    faults = 0
    for jband, (lo, hi) in enumerate(band_ranges):
        sel = np.nonzero(band == jband)[0]
        if len(sel) == 0:
            faults += 1
            continue
        r1, r2 = rank1[sel], rank2[sel]
        faults += int(r1[0] != lo) + int(r2[-1] != hi)
        faults += int(np.sum(r2 < r1))
        faults += int(np.sum((r1[1:] != r2[:-1]) & (r1[1:] != r2[:-1] + 1)))
        faults += int(len(sel) < min_g_points[jband])
        pieces = int(base_split[jband]) if base_split[jband] > 1 else 0
        unreported = error[sel] < 0
        faults += int(np.sum(unreported[pieces:]))
        faults += int(np.sum(~unreported[:pieces]))
    return faults


def imbalance(costs, band, unreported, tolerance):
    """The equipartition's stopping number over its ``tolerance``, the
    largest over the bands of two or more costed g-points (0 where no
    band has two): the range of the costs over their mean where the
    equipartition saw three intervals or more (equipartition.cpp's
    ``frac_range``), half their difference over their sum where it saw
    two; a ``base_split`` cuts one of its intervals into the unreported
    pieces."""
    worst = 0.0
    for jband in np.unique(band):
        sel = band == jband
        c = costs[sel & ~unreported]
        if len(c) < 2:
            continue
        seen = len(c) + int(np.any(unreported[sel]))
        number = (c.max() - c.min()) / (c.mean() if seen > 2
                                        else 2.0 * c.sum())
        worst = max(worst, float(number / tolerance))
    return worst


def per_band(gas_cfg, key, nband, fill):
    """A gas's per-band search option, one value a band: the bands it
    does not name take ``fill``, as find_g_points fills them."""
    out = np.full(nband, fill, np.float64)
    v = np.asarray(gas_cfg.get(key, []), np.float64)[:nband]
    out[:len(v)] = v
    return out


def check_gas(cfg, gas_cfg, spec, gas, bg_od, order, g, device):
    """The numbers of one gas's answers: (sorting variable's largest
    relative gap, rank disorder, partition faults, rank faults, largest
    relative gap of a g-point's cost, the bands' largest imbalance of
    costs)."""
    p_hl = torch.as_tensor(spec.pressure_hl, device=device)
    sv = sorting_variable(cfg, p_hl,
                          torch.as_tensor(spec.wavenumber, device=device),
                          torch.as_tensor(spec.d_wavenumber, device=device),
                          gas.optical_depth, device)
    got_sv = torch.as_tensor(order["sorting_variable"], device=device)
    sv_gap = float((got_sv - sv).abs().max() / sv.abs().max())
    rank = torch.as_tensor(order["rank"], dtype=torch.int64, device=device)
    band_number = torch.as_tensor(order["band_number"], device=device)
    rank_faults = int(rank.numel() - torch.unique(rank).numel()
                      + int((rank < 0).sum() + (rank >= rank.numel()).sum()))
    disorder = (order_disorder(sv, rank, band_number) if rank_faults == 0
                else math.inf)
    del sv, got_sv
    bn = np.asarray(order["band_number"])
    nband = len(order["wavenumber1_band"])
    ranks_of_band = [np.asarray(order["rank"])[bn == j]
                     for j in range(nband)]
    band_ranges = [(int(r.min()), int(r.max())) if len(r) else (0, -1)
                   for r in ranks_of_band]
    got = np.asarray(g.error, np.float64)
    band = np.asarray(g.band_number)
    faults = partition_faults(g.rank1, g.rank2, band, band_ranges, got,
                              per_band(gas_cfg, "min_g_points", nband, 1),
                              per_band(gas_cfg, "base_split", nband, 1))
    if faults or rank_faults:      # no intervals to cost
        return sv_gap, disorder, faults, rank_faults, math.inf, math.inf
    ref = _Gas(cfg, spec, gas, bg_od, order["rank"], device)
    alone, beside = ref.costs(g.rank1, g.rank2)
    unreported = got < 0
    gap = np.minimum(np.abs(got - alone), np.abs(got - beside))
    gap = np.where(unreported, 0.0, gap)
    cost_gap = float(np.max(gap / np.maximum(np.abs(alone), 1e-300)))
    return (sv_gap, disorder, faults, rank_faults, cost_gap,
            imbalance(alone, band, unreported, cfg["partition_tolerance"]))
