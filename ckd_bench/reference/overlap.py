"""Plain reference of the overlap of a search's gases.

find_g_points ends by merging the g-points of its gases into one set
(Hogan 2010) and mapping every wavenumber to a merged g-point.  The
reference computes that result again by its definitions, in plain
PyTorch on the device, from what the search check has already held to
the spectrum (:mod:`ckd_bench.reference.search`):

* each gas's per-wavenumber g-point from its rank intervals: the last
  interval that holds a wavenumber's rank wins, and a wavenumber that no
  interval holds has none (single_gas_data.h:59-66);
* each g-point's median sorting variable, the sorting variable in rank
  order at the first rank where the running sum of the weights reaches
  half of the interval's (find_g_points.cpp:36-49), from the reference's
  own sorting variable, with the Planck function at the surface
  temperature as the weight (the longwave's; a shortwave search is not
  checked here);
* each gas's range of g-points in every merged g-point, by the hypercube
  rule (single_gas_data.cpp:23-124): a band's first merged g-point holds
  every gas's first g-point there, and each later one advances the gas
  whose next g-point has the least median sorting variable (the first
  such gas on a tie), holding that g-point of it and every g-point of
  the others reached so far.  The rule is driven by the medians that the
  program reports, once those are held to the recomputed ones, so that a
  tie in the last bit cannot flip the order of two gases;
* the merged per-wavenumber map: a wavenumber belongs to every merged
  g-point whose ranges hold each gas's g-point of it, the last such one
  winning (find_g_points.cpp:1459-1481), and each merged g-point's band.

The program's maps are compared with these wavenumber by wavenumber.
"""

from __future__ import annotations

import numpy as np
import torch

from .physics import planck
from .search import sorting_variable

NO_G_POINT = -1


def gas_g_point(rank, rank1, rank2):
    """(nwav,) int64 g-point of each wavenumber of one gas, in wavenumber
    order, from its (ng,) inclusive rank intervals; the later interval
    wins, and a rank that no interval holds gets ``NO_G_POINT``."""
    out = torch.full_like(rank, NO_G_POINT)
    for ig, (a, b) in enumerate(zip(rank1, rank2)):
        out[(rank >= int(a)) & (rank <= int(b))] = ig
    return out


def median_sorting_variable(sv, weight, rank, rank1, rank2):
    """(ng,) median sorting variable of each rank interval: ``sv`` and
    ``weight`` (nwav,) in wavenumber order, ``rank`` each wavenumber's
    rank."""
    order = torch.empty_like(rank)
    order[rank] = torch.arange(rank.numel(), device=rank.device)
    sv, weight = sv[order], weight[order]
    out = []
    for a, b in zip(rank1, rank2):
        w = weight[int(a):int(b) + 1]
        below = torch.cumsum(w, 0) < 0.5 * w.sum()
        k = min(int(below.sum()), int(b) - int(a))
        out.append(float(sv[int(a) + k]))
    return np.array(out)


def hypercube(n_g_points, medians):
    """The merged g-points of gases with ``n_g_points[k]`` (nband,)
    g-points a band and reported ``medians[k]`` (ng_k,): (band of each
    merged g-point, and per gas its (g_min, g_max) in each)."""
    ngas = len(n_g_points)
    first = [0] * ngas
    bands, ranges = [], []
    for jband in range(len(n_g_points[0])):
        count = [int(n[jband]) for n in n_g_points]
        reached = [0] * ngas
        bands.append(jband)
        ranges.append([(first[k], first[k]) for k in range(ngas)])
        for _ in range(sum(count) - ngas):
            best = None
            for k in range(ngas):
                if reached[k] + 1 < count[k]:
                    sv = medians[k][first[k] + reached[k] + 1]
                    if best is None or sv < best[0]:
                        best = (sv, k)
            k_adv = best[1]
            reached[k_adv] += 1
            bands.append(jband)
            ranges.append([
                (first[k] + reached[k],) * 2 if k == k_adv
                else (first[k], first[k] + reached[k])
                for k in range(ngas)])
        first = [f + c for f, c in zip(first, count)]
    return np.array(bands), ranges


def merged_map(gas_maps, ranges):
    """(nwav,) merged g-point of each wavenumber from the gases' maps and
    each merged g-point's ranges; the later merged g-point wins."""
    out = torch.full_like(gas_maps[0], NO_G_POINT)
    for ig, per_gas in enumerate(ranges):
        inside = torch.ones_like(out, dtype=torch.bool)
        for gmap, (lo, hi) in zip(gas_maps, per_gas):
            inside &= (gmap >= lo) & (gmap <= hi)
        out[inside] = ig
    return out


def check_overlap(cfg, spec, gases, orders, gp, device):
    """The numbers of one search's overlap: (wavenumbers whose per-gas
    g-point differs from the reference's, summed over the gases;
    wavenumbers whose merged g-point differs plus merged g-points whose
    band differs; the largest gap of a reported median sorting variable
    over the largest |sorting variable| of its gas).  ``gases`` holds
    each gas's (configuration, profile, background).  Longwave only."""
    if cfg.get("shortwave"):
        raise ValueError("the overlap's reference weighs the longwave's "
                         "medians only")
    p_hl = torch.as_tensor(spec.pressure_hl, device=device)
    wav = torch.as_tensor(spec.wavenumber, device=device)
    dwav = torch.as_tensor(spec.d_wavenumber, device=device)
    gas_faults, sv_gap, maps = 0, 0.0, []
    for (_, sp, _), order, g in zip(gases, orders, gp.gases):
        rank = torch.as_tensor(np.asarray(order["rank"]), dtype=torch.int64,
                               device=device)
        gmap = gas_g_point(rank, g.rank1, g.rank2)
        maps.append(gmap)
        got = torch.as_tensor(np.asarray(g.g_point, np.int64), device=device)
        gas_faults += (int((got != gmap).sum()) if got.shape == gmap.shape
                       else gmap.numel())
        sv = sorting_variable(cfg, p_hl, wav, dwav, sp.optical_depth,
                              device)
        t_surf = torch.as_tensor(sp.temperature_hl[-1:], device=device)
        med = median_sorting_variable(sv, planck(t_surf, wav, dwav)[0],
                                      rank, g.rank1, g.rank2)
        gap = np.abs(np.asarray(g.sorting_variable, np.float64) - med)
        sv_gap = max(sv_gap, float(gap.max() / sv.abs().max()))
        del sv
    bands, ranges = hypercube([g.n_g_points for g in gp.gases],
                              [np.asarray(g.sorting_variable)
                               for g in gp.gases])
    ref = merged_map(maps, ranges)
    got = torch.as_tensor(np.asarray(gp.g_point, np.int64), device=device)
    merged_faults = (int((got != ref).sum()) if got.shape == ref.shape
                     else ref.numel())
    got_bands = np.asarray(gp.band_number)
    n = min(len(bands), len(got_bands))
    merged_faults += (int(np.sum(bands[:n] != got_bands[:n]))
                      + abs(len(bands) - len(got_bands)))
    return gas_faults, merged_faults, sv_gap
