"""The least time of a kernel's work, from the shapes of its launch.

A copy of the repository smoke script's roofline arithmetic, so that the
yardstick lives with the benchmark, with one change: a launch needs only
the wavenumbers that its intervals cover (a probe of the search covers a
part of the band, and the kernels skip the rest), so bytes and operations
per wavenumber count those, not the band's.  Bytes count each input read
once and each output written once, whatever the kernel reads again;
operations count what the inputs need.  The peaks are NVIDIA's data-sheet
figures of one H100 SXM at its full 700 W: 3.35 TB/s of HBM, 67 TFLOP/s
in float32 and 34 TFLOP/s in float64 outside the tensor cores.  A share
of the roofline is the sum of the launches' least times over the sum of
their device times.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {4: 67e12, 8: 34e12}          # by element size in bytes
# Operations per layer and wavenumber of the LW sweep (od, emissivity and
# factor with their clamps, two sources, two recurrences), of the SW
# direct beam (od, running sum, product by the secant, exp, product) and
# of the SW sweep with its reflected beam (two running sums, two exps and
# products).
LW_LAYER_OPS = 21
SW_DOWN_LAYER_OPS = 5
SW_LAYER_OPS = 9


def memberships(i1, i2, n):
    """Wavenumbers summed over all intervals, each counted once for every
    interval that holds it."""
    lo = np.maximum(np.asarray(i1, np.int64), 0)
    hi = np.minimum(np.asarray(i2, np.int64), n - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def covered(i1, i2, n):
    """Wavenumbers in the union of the intervals, clamped to [0, n)."""
    lo = np.maximum(np.asarray(i1, np.int64), 0)
    hi = np.minimum(np.asarray(i2, np.int64), n - 1)
    total, end = 0, -1
    for a, b in sorted(zip(lo.tolist(), hi.tolist())):
        if b < a or b <= end:
            continue
        total += b - max(a, end + 1) + 1
        end = b
    return total


def least_seconds(nbytes, ops, elem):
    """The larger of the bytes over the memory rate and the operations
    over the peak rate of ``elem``-byte floats."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[elem])


def lw_sweep(nlay, n, i1, i2, elem):
    """K1: planck (nlay + 1 rows), bg_od and od_fit read, surface
    emissivity and Planck, the int32 partition map and bounds, two flux
    rows per level written per interval."""
    nseg = len(i1)
    m = memberships(i1, i2, n)
    n = covered(i1, i2, n)
    nbytes = (elem * ((nlay + 1) * n + nlay * n + nlay * nseg + 2 * n
                      + 2 * (nlay + 1) * nseg) + 4 * (n + 2 * nseg))
    ops = LW_LAYER_OPS * nlay * n + 2 * (nlay + 1) * m
    return least_seconds(nbytes, ops, elem)


def sw_sweep(nlay, n, i1, i2, elem, upwelling):
    """K2: with the reflected beam ssi, albedo, bg_od, od_fit and two flux
    rows per level; without it ssi, bg_od, od_fit and one row."""
    nseg = len(i1)
    m = memberships(i1, i2, n)
    n = covered(i1, i2, n)
    if upwelling:
        nbytes = (elem * (2 * n + nlay * n + nlay * nseg
                          + 2 * (nlay + 1) * nseg) + 4 * (n + 2 * nseg))
        ops = SW_LAYER_OPS * nlay * n + 2 * (nlay + 1) * m
    else:
        nbytes = (elem * (n + nlay * n + nlay * nseg + (nlay + 1) * nseg)
                  + 4 * (n + 2 * nseg))
        ops = SW_DOWN_LAYER_OPS * nlay * n + (nlay + 1) * m
    return least_seconds(nbytes, ops, elem)


def row_sums(rows, n, nprod, i1, i2, elem):
    """K3: ``rows`` operand rows read once, ``nprod`` products per
    wavenumber, each output row summed per interval."""
    nseg = len(i1)
    m = memberships(i1, i2, n)
    n = covered(i1, i2, n)
    nbytes = elem * (rows * n + rows * nseg) + 4 * 2 * nseg
    ops = nprod * n + rows * m
    return least_seconds(nbytes, ops, elem)


def k3_rows(nlay, total_transmission):
    """Operand rows and products of one probe's K3 launch: the LW fit
    (metric x Planck, Planck), the truth's heating rates and two boundary
    fluxes; the SW total-transmission fit (2 nlay + 1 direct-flux levels,
    od x ssi, ssi) and the truth of its two scaled runs."""
    if total_transmission:
        return 5 * nlay + 6, nlay
    return 3 * nlay + 2, nlay
