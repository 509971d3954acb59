"""Synthetic line-by-line spectra, made on the device from a seed.

A torch rewrite of the host generators that drove the port before this
benchmark (``lw_spectrum``/``sw_spectrum`` of the repository's smoke
script, the solar spectrum of its test helpers): lines of varying
strength on a continuum, the optical depth of a layer proportional to the
gas's column mass and warmer layers more absorbing.  Two things are new.
Lines are pressure-broadened: each layer's spectrum interpolates, in log
pressure, between line sums at a few reference pressures, so layers sort
differently.  And the lines are a fixed set of each gas's configuration,
which the seed moves by less than a grid step: every value of the
spectrum changes from seed to seed, its statistics do not, so every seed
gives the search and the table the same amount of work.

Everything is made by a ``torch.Generator`` on the device, in a few large
calls.  The same seed on the same device gives the same bits.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

ACCEL_GRAVITY = 9.80665
MOLAR_MASS_AIR = 0.02897          # kg mol-1, as the smoke's generator
SURFACE_PRESSURE = 1.013e5
# Line sums per chunk: (lines, wavenumbers) temporaries of at most 512 MB
LINE_CHUNK = 64
WAV_BLOCK = 1 << 20
# The stream of fixed draws (line sizes) beside the seed's own streams
FIXED_STREAM = 7919


def generator(device, seed: int, stream: int) -> torch.Generator:
    """An independent generator for one purpose (``stream``) of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(stream)) % (1 << 63))
    return g


def _uniform(n, lo, hi, gen, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device,
                                       dtype=torch.float64)


def grid(wav_min, wav_max, nwav, device):
    """(wavenumber, d_wavenumber) of an even grid, cm-1."""
    wav = torch.linspace(wav_min, wav_max, nwav, dtype=torch.float64,
                         device=device)
    dwav = torch.full_like(wav, (wav_max - wav_min) / (nwav - 1))
    return wav, dwav


def levels(nlay, p_top, device):
    """Half-level pressures, log-spaced from ``p_top`` to the surface."""
    return torch.exp(torch.linspace(math.log(p_top),
                                    math.log(SURFACE_PRESSURE), nlay + 1,
                                    dtype=torch.float64, device=device))


def temperatures(nlay, t_top, t_surf, offset, device):
    """Half-level temperatures, linear in level index, shifted by
    ``offset`` K."""
    return torch.linspace(t_top + offset, t_surf + offset, nlay + 1,
                          dtype=torch.float64, device=device)


def _lines(gas, seed, wav, dwav, placed=False):
    """Centres, strengths and widths at the surface of the gas's lines.
    Their sizes and places come from the gas's fixed stream; the seed moves
    each centre by up to half a grid step, so that every seed samples
    every line at other points of the grid and the spectrum's statistics,
    which set the search's work, stay the same.  With ``placed`` the seed
    draws the sizes and places too, for readings of the check on spectra
    that differ in their structure from seed to seed."""
    n = int(gas["nlines"])
    device = wav.device
    fixed = generator(device, seed if placed else gas["fixed_seed"],
                      FIXED_STREAM)
    strength = 10.0 ** _uniform(n, *gas["log10_strength"], fixed, device)
    width = _uniform(n, *gas["width_cm"], fixed, device)
    windows = torch.tensor(gas["windows"], dtype=torch.float64,
                           device=device)
    pick = torch.multinomial(windows[:, 2], n, replacement=True,
                             generator=fixed)
    centre = windows[pick, 0] + (windows[pick, 1] - windows[pick, 0]) \
        * torch.rand(n, generator=fixed, device=device, dtype=torch.float64)
    own = generator(device, seed, gas["stream"])
    centre = centre + float(dwav[0]) * _uniform(n, -0.5, 0.5, own, device)
    return centre, strength, width


def line_sum(wav, centre, strength, width):
    """Lorentzian lines summed at each wavenumber, in blocks."""
    out = torch.empty_like(wav)
    for i0 in range(0, wav.numel(), WAV_BLOCK):
        w = wav[i0:i0 + WAV_BLOCK]
        acc = torch.zeros_like(w)
        for j0 in range(0, centre.numel(), LINE_CHUNK):
            x = (w[None, :] - centre[j0:j0 + LINE_CHUNK, None]) \
                / width[j0:j0 + LINE_CHUNK, None]
            acc += (strength[j0:j0 + LINE_CHUNK, None]
                    / (1.0 + x * x)).sum(0)
        out[i0:i0 + WAV_BLOCK] = acc
    return out


def absorption(gas, wav, dwav, p_fl, seed, placed=False):
    """(nlay, nwav) absorption of the gas per layer: line sums at the
    gas's reference pressures, widths scaled by pressure above a Doppler
    floor, interpolated in log pressure to each layer."""
    centre, strength, width = _lines(gas, seed, wav, dwav, placed)
    p_ref = torch.tensor(gas["reference_pressures_pa"], dtype=torch.float64,
                         device=wav.device)
    basis = []
    for p in p_ref.tolist():
        w = torch.clamp(width * (p / SURFACE_PRESSURE), min=gas["doppler_cm"])
        # Area-preserving: a narrower line is taller
        basis.append(line_sum(wav, centre, strength * width / w, w))
    basis = torch.stack(basis)                       # (nref, nwav)
    if len(p_ref) == 1:
        return basis.expand(len(p_fl), -1) + gas["continuum"]
    lp = torch.log(p_fl)
    lref = torch.log(p_ref)                          # descending
    # Each layer between two reference pressures (clamped at the ends)
    j = torch.clamp(torch.searchsorted(-lref, -lp), 1, len(p_ref) - 1)
    t = ((lref[j - 1] - lp) / (lref[j - 1] - lref[j])).clamp(0.0, 1.0)
    k = ((1.0 - t)[:, None] * basis[j - 1] + t[:, None] * basis[j])
    return k + gas["continuum"]


def optical_depth(gas, k, p_hl, t_hl):
    """(nlay, nwav) optical depth of one temperature profile."""
    col_mass = (p_hl[1:] - p_hl[:-1]) / ACCEL_GRAVITY / MOLAR_MASS_AIR
    t_fl = 0.5 * (t_hl[1:] + t_hl[:-1])
    scale = (gas["vmr"] * 1e-3 * col_mass
             * torch.exp(gas["temperature_coeff"] * (t_fl - 250.0)))
    return scale[:, None] * k


def solar(wav, dwav, seed):
    """The test helpers' solar spectrum (a Gaussian on a floor), with a
    ripple of 2% that the seed shifts by up to half a grid step,
    normalised to 1361 W m-2."""
    shift = float(dwav[0]) * _uniform(1, -0.5, 0.5,
                                      generator(wav.device, seed, 3),
                                      wav.device)
    ssi = 20.0 * torch.exp(-((wav - 20000.0) / 15000.0) ** 2) + 0.5
    ssi = ssi * (1.0 + 0.02 * torch.sin((wav + shift) / 500.0))
    return ssi * (1361.0 / ssi.sum())


def make(cfg, seed, device, offsets=None):
    """The configuration's spectra for ``seed``: a namespace with the grid,
    the half levels, per gas and temperature offset the profile
    (``profiles[gas][offset]``, each with ``pressure_hl``,
    ``temperature_hl``, ``wavenumber``, ``d_wavenumber``,
    ``optical_depth``, ``ncol``) and, in the shortwave, ``ssi``: numpy
    arrays on the host, as the port's array cores take them.  Where the
    configuration holds ``lines_placed_by_seed``, the seed places the lines
    (see :func:`_lines`); the cells' configurations never do."""
    wav, dwav = grid(cfg["wavenumber_min"], cfg["wavenumber_max"],
                     cfg["nwav"], device)
    p_hl = levels(cfg["nlay"], cfg["pressure_top_pa"], device)
    p_fl = 0.5 * (p_hl[1:] + p_hl[:-1])
    offsets = cfg["temperature_offsets_k"] if offsets is None else offsets
    host = lambda a: a.cpu().numpy()  # noqa: E731
    out = SimpleNamespace(wavenumber=host(wav), d_wavenumber=host(dwav),
                          pressure_hl=host(p_hl), profiles={}, ssi=None)
    for gas in cfg["gases"]:
        k = absorption(gas, wav, dwav, p_fl, seed,
                       bool(cfg.get("lines_placed_by_seed")))
        out.profiles[gas["name"]] = {}
        for off in offsets:
            t_hl = temperatures(cfg["nlay"], cfg["temperature_top_k"],
                                cfg["temperature_surface_k"], off, device)
            od = optical_depth(gas, k, p_hl, t_hl)
            out.profiles[gas["name"]][off] = SimpleNamespace(
                pressure_hl=out.pressure_hl, temperature_hl=host(t_hl),
                wavenumber=out.wavenumber, d_wavenumber=out.d_wavenumber,
                optical_depth=host(od), ncol=len(offsets))
            del od
        del k
    if cfg.get("shortwave"):
        out.ssi = host(solar(wav, dwav, seed))
    return out
