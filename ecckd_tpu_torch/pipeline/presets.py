"""CKDMIP workflow presets: band structures, applications, validation.

TPU-native equivalent of the reference's L4 preset layer:

- Band-structure wavenumber boundaries from ``test/config.h:138-168`` —
  the CKDMIP band definitions shared by every step script
  (``test/reorder_spectrum_lw.sh:52-66``, ``reorder_spectrum_sw.sh:56-106``).
- Application settings (``test/check_configuration.h:36-57``): the
  "application" choice fixes ``min_pressure`` (Pa above which errors are
  ignored) and, for climate, the multi-pass optimize mode list
  (``test/do_all_lw.sh:40-48``).
- Per-band-structure g-point minima / split tweaks hardwired in the step
  scripts (``test/find_g_points_sw.sh:44-84``,
  ``test/find_g_points_lw.sh:342-358``).

All boundaries are wavenumbers in cm^-1; a band structure is a pair of
equal-length lists (lower bounds, upper bounds).

The port's own copy of ``ecckd_tpu/pipeline/presets.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Band structures (test/config.h:141-168). "fsck" = full-spectrum
# correlated-k: a single band spanning the whole spectral range
# (reorder scripts pass no boundaries, reorder_spectrum_lw.sh:48-50).
# ---------------------------------------------------------------------------

LW_BAND_STRUCTURES: Dict[str, Tuple[List[float], List[float]]] = {
    "fsck": ([], []),
    "narrow": (
        [0, 350, 500, 630, 700, 820, 980, 1080, 1180, 1390, 1480, 1800, 2080],
        [350, 500, 630, 700, 820, 980, 1080, 1180, 1390, 1480, 1800, 2080, 3260],
    ),
    "wide": (
        [0, 500, 820, 1180, 1800],
        [500, 820, 1180, 1800, 3260],
    ),
    # Radiance (channel) band structures (do_all_lw_radiance.sh:28-44):
    # monochromatic per-channel models for remote sensing; band order
    # follows the reference's channel listing (by nominal wavelength),
    # not ascending wavenumber.
    "microwave": ([1.03071, 5.47379], [1.03738, 5.60054]),   # 31/166 GHz
    "msi": ([1084, 885, 800], [1195, 976, 870]),       # MSI thermal
    "modis": ([1450, 1149, 887, 815], [1530, 1190, 928, 850]),
}

SW_BAND_STRUCTURES: Dict[str, Tuple[List[float], List[float]]] = {
    "fsck": ([], []),
    "narrow": (
        [250, 2600, 3250, 4000, 4650, 5150, 6150, 8050, 12850, 16000,
         22650, 29000, 38000],
        [2600, 3250, 4000, 4650, 5150, 6150, 8050, 12850, 16000, 22650,
         29000, 38000, 50000],
    ),
    "wide": (
        [250, 4000, 8050, 16000, 29000],
        [4000, 8050, 16000, 29000, 50000],
    ),
    "double": ([250, 16000], [16000, 50000]),
    "rgb": (
        [250, 14300, 16650, 20000, 25000],
        [14300, 16650, 20000, 25000, 50000],
    ),
    "gb": (
        [250, 8000, 16650, 20000, 25000],
        [8000, 16650, 20000, 25000, 50000],
    ),
    "fine": (
        [250, 3750, 5350, 7150, 8700, 10650, 12100, 13350, 14300, 15400,
         16650, 18200, 20000, 22200, 25000, 28550, 30250, 30750, 31250,
         31750, 32250, 32750, 33250, 33750, 34250],
        [3750, 5350, 7150, 8700, 10650, 12100, 13350, 14300, 15400, 16650,
         18200, 20000, 22200, 25000, 28550, 30250, 30750, 31250, 31750,
         32250, 32750, 33250, 33750, 34250, 50000],
    ),
    "vfine": (
        [250, 2600, 3750, 5350, 7150, 8700, 10650, 12100, 13350, 13800,
         14300, 14800, 15400, 16000, 16650, 17400, 18200, 19050, 20000,
         21050, 22200, 23550, 25000, 26300, 26650, 27050, 27400, 27800,
         28150, 28550, 29000, 29400, 29850, 30300, 30750, 31250, 31750,
         32250, 32800, 33350, 33900, 34500, 35100, 35700],
        [2600, 3750, 5350, 7150, 8700, 10650, 12100, 13350, 13800, 14300,
         14800, 15400, 16000, 16650, 17400, 18200, 19050, 20000, 21050,
         22200, 23550, 25000, 26300, 26650, 27050, 27400, 27800, 28150,
         28550, 29000, 29400, 29850, 30300, 30750, 31250, 31750, 32250,
         32800, 33350, 33900, 34500, 35100, 35700, 50000],
    ),
    "window": (
        [250, 3750, 5350, 7150, 8700, 10650, 14300, 16650, 20000, 25000,
         28550, 30250, 30750, 31250, 31750, 32250, 32750, 33250, 33750],
        [3750, 5350, 7150, 8700, 10650, 14300, 16650, 20000, 25000, 28550,
         30250, 30750, 31250, 31750, 32250, 32750, 33250, 33750, 50000],
    ),
    # Radiance (channel) band structures (do_all_sw_radiance.sh:20-29)
    "msi": ([14706, 11429, 5970, 4425], [15152, 11696, 6154, 4630]),
    "modis": (
        [23810, 20877, 17699, 14925, 11416, 8000, 6053, 4640],
        [24691, 21882, 18349, 16129, 11891, 8130, 6143, 4751],
    ),
    # UV-extended structures (test/config.h:165-168): "window" with an
    # extra 50000-86000 band, and the photolysis structure covering the
    # Hartley ozone and Schumann-Runge oxygen bands.
    "window-uv": (
        [250, 3750, 5350, 7150, 8700, 10650, 14300, 16650, 20000, 25000,
         28550, 30250, 30750, 31250, 31750, 32250, 32750, 33250, 33750,
         50000],
        [3750, 5350, 7150, 8700, 10650, 14300, 16650, 20000, 25000, 28550,
         30250, 30750, 31250, 31750, 32250, 32750, 33250, 33750, 50000,
         86000],
    ),
    "photolysis": (
        [13250, 14300, 16650, 20000, 25000, 28550, 30250, 30750, 31250,
         31750, 32250, 32750, 33250, 33750, 44000, 48000],
        [14300, 16650, 20000, 25000, 28550, 30250, 30750, 31250, 31750,
         32250, 32750, 33250, 33750, 44000, 48000, 86000],
    ),
}

# ---------------------------------------------------------------------------
# Applications (test/check_configuration.h:36-57): min_pressure is the
# pressure (Pa) above which heating-rate errors count; limited-area NWP
# models have a low top so ignore errors above 4 hPa. For climate, the
# multi-pass optimization order of do_all_lw.sh:40-44.
# ---------------------------------------------------------------------------

APPLICATIONS: Dict[str, Dict[str, object]] = {
    "climate": {
        "app": "climate",
        "min_pressure": 2.0,
        "optimize_modes": ["relative-base", "relative-ch4",
                           "relative-n2o", "relative-cfc"],
    },
    "global-nwp": {
        "app": "nwp",
        "min_pressure": 2.0,
        "optimize_modes": [],
    },
    "limited-area-nwp": {
        "app": "nwp",
        "min_pressure": 400.0,
        "optimize_modes": [],
    },
    # Radiance workflow (do_all_lw_radiance.sh:14-34 + the
    # nwp-microwave configs of find_g_points_lw.sh:286-320 /
    # create_lut_lw.sh:202-232): per-channel models for remote sensing
    # are monochromatic, so no optimization step runs; the g-point
    # search uses zero flux weight and a tighter tolerance_tolerance.
    "nwp-microwave": {
        "app": "nwp-microwave",
        "min_pressure": 2.0,
        "optimize_modes": [],
        "monochromatic": True,
        "defaults": {
            "flux_weight": "0.0",
            "tolerance_tolerance": "0.015",
            "averaging_method": "transmission",
        },
    },
}

# Reference tolerance -> g-point-count lookup published in the master
# scripts as comments (test/do_all_lw.sh:59-75, do_all_sw.sh:44-90):
# useful defaults when a user asks for "the 64-point narrow model".
LW_REFERENCE_TOLERANCES: Dict[str, Dict[int, float]] = {
    "fsck": {12: 0.11, 16: 0.061, 20: 0.043, 24: 0.03, 28: 0.02,
             32: 0.0161, 36: 0.013, 40: 0.0105, 48: 0.00732, 64: 0.0047},
    "narrow": {64: 0.013, 128: 0.003},
    "wide": {64: 0.0083},
}
SW_REFERENCE_TOLERANCES: Dict[str, Dict[int, float]] = {
    "narrow": {64: 0.019},
    "rgb": {32: 0.055},
    "wide": {32: 0.04},
}


def band_boundaries(mode: str, name: str) -> Tuple[List[float], List[float]]:
    """Wavenumber boundary lists (wn1, wn2) for a named band structure.

    ``mode`` is "lw" or "sw". An empty pair means full-spectrum (fsck).
    Raises ``ValueError`` for unknown names, mirroring the reference's
    BANNER_ERROR exits (check_configuration.h:16-33).
    """
    table = LW_BAND_STRUCTURES if mode == "lw" else SW_BAND_STRUCTURES
    if name not in table:
        raise ValueError(
            f"band_structure '{name}' not understood for mode '{mode}'; "
            f"choose from {sorted(table)}")
    return table[name]


def gas_preset_options(mode: str, band_structure: str,
                       tolerance: float) -> Dict[str, Dict[str, str]]:
    """Per-gas find_g_points tweaks hardwired by the reference scripts.

    Returns {gas: {option: value}} to be merged into per-gas config
    sections unless the user set them explicitly. Sources:

    - LW fsck: >=3 CH4 g-points when tol < 0.018, split the H2O base
      g-point when tol < 0.035 (find_g_points_lw.sh:342-358).
    - SW rgb/gb: >=3 O3 g-points in the UV band; fine/vfine/window:
      CH4/N2O/O3 minima (find_g_points_sw.sh:56-78).
    """
    out: Dict[str, Dict[str, str]] = {}

    def setopt(gas: str, key: str, val: str):
        out.setdefault(gas, {})[key] = val

    if mode == "lw" and band_structure == "fsck":
        if tolerance < 0.018:
            setopt("ch4", "min_g_points", "3")
        if tolerance < 0.035:
            setopt("h2o", "base_split", "2")
    elif mode == "sw":
        if band_structure in ("rgb", "gb"):
            setopt("o3", "min_g_points", "1 1 1 1 3")
        elif band_structure == "fine":
            setopt("ch4", "min_g_points", "2")
            setopt("n2o", "min_g_points", "3")
            setopt("o3", "min_g_points", " ".join(["1"] * 24 + ["4"]))
        elif band_structure == "vfine":
            setopt("ch4", "min_g_points", "2")
            setopt("n2o", "min_g_points", "3")
            setopt("o3", "min_g_points", " ".join(["1"] * 43 + ["5"]))
        elif band_structure == "window":
            setopt("ch4", "min_g_points", "2")
            setopt("n2o", "min_g_points", "2")
            setopt("o3", "min_g_points", " ".join(["1"] * 18 + ["4"]))
        elif band_structure == "photolysis":
            # Reference encodes the Hartley-band O3 minimum in the final
            # tolerance digit (find_g_points_sw.sh:44-52); we expose it as
            # an explicit option with the same default position (band 14).
            setopt("o3", "min_g_points", " ".join(["1"] * 13 + ["4", "1", "1"]))
    return out


def application_settings(application: str) -> Dict[str, object]:
    """Validated application settings (check_configuration.h:36-57)."""
    if application not in APPLICATIONS:
        raise ValueError(
            f"application '{application}' not understood; choose from "
            f"{sorted(APPLICATIONS)}")
    return dict(APPLICATIONS[application])


def check_configuration(mode: str, application: str, band_structure: str,
                        tolerance: Optional[float]) -> Dict[str, object]:
    """Validate a workflow configuration, returning resolved settings.

    Mirrors test/check_configuration.h: TOLERANCE, APPLICATION and
    BAND_STRUCTURE must all be present and understood.
    """
    if mode not in ("lw", "sw"):
        raise ValueError(f"mode '{mode}' not understood (lw or sw)")
    if tolerance is None:
        raise ValueError("'tolerance' not specified")
    settings = application_settings(application)
    wn1, wn2 = band_boundaries(mode, band_structure)
    settings["wavenumber1"] = wn1
    settings["wavenumber2"] = wn2
    settings["gas_options"] = gas_preset_options(mode, band_structure,
                                                 float(tolerance))
    return settings
