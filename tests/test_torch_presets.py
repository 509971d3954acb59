"""The port's workflow presets (``ecckd_tpu_torch/pipeline/presets.py``)
against the JAX package's: every mode, application and band structure,
at tolerances on both sides of each threshold of the per-gas tweaks, and
the tables the orchestrator reads.  A configuration that one package
refuses, the other refuses with the same message."""

import itertools

import pytest

from ecckd_tpu.pipeline import presets as jax_presets
from ecckd_tpu_torch.pipeline import presets

BANDS = sorted(set(jax_presets.LW_BAND_STRUCTURES)
               | set(jax_presets.SW_BAND_STRUCTURES))
CASES = list(itertools.product(("lw", "sw"),
                               sorted(jax_presets.APPLICATIONS), BANDS))
TOLERANCES = (0.0047, 0.0161, 0.018, 0.03, 0.035, 0.05, 0.5)


def outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except ValueError as err:
        return "ValueError", str(err)


@pytest.mark.parametrize("mode,application,band", CASES)
def test_configuration_equals_jax(mode, application, band):
    assert outcome(presets.band_boundaries, mode, band) == outcome(
        jax_presets.band_boundaries, mode, band)
    for tolerance in TOLERANCES:
        got = outcome(presets.check_configuration, mode, application, band,
                      tolerance)
        want = outcome(jax_presets.check_configuration, mode, application,
                       band, tolerance)
        assert got == want, (tolerance, got, want)


def test_tables_and_refusals_equal_jax():
    for name in ("LW_BAND_STRUCTURES", "SW_BAND_STRUCTURES", "APPLICATIONS",
                 "LW_REFERENCE_TOLERANCES", "SW_REFERENCE_TOLERANCES"):
        assert getattr(presets, name) == getattr(jax_presets, name), name
    for args in (("mw", "climate", "narrow", 0.01),
                 ("lw", "climate", "narrow", None),
                 ("lw", "mesoscale", "narrow", 0.01),
                 ("lw", "climate", "rgb", 0.01)):
        got = outcome(presets.check_configuration, *args)
        assert got[0] == "ValueError"
        assert got == outcome(jax_presets.check_configuration, *args)
