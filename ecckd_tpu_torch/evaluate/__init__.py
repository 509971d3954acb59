"""Evaluation metrics for CKD models (TPU-framework equivalent of the
reference's Matlab ``plot/`` scripts — SURVEY.md §1 auxiliary row, §4
"numerical evaluation as acceptance test").

The port's own copy of ``ecckd_tpu/evaluate``: the port imports nothing of
the JAX package."""

from .metrics import (calc_hr, calc_hr_error, flux_stats, evaluate_fluxes,
                      accuracy_efficiency_table, format_stats)

__all__ = ["calc_hr", "calc_hr_error", "flux_stats", "evaluate_fluxes",
           "accuracy_efficiency_table", "format_stats"]
