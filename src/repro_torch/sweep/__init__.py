"""Multiprocess scenario sweep over the rack/pod simulator — see
:mod:`repro_torch.sweep.runner` and ``docs/sweep.md``.

The port's copy of ``repro.sweep``, with the same exports.
"""

from repro_torch.sweep.runner import (PARETO_METRICS, Scenario, WORKLOADS,
                                build_trace, default_profiles,
                                pareto_report, run_scenario, run_sweep,
                                sweep_grid)

__all__ = ["PARETO_METRICS", "Scenario", "WORKLOADS", "build_trace",
           "default_profiles", "pareto_report", "run_scenario",
           "run_sweep", "sweep_grid"]
