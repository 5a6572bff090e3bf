"""Event-driven multi-tenant rack simulator (`repro_torch.sim`).

The port's copy of ``repro.sim``, with the same exports.

Composes the allocator (`repro_torch.core.allocator`), the α–β collective cost
model (`repro_torch.core.cost_model`), and the elastic-recovery policy
(`repro_torch.runtime.fault_tolerance`) into a rack that evolves over time:
tenants arrive, train in compute→collective→reconfigure phases, depart,
and occasionally lose chips to failures.

Layers:
  * :mod:`repro_torch.sim.workload` — job/failure traces: synthetic generators
    (Poisson arrivals, heavy-tailed sizes, the paper's Fig 2a mix),
    serving specs (per-window request-load summaries for
    :mod:`repro_torch.serve`), and a replayable JSONL trace format.
  * :mod:`repro_torch.sim.engine` — the discrete-event loop plus the three
    fabric *disciplines* (LUMORPH / torus / SiPAC) it compares.
  * :mod:`repro_torch.sim.metrics` — acceptance, utilization, fragmentation,
    collective latency (MZI reconfiguration included), and per-tenant JCT.
"""

from repro_torch.sim.engine import (Discipline, RackSimulator, compare,
                              make_discipline, simulate)
from repro_torch.sim.metrics import SimMetrics, TenantRecord
from repro_torch.sim.workload import (CollectiveProfile, FailureSpec, JobSpec,
                                LoadWindow, ServeSpec, Trace, fig2a_trace,
                                pod_churn_trace, poisson_trace,
                                strip_profiles, zoo_trace)

__all__ = [
    "Discipline", "RackSimulator", "compare", "make_discipline", "simulate",
    "SimMetrics", "TenantRecord",
    "CollectiveProfile", "FailureSpec", "JobSpec", "LoadWindow", "ServeSpec",
    "Trace", "fig2a_trace", "pod_churn_trace", "poisson_trace",
    "strip_profiles", "zoo_trace",
]
