"""Multiprocess scenario sweep: thousands of heterogeneous rack/pod
simulations per CI run.

The port's copy of ``repro.sweep.runner``, line for line; its spawned
workers import ``repro_torch``.

A :class:`Scenario` is a frozen, picklable description of one end-to-end
:class:`~repro_torch.sim.engine.RackSimulator` run — seed, discipline,
rack/pod fabric, workload mix, morph/span policy.  :func:`sweep_grid`
builds the cross product, :func:`run_sweep` fans it across worker
processes (``spawn`` — workers never inherit a CUDA-initialized parent),
and :func:`pareto_report` folds the compact per-scenario summaries into
an acceptance/goodput/JCT/fragmentation table per *policy* (the
discipline × morph × span axes a fleet operator actually chooses).

Determinism contract: every scenario's summary is a pure function of the
scenario itself.  Traces are generated inside the worker from
``scenario.seed``; the simulator carries no hidden global state; pricer
warm-starting (:meth:`~repro_torch.core.pricing.SchedulePricer.seed_entries`)
installs values the cold run would compute bit-for-bit.  So a 4-worker
sweep returns byte-identical per-scenario summaries to the serial run of
the same grid — ``tests/test_torch_sim.py`` pins this.

Cache hygiene: scenarios sharing a worker also share the process-global
closed-form caches in :mod:`repro_torch.core.cost_model`.  That is safe (keys
are exact) and fast (warm across scenarios), but timing comparisons want
cold caches — pass ``fresh_caches=True`` and every scenario starts from
``clear_pricing_caches()``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

from repro_torch.core import cost_model as cm
from repro_torch.serve.requests import serve_trace
from repro_torch.sim.engine import RackSimulator
from repro_torch.sim.workload import (CollectiveProfile, Trace, fig2a_trace,
                                poisson_trace, strip_profiles, zoo_trace)

#: workload mixes a scenario may name; ``zoo`` prices every tenant by its
#: model's derived CollectiveProfile, ``zoo-generic`` is the *same trace*
#: with profiles stripped (the generic-ALLREDUCE control arm), and the
#: ``serve`` pair mixes request-scale inference tenants (diurnal or
#: bursty traffic, repro_torch.serve) with a training backdrop
WORKLOADS = ("poisson", "fig2a", "zoo", "zoo-generic", "serve",
             "serve-bursty")

#: placement policies a scenario may name (repro_torch.core.policy); the
#: default ``packing`` is the legacy heuristic, bit-identically
PLACEMENTS = ("packing", "locality", "future-morph")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One simulator run, fully determined by its fields (no hidden
    state): equal scenarios produce bit-identical summaries anywhere."""

    seed: int = 0
    discipline: str = "lumorph"
    n_chips: int = 64
    n_racks: int = 1
    span_racks: bool = True
    morph: bool = False
    workload: str = "zoo"
    n_jobs: int = 40
    arrival_rate: float = 0.5
    failure_rate: float = 0.02
    #: SLO-driven serving autoscaler (repro_torch.serve) — only meaningful for
    #: the ``serve*`` workloads on a photonic discipline
    autoscale: bool = False
    #: placement policy (repro_torch.core.policy) — photonic disciplines only;
    #: ``packing`` is the legacy default and leaves the tag unchanged
    placement: str = "packing"

    def __post_init__(self):
        if self.workload not in WORKLOADS:
            raise ValueError(
                f"unknown workload {self.workload!r}; have {WORKLOADS}")
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"unknown placement {self.placement!r}; have {PLACEMENTS}")

    @property
    def policy(self) -> str:
        """The operator-facing policy axes this scenario exercises."""
        tag = self.discipline
        if self.placement != "packing":
            tag += f"+{self.placement}"
        if self.morph:
            tag += "+morph"
        if self.autoscale:
            tag += "+autoscale"
        if self.n_racks > 1 and not self.span_racks:
            tag += "+confined"
        return tag

    @property
    def fabric_sig(self) -> tuple:
        """What a pricer cache entry's validity depends on: link model
        (via discipline) and rack geometry.  Warm-start entries only
        flow between scenarios with equal signatures."""
        return (self.discipline, self.n_chips, self.n_racks)

    @property
    def workload_class(self) -> str:
        """The axis claim_profiles_matter compares across: profiled
        (``zoo``) vs generic traces; serving scenarios report in their
        own class (their SLO economics are not a training comparison)."""
        if self.workload.startswith("serve"):
            return "serving"
        return "profiled" if self.workload == "zoo" else "generic"


def sweep_grid(*, seeds: Sequence[int] = (0, 1, 2, 3),
               disciplines: Sequence[str] = ("lumorph", "torus", "sipac"),
               fabrics: Sequence[tuple[int, int]] = ((64, 1),),
               workloads: Sequence[str] = ("zoo", "zoo-generic"),
               morphs: Sequence[bool] = (False, True),
               span_racks: Sequence[bool] = (True,),
               autoscales: Sequence[bool] = (False,),
               placements: Sequence[str] = ("packing",),
               n_jobs: int = 40, arrival_rate: float = 0.5,
               failure_rate: float = 0.02) -> list[Scenario]:
    """The scenario cross product, with degenerate combos dropped:
    morphing, autoscaling and placement policies are photonic-fabric
    capabilities (electrical duplicates are skipped), rack confinement
    needs a pod (``n_racks > 1``), and the autoscale axis only applies
    to the ``serve*`` workloads."""
    photonic = {"lumorph"}  # electrical disciplines ignore morph entirely
    out = []
    for seed in seeds:
        for disc in disciplines:
            for n_chips, n_racks in fabrics:
                for wl in workloads:
                    for morph in morphs:
                        if morph and disc not in photonic:
                            continue
                        if n_racks > 1 and disc not in photonic:
                            continue  # pod mode needs photonic rails
                        for span in span_racks:
                            if not span and n_racks <= 1:
                                continue
                            for auto in autoscales:
                                if auto and (disc not in photonic
                                             or not wl.startswith("serve")):
                                    continue
                                for pl in placements:
                                    if pl != "packing" \
                                            and disc not in photonic:
                                        continue
                                    out.append(Scenario(
                                        seed=seed, discipline=disc,
                                        n_chips=n_chips, n_racks=n_racks,
                                        span_racks=span, morph=morph,
                                        workload=wl, n_jobs=n_jobs,
                                        arrival_rate=arrival_rate,
                                        failure_rate=failure_rate,
                                        autoscale=auto, placement=pl))
    return out


def build_trace(s: Scenario,
                profiles: Sequence[CollectiveProfile]) -> Trace:
    """The scenario's trace, generated from its seed alone.  ``zoo`` and
    ``zoo-generic`` share one generator call so the control arm differs
    *only* in the profiles."""
    if s.workload == "poisson":
        return poisson_trace(s.n_jobs, arrival_rate=s.arrival_rate,
                             n_chips=s.n_chips,
                             failure_rate=s.failure_rate, seed=s.seed)
    if s.workload == "fig2a":
        return fig2a_trace(s.n_jobs, n_chips=s.n_chips,
                           failure_rate=s.failure_rate, seed=s.seed)
    if s.workload.startswith("serve"):
        # request-scale serving tenants + a small Poisson training
        # backdrop (the mixed-rack multi-tenancy story); specs derive
        # from profiles alone, so spawn workers never need configs/
        return serve_trace(
            2, profiles,
            pattern="bursty" if s.workload == "serve-bursty" else "diurnal",
            horizon_s=1800.0, window_s=60.0, base_rate=s.arrival_rate * 4,
            peak_rate=s.arrival_rate * 24, seed=s.seed,
            train_jobs=max(0, s.n_jobs // 8),
            train_arrival_rate=s.arrival_rate / 100.0)
    trace = zoo_trace(s.n_jobs, profiles, arrival_rate=s.arrival_rate,
                      n_chips=s.n_chips, failure_rate=s.failure_rate,
                      seed=s.seed)
    return strip_profiles(trace) if s.workload == "zoo-generic" else trace


def run_scenario(s: Scenario, profiles: Sequence[CollectiveProfile],
                 warm: Optional[dict] = None,
                 warm_limit: int = 512,
                 fresh_caches: bool = False) -> dict:
    """One scenario end-to-end → a compact, JSON-ready record.

    ``warm`` is a mutable ``{fabric_sig: [entries]}`` pool: the new
    simulator's pricer is seeded from it before the run and contributes
    its MRU entries back after — value-transparent, so results do not
    depend on what the pool happened to contain."""
    if fresh_caches:
        cm.clear_pricing_caches()
    trace = build_trace(s, profiles)
    t0 = time.perf_counter()
    sim = RackSimulator(s.discipline, trace, n_chips=s.n_chips,
                        morph=s.morph, n_racks=s.n_racks,
                        span_racks=s.span_racks,
                        serve_autoscale=s.autoscale,
                        policy=s.placement)
    seeded = 0
    if warm is not None:
        seeded = sim.pricer.seed_entries(warm.get(s.fabric_sig, ()))
    metrics = sim.run()
    wall_s = time.perf_counter() - t0
    if warm is not None:
        pool = dict(warm.get(s.fabric_sig, ()))
        pool.update(sim.pricer.export_entries(warm_limit))
        warm[s.fabric_sig] = list(pool.items())[-warm_limit:]
    rec = {
        "scenario": dataclasses.asdict(s),
        "policy": s.policy,
        "workload_class": s.workload_class,
        "summary": metrics.summary(),
        "pricing": metrics.pricing_summary(),
        # timing/debug channel: excluded from determinism comparisons
        "timing": {"wall_s": round(wall_s, 6), "warm_seeded": seeded},
    }
    if s.workload.startswith("serve"):
        rec["serve"] = metrics.serve_summary()
    return rec


# -- worker-process plumbing -------------------------------------------------
#: per-process state installed by the pool initializer: the derived
#: profile list (computed once in the parent — deriving needs configs/)
#: and this worker's private warm-entry pool
_WORKER_STATE: dict = {}


def _init_worker(profiles: Sequence[CollectiveProfile], warm: bool,
                 fresh_caches: bool) -> None:
    _WORKER_STATE["profiles"] = profiles
    _WORKER_STATE["warm"] = {} if warm else None
    _WORKER_STATE["fresh_caches"] = fresh_caches


def _run_one(s: Scenario) -> dict:
    return run_scenario(s, _WORKER_STATE["profiles"],
                        warm=_WORKER_STATE["warm"],
                        fresh_caches=_WORKER_STATE["fresh_caches"])


def default_profiles() -> list[CollectiveProfile]:
    """One derived profile per registered model, in name order (the order
    is part of the determinism contract — ``zoo_trace`` samples by
    index)."""
    from repro_torch.sharding.policy import zoo_profiles
    return [p for _, p in sorted(zoo_profiles().items())]


def run_sweep(scenarios: Sequence[Scenario], jobs: int = 1, *,
              profiles: Optional[Sequence[CollectiveProfile]] = None,
              warm: bool = True, fresh_caches: bool = False) -> list[dict]:
    """Run every scenario; results come back in scenario order regardless
    of worker scheduling.

    ``jobs > 1`` fans across a ``spawn`` pool — fresh interpreters, so
    the parent's torch/config state never leaks in and forked-lock hazards
    don't exist.  ``warm`` shares pricer cache entries between scenarios
    that run in the same process (serial: all of them); turn it off
    together with ``fresh_caches=True`` for cold-cache timing runs."""
    scenarios = list(scenarios)
    if profiles is None:
        profiles = default_profiles()
    profiles = tuple(profiles)
    if jobs <= 1 or len(scenarios) <= 1:
        _init_worker(profiles, warm, fresh_caches)
        try:
            return [_run_one(s) for s in scenarios]
        finally:
            _WORKER_STATE.clear()
    import multiprocessing as mp
    # spawn workers import repro_torch afresh: make sure the package root is on
    # their path even when the parent got it from pytest's pythonpath or
    # a script-local sys.path tweak rather than the environment
    import repro_torch
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    existing = os.environ.get("PYTHONPATH", "")
    if pkg_root not in existing.split(os.pathsep):
        os.environ["PYTHONPATH"] = (pkg_root + os.pathsep + existing
                                    if existing else pkg_root)
    ctx = mp.get_context("spawn")
    with ctx.Pool(jobs, initializer=_init_worker,
                  initargs=(profiles, warm, fresh_caches)) as pool:
        return pool.map(_run_one, scenarios, chunksize=1)


# -- report ------------------------------------------------------------------
#: the Pareto axes: (summary key, higher_is_better)
PARETO_METRICS = (
    ("acceptance_rate", True),
    ("goodput_chip_seconds", True),
    ("mean_jct_s", False),
    ("fragmentation_rejects", False),
)


def pareto_report(results: Sequence[dict]) -> dict:
    """Fold per-scenario summaries into per-policy aggregates and
    rankings, split by workload class.

    For each (workload class, policy) the report carries the scenario
    count and the mean of every Pareto metric; per class, policies are
    ranked on each metric (best first) and ``pareto_front`` lists the
    policies no other policy dominates on all four axes."""
    groups: dict[tuple[str, str], list[dict]] = {}
    for r in results:
        groups.setdefault((r["workload_class"], r["policy"]), []).append(
            r["summary"])
    classes = sorted({wc for wc, _ in groups})
    report: dict = {"n_scenarios": len(results), "classes": {}}
    for wc in classes:
        policies = {}
        for (gwc, pol), summaries in groups.items():
            if gwc != wc:
                continue
            agg = {"scenarios": len(summaries)}
            for key, _ in PARETO_METRICS:
                agg[key] = round(
                    sum(s[key] for s in summaries) / len(summaries), 6)
            policies[pol] = agg
        rankings = {}
        for key, hib in PARETO_METRICS:
            rankings[key] = sorted(policies,
                                   key=lambda p: policies[p][key],
                                   reverse=hib)
        def _ge(a: float, b: float, hib: bool) -> bool:
            return a >= b if hib else a <= b

        front = []
        for p in sorted(policies):
            dominated = any(
                all(_ge(policies[q][k], policies[p][k], hib)
                    for k, hib in PARETO_METRICS)
                and any(policies[q][k] != policies[p][k]
                        for k, _ in PARETO_METRICS)
                for q in policies if q != p)
            if not dominated:
                front.append(p)
        report["classes"][wc] = {"policies": policies,
                                 "rankings": rankings,
                                 "pareto_front": front}
    return report
