"""Metrics accumulated by the rack simulator.

The port's copy of ``repro.sim.metrics``, line for line.

Everything is either an event counter or a *time integral* (utilization,
chip-seconds) advanced by the engine on every event, so metrics are exact
for the discrete-event semantics — no sampling error — and identical
runs produce bit-identical summaries (the determinism tests rely on it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TenantRecord:
    """Per-tenant outcome; one per *accepted* job."""

    tenant: str
    requested: int
    arrival: float
    granted: int  # chips actually held (torus may overallocate)
    completed: bool = False
    evicted: bool = False  # lost chips and the rack could not re-slice
    end: Optional[float] = None
    steps_done: int = 0
    collective_s: float = 0.0  # total ALLREDUCE time across the job
    reconfig_windows: int = 0  # MZI reprogramming windows charged
    shrunk_to: Optional[int] = None  # width after a shrinking recovery
    morphs: int = 0  # live transformations (compactions + bypasses + scales)
    morph_s: float = 0.0  # pause time charged to this tenant for morphing
    bypassed: int = 0  # failures absorbed by bypass instead of restart
    # serving tenants (repro_torch.serve) — zero for training tenants
    serve_requests: int = 0  # offered requests across the tenant's windows
    serve_slo_ok: float = 0.0  # of those, how many met both SLOs (analytic)
    scale_ups: int = 0  # autoscaler grow morphs committed
    scale_downs: int = 0  # autoscaler shrink morphs committed
    reroutes: int = 0  # collectives re-planned around fabric faults

    @property
    def jct(self) -> Optional[float]:
        return None if self.end is None else self.end - self.arrival

    @property
    def slo_attainment(self) -> float:
        return (self.serve_slo_ok / self.serve_requests
                if self.serve_requests else 0.0)


class SimMetrics:
    """Accumulator; the engine owns the clock and calls :meth:`advance`."""

    def __init__(self, n_chips: int):
        self.n_chips = n_chips
        # counters
        self.events = 0  # events processed by the engine
        self.arrivals = 0
        self.accepted = 0
        self.rejected = 0
        self.fragmentation_rejects = 0  # rejected although enough chips were free
        self.completed = 0
        self.evicted = 0
        self.failures_injected = 0  # chips killed
        self.recoveries = 0  # successful post-failure re-allocations
        self.reconfig_windows = 0
        # morphing (repro_torch.morph): live compaction / failure bypass
        self.compactions = 0
        self.bypasses = 0
        self.morph_s = 0.0  # total pause time charged for morphs
        self.morph_bytes = 0.0  # shard state shipped by morph Transfers
        self.morph_windows = 0  # MZI windows spent morphing
        #: per-step collective cost summed over compacted tenants, priced
        #: on the layout right before / right after each compaction — the
        #: defragmentation claim compares exactly these two
        self.compaction_step_s_before = 0.0
        self.compaction_step_s_after = 0.0
        # time integrals
        self.util_integral = 0.0  # ∫ utilization dt
        self.busy_chip_seconds = 0.0  # ∫ allocated_chips dt
        self.goodput_chip_seconds = 0.0  # ∫ requested_chips dt (accepted tenants)
        self.wasted_chip_seconds = 0.0  # ∫ overallocated_chips dt
        self.collective_s = 0.0
        self.compute_s = 0.0
        self.reconfig_s = 0.0
        #: ∫ mean over live tenants of (servers spanned / minimum servers
        #: their size needs) dt — 1.0 is perfect locality
        self.locality_integral = 0.0
        self.locality_time = 0.0  # time with ≥1 live tenant
        #: ∫ stranded free capacity dt: free chips on partially occupied
        #: servers (scattered spares raise future tenants' fiber costs
        #: even though LUMORPH can still use them; entirely-free servers
        #: contribute nothing)
        self.stranded_chip_seconds = 0.0
        self.horizon = 0.0  # last event time
        #: chips failed out of the pool over the run — utilization is
        #: computed over live (never-failed) chips, so this is the base
        #: shrinkage.  Kept out of summary() (goldens pin its key set);
        #: the engine fills it from ``allocator.retired`` after run().
        self.retired_chips = 0
        # pricing fast path (repro_torch.core.pricing), filled by the engine at
        # the end of run(); kept out of summary() so golden fixtures pin
        # simulation *semantics*, not planner implementation detail —
        # read them via pricing_summary()
        self.sched_cache_hits = 0
        self.sched_cache_misses = 0
        self.schedules_built = 0  # Schedule IRs constructed (cache misses)
        self.candidates_pruned = 0  # candidates skipped by lower bounds
        self.transfers_materialized = 0  # must stay 0: pricing is shape-only
        # serving (repro_torch.serve) — kept out of summary() so the bit-exact
        # golden fixtures stay pinned; read them via serve_summary()
        self.serve_windows = 0
        self.serve_requests = 0  # offered requests across all tenants
        self.serve_slo_ok = 0.0  # of those, how many met both SLOs
        self.serve_chip_seconds = 0.0  # ∫ serving-held chips dt (per window)
        self.scale_ups = 0  # autoscaler grow morphs
        self.scale_downs = 0  # autoscaler shrink morphs
        self.kv_handoff_bytes = 0.0  # prefill→decode KV shipped
        self.kv_handoff_s = 0.0  # KV handoff seconds summed over requests
        #: per-window (requests, seconds) samples for weighted quantiles
        self._ttft_p50: list[tuple[float, float]] = []
        self._ttft_p99: list[tuple[float, float]] = []
        self._tpot: list[tuple[float, float]] = []
        # fabric health (repro_torch.core.health) — kept out of summary() like
        # the serving/pricing blocks; read them via chaos_summary()
        self.fabric_faults = 0  # fabric fault events applied
        self.fabric_repairs = 0  # repair events applied
        self.repair_s_total = 0.0  # fault→repair downtime (matched pairs)
        self._matched_repairs = 0
        self.degraded_s = 0.0  # ∫ dt while any fault or glitch is live
        self.degraded_goodput_chip_seconds = 0.0  # goodput earned degraded
        self.reroutes = 0  # collectives re-planned around a fault
        self.ocs_retries = 0.0  # circuit-establishment retries (expected)
        self.ocs_delay_s = 0.0  # establishment delay added by glitches
        self.ocs_escalations = 0  # retry-exhausted glitches made permanent
        self._ocs_delay_samples: list[float] = []
        # per-tenant
        self.tenants: dict[str, TenantRecord] = {}
        self._collective_samples = 0

    # -- integrals -----------------------------------------------------------
    def advance(self, dt: float, allocated: int, requested: int,
                locality: Optional[float] = None,
                stranded: int = 0, degraded_s: float = 0.0) -> None:
        """Advance the clock by ``dt`` with ``allocated`` chips held by
        tenants that requested ``requested`` chips in total.  ``locality``
        is the live tenants' mean span ratio (None when no tenant is
        live); ``stranded`` counts scattered free chips (see
        :attr:`stranded_chip_seconds`); ``degraded_s`` is how much of
        ``dt`` the fabric spent with a live fault or glitch."""
        if dt <= 0:
            return
        self.util_integral += dt * (allocated / self.n_chips if self.n_chips else 0.0)
        self.busy_chip_seconds += dt * allocated
        self.goodput_chip_seconds += dt * requested
        self.wasted_chip_seconds += dt * (allocated - requested)
        if locality is not None:
            self.locality_integral += dt * locality
            self.locality_time += dt
        self.stranded_chip_seconds += dt * stranded
        if degraded_s > 0.0:
            self.degraded_s += degraded_s
            self.degraded_goodput_chip_seconds += degraded_s * requested

    # -- phase accounting ----------------------------------------------------
    def on_collective(self, rec: TenantRecord, seconds: float) -> None:
        self.collective_s += seconds
        rec.collective_s += seconds
        self._collective_samples += 1

    def on_reconfig(self, rec: TenantRecord, seconds: float) -> None:
        self.reconfig_s += seconds
        self.reconfig_windows += 1
        rec.reconfig_windows += 1

    def on_morph(self, rec: TenantRecord, kind: str, seconds: float,
                 bytes_moved: float, windows: int,
                 old_step_s: float = 0.0, new_step_s: float = 0.0) -> None:
        """Account one committed morph (``kind`` ∈ compaction|bypass):
        the pause charged to the tenant, the shard bytes its Transfers
        shipped, and the MZI windows spent."""
        self.morph_s += seconds
        self.morph_bytes += bytes_moved
        self.morph_windows += windows
        self.reconfig_windows += windows
        rec.morphs += 1
        rec.morph_s += seconds
        rec.reconfig_windows += windows
        if kind == "compaction":
            self.compactions += 1
            self.compaction_step_s_before += old_step_s
            self.compaction_step_s_after += new_step_s
        elif kind == "bypass":
            self.bypasses += 1
            rec.bypassed += 1
        elif kind == "scale_up":
            self.scale_ups += 1
            rec.scale_ups += 1
        elif kind == "scale_down":
            self.scale_downs += 1
            rec.scale_downs += 1
        else:
            raise ValueError(f"unknown morph kind {kind!r}")

    def on_serve_window(self, rec: TenantRecord, stats, chips: int,
                        duration: float) -> None:
        """Account one finished load window: ``stats`` is a
        :class:`repro_torch.serve.tenant.WindowStats`; ``chips`` is the slice
        size that served it (the chip-hour ledger the provisioning
        comparison keys on)."""
        self.serve_windows += 1
        self.serve_requests += stats.requests
        self.serve_slo_ok += stats.slo_ok
        self.serve_chip_seconds += chips * duration
        self.kv_handoff_bytes += stats.kv_bytes
        self.kv_handoff_s += stats.kv_s
        if stats.requests:
            self._ttft_p50.append((stats.requests, stats.ttft_p50_s))
            self._ttft_p99.append((stats.requests, stats.ttft_p99_s))
            self._tpot.append((stats.requests, stats.tpot_s))
        rec.serve_requests += stats.requests
        rec.serve_slo_ok += stats.slo_ok

    def on_reroute(self, rec: TenantRecord) -> None:
        """One collective re-planned (re-priced or re-routed) because a
        fabric fault or repair changed what its circuits cost."""
        self.reroutes += 1
        rec.reroutes += 1

    def on_repair(self, downtime_s: Optional[float]) -> None:
        """One repair event applied; ``downtime_s`` is the fault→repair
        interval when the matching fault was seen this run (None for
        repairs of already-cleared state, which count but carry no MTTR
        sample)."""
        self.fabric_repairs += 1
        if downtime_s is not None:
            self.repair_s_total += downtime_s
            self._matched_repairs += 1

    def on_ocs(self, delay_s: float, retries: float) -> None:
        """One circuit-establishment attempt that hit a live OCS glitch:
        ``delay_s`` of retry/backoff (or stall) charged, ``retries``
        expected re-attempts."""
        self.ocs_delay_s += delay_s
        self.ocs_retries += retries
        self._ocs_delay_samples.append(delay_s)

    # -- summaries -----------------------------------------------------------
    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.arrivals if self.arrivals else 0.0

    @property
    def mean_utilization(self) -> float:
        return self.util_integral / self.horizon if self.horizon else 0.0

    @property
    def mean_collective_us(self) -> float:
        """Mean per-step ALLREDUCE latency in µs — the Fig 4b-comparable
        number (MZI reconfiguration already inside the α of each round)."""
        if not self._collective_samples:
            return 0.0
        return 1e6 * self.collective_s / self._collective_samples

    @property
    def mean_locality(self) -> float:
        """Time-weighted mean span ratio of live tenants (1.0 = every
        tenant on the fewest servers its size allows)."""
        return (self.locality_integral / self.locality_time
                if self.locality_time else 1.0)

    @property
    def mean_stranded_chips(self) -> float:
        """Time-weighted mean count of scattered free chips."""
        return self.stranded_chip_seconds / self.horizon if self.horizon else 0.0

    @property
    def compaction_gain_s(self) -> float:
        """Per-step collective seconds saved across all compactions."""
        return self.compaction_step_s_before - self.compaction_step_s_after

    @property
    def sched_cache_hit_rate(self) -> float:
        """Fraction of schedule-pricing lookups served from the pricer's
        canonical-layout cache."""
        total = self.sched_cache_hits + self.sched_cache_misses
        return self.sched_cache_hits / total if total else 0.0

    def pricing_summary(self) -> dict:
        """Planner fast-path counters (separate from :meth:`summary` so
        the bit-exact golden fixtures keep pinning simulation semantics
        only).  ``transfers_materialized`` must be 0 for any run that
        only prices — Transfer tables exist for execution alone."""
        return {
            "sched_cache_hits": self.sched_cache_hits,
            "sched_cache_misses": self.sched_cache_misses,
            "sched_cache_hit_rate": round(self.sched_cache_hit_rate, 6),
            "schedules_built": self.schedules_built,
            "candidates_pruned": self.candidates_pruned,
            "transfers_materialized": self.transfers_materialized,
        }

    @property
    def slo_attainment(self) -> float:
        """Fraction of all offered serving requests that met both SLOs."""
        return (self.serve_slo_ok / self.serve_requests
                if self.serve_requests else 0.0)

    def serve_summary(self) -> dict:
        """Serving metrics (repro_torch.serve) — a separate method, like
        :meth:`pricing_summary`, so :meth:`summary` and the golden trace
        fixtures built on it stay byte-identical.  Latency percentiles
        mix per-window analytic quantiles request-weighted: the p50 is
        the weighted median of window p50s, the p99 the weighted 99th
        percentile of window p99s — an upper-bound blend (a window's p99
        stands in for its whole tail)."""
        from repro_torch.serve.metrics import (GOODPUT_PER_CHIP_S, SLO_ATTAINMENT,
                                         TPOT_P50_S, TPOT_P99_S, TTFT_P50_S,
                                         TTFT_P99_S, weighted_quantile)
        goodput = (self.serve_slo_ok / self.serve_chip_seconds
                   if self.serve_chip_seconds else 0.0)
        return {
            "serve_tenants": sum(1 for r in self.tenants.values()
                                 if r.serve_requests),
            "serve_windows": self.serve_windows,
            "serve_requests": self.serve_requests,
            SLO_ATTAINMENT: round(self.slo_attainment, 6),
            TTFT_P50_S: round(weighted_quantile(self._ttft_p50, 0.50), 6),
            TTFT_P99_S: round(weighted_quantile(self._ttft_p99, 0.99), 6),
            TPOT_P50_S: round(weighted_quantile(self._tpot, 0.50), 9),
            TPOT_P99_S: round(weighted_quantile(self._tpot, 0.99), 9),
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "serve_chip_seconds": round(self.serve_chip_seconds, 3),
            GOODPUT_PER_CHIP_S: round(goodput, 9),
            "kv_handoff_bytes": round(self.kv_handoff_bytes, 3),
            "kv_handoff_s": round(self.kv_handoff_s, 9),
        }

    @property
    def availability(self) -> float:
        """Fraction of the run the fabric was fully healthy (no permanent
        fault, no live glitch window)."""
        if not self.horizon:
            return 1.0
        return max(0.0, 1.0 - self.degraded_s / self.horizon)

    @property
    def mttr_s(self) -> float:
        """Mean fault→repair interval over repairs whose fault was
        observed this run."""
        return (self.repair_s_total / self._matched_repairs
                if self._matched_repairs else 0.0)

    @property
    def ocs_delay_p99_s(self) -> float:
        """Nearest-rank p99 of per-establishment glitch delay samples."""
        if not self._ocs_delay_samples:
            return 0.0
        ordered = sorted(self._ocs_delay_samples)
        k = max(0, -(-len(ordered) * 99 // 100) - 1)  # ceil(.99 n) - 1
        return ordered[k]

    def chaos_summary(self) -> dict:
        """Fabric-health metrics (repro_torch.core.health) — a separate method,
        like :meth:`pricing_summary`/:meth:`serve_summary`, so
        :meth:`summary` and the golden fixtures built on it stay
        byte-identical for fault-free runs."""
        return {
            "fabric_faults": self.fabric_faults,
            "repairs": self.fabric_repairs,
            "degraded_s": round(self.degraded_s, 6),
            "availability": round(self.availability, 6),
            "mttr_s": round(self.mttr_s, 6),
            "reroutes": self.reroutes,
            "retries": round(self.ocs_retries, 6),
            "ocs_escalations": self.ocs_escalations,
            "ocs_delay_s": round(self.ocs_delay_s, 9),
            "ocs_delay_p99_s": round(self.ocs_delay_p99_s, 9),
            "degraded_goodput_chip_seconds":
                round(self.degraded_goodput_chip_seconds, 3),
        }

    @property
    def mean_jct(self) -> float:
        jcts = [r.jct for r in self.tenants.values() if r.jct is not None and r.completed]
        return sum(jcts) / len(jcts) if jcts else 0.0

    def summary(self) -> dict:
        return {
            "n_chips": self.n_chips,
            "events": self.events,
            "arrivals": self.arrivals,
            "accepted": self.accepted,
            "rejected": self.rejected,
            "acceptance_rate": round(self.acceptance_rate, 6),
            "fragmentation_rejects": self.fragmentation_rejects,
            "completed": self.completed,
            "evicted": self.evicted,
            "failures_injected": self.failures_injected,
            "recoveries": self.recoveries,
            "mean_utilization": round(self.mean_utilization, 6),
            "goodput_chip_seconds": round(self.goodput_chip_seconds, 3),
            "wasted_chip_seconds": round(self.wasted_chip_seconds, 3),
            "mean_collective_us": round(self.mean_collective_us, 3),
            "reconfig_windows": self.reconfig_windows,
            "reconfig_s": round(self.reconfig_s, 9),
            "mean_jct_s": round(self.mean_jct, 6),
            "horizon_s": round(self.horizon, 6),
            "compactions": self.compactions,
            "bypasses": self.bypasses,
            "morph_s": round(self.morph_s, 9),
            "morph_bytes": round(self.morph_bytes, 3),
            "morph_windows": self.morph_windows,
            "compaction_gain_s": round(self.compaction_gain_s, 9),
            "mean_locality": round(self.mean_locality, 6),
            "mean_stranded_chips": round(self.mean_stranded_chips, 6),
        }

    def csv_rows(self, prefix: str) -> list[str]:
        """``name,us_per_call,derived`` rows in the benchmark harness format."""
        s = self.summary()
        keys = ("acceptance_rate", "fragmentation_rejects", "mean_utilization",
                "goodput_chip_seconds", "wasted_chip_seconds",
                "mean_collective_us", "reconfig_windows", "mean_jct_s",
                "completed", "evicted", "recoveries", "events",
                "compactions", "bypasses", "morph_s", "mean_locality")
        return [f"{prefix}/{k},,{s[k]}" for k in keys]
