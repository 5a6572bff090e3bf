"""Discrete-event rack simulator (paper §3–§4 composed over time).

The port's copy of ``repro.sim.engine``, line for line in its arithmetic
and its event order, so that every ``SimMetrics`` field equals the
reference's to the bit. It is host code: it takes no device and makes no
tensor.

One :class:`RackSimulator` replays a :class:`~repro_torch.sim.workload.Trace`
against one allocator *discipline*:

  * **arrival** — the tenant asks the allocator for ``k`` chips; a reject
    is final (no queueing — the paper's Fig 2a semantics).  An accepted
    tenant pays one MZI reconfiguration window to establish its circuits,
    then starts stepping.
  * **compute → collective** — every training step is a compute phase of
    ``compute_s`` seconds followed by a gradient ALLREDUCE priced from
    the **Schedule IR built on the tenant's actual chips**: the chip set
    is locality-ordered (:func:`repro_torch.core.scheduler.order_for_locality`),
    each candidate schedule is validated against the rack's photonic TRX
    limits, and rounds whose inter-server circuit demand exceeds the
    fiber budget are charged fiber time-sharing — so placement quality
    shows up in the Fig 2a/4b-style results.  The discipline picks the
    cheapest admissible algorithm per job through the shared
    :class:`~repro_torch.core.pricing.SchedulePricer`: candidates are ranked
    by closed-form lower bounds (hopeless ones pruned before any IR is
    built), prices are LRU-cached on ``(algo, canonical layout,
    n_bytes)`` so isomorphic placements share entries, and pricing never
    materializes Transfer tables — see ``docs/performance.md``.
  * **failure** — chips die permanently.  With morphing enabled the
    engine first tries a **failure bypass** (:mod:`repro_torch.morph`): swap a
    free chip into the slice and replay the lost shard state from a
    surviving peer — the job keeps its full width and its in-flight step,
    paying only the state-move pause.  Otherwise victim tenants are
    re-sliced from the survivors via the elastic-recovery policy of
    :mod:`repro_torch.runtime.fault_tolerance` (shrink through powers of two);
    a successful recovery pays another reconfiguration window, an
    unsuccessful one evicts the tenant.
  * **departure** — the slice returns to the pool.  With morphing
    enabled, the engine then offers every surviving tenant a **locality
    compaction**: remap its chips toward the densest-server-first layout
    the freed pool now admits, whenever the re-priced Schedule-IR
    collective on the new chips is strictly cheaper and the morph
    amortizes over the tenant's remaining steps.  Morph latency (MZI
    windows + state-move time) is charged to the tenant as a pause of its
    in-flight phase.

The engine asserts the chip-conservation invariant
``allocated + free + dead == n_chips`` after **every** event, and is
fully deterministic: all randomness lives in the trace generators, and
simultaneous events are ordered failure < departure < arrival < phase by
a stable sequence number.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional, Sequence

from repro_torch.core import cost_model as cm
from repro_torch.core.allocator import (AllocationError, BaseAllocator,
                                  PodAllocator, make_allocator)
from repro_torch.core.fabric import LumorphRack
from repro_torch.core.health import FabricHealth, OCSRetryPolicy
from repro_torch.core.policy import Admission, PlacementPolicy, make_policy
from repro_torch.core.pricing import SchedulePricer
from repro_torch.core.rack import Pod
from repro_torch.core.scheduler import (candidate_algos, order_for_locality,
                                  transfer_schedule, transfer_tables_built)
from repro_torch.morph import MorphConfig, MorphPolicy, PricedMorph, apply_plan
from repro_torch.runtime.fault_tolerance import (largest_pow2_leq,
                                           reallocate_after_failure)
from repro_torch.sim.metrics import SimMetrics, TenantRecord
from repro_torch.sim.workload import FailureSpec, JobSpec, Trace

try:  # pragma: no cover - exercised whenever repro_torch.sim is imported first
    from repro_torch.serve import tenant as serve_model
    from repro_torch.serve.autoscale import AutoscaleConfig, Autoscaler
except ImportError:  # repro_torch.serve is mid-import (it pulls repro_torch.sim.workload,
    # whose package init lands back here); resolve the names on first use
    serve_model = None
    AutoscaleConfig = Autoscaler = None


def _serve_imports():
    """Late binding for the engine ↔ serve cycle: whichever package is
    imported first, the names are resolved by the time any serving event
    actually runs (no serve job can exist before both packages loaded)."""
    global serve_model, AutoscaleConfig, Autoscaler
    if serve_model is None:
        from repro_torch.serve import tenant
        from repro_torch.serve.autoscale import AutoscaleConfig as AC
        from repro_torch.serve.autoscale import Autoscaler as A
        serve_model = tenant
        AutoscaleConfig, Autoscaler = AC, A

# event-kind priorities for same-timestamp ordering (_WINDOW after _PHASE:
# a serving window closes only once same-instant training phases settled)
_FAILURE, _DEPART, _ARRIVAL, _PHASE, _WINDOW = 0, 1, 2, 3, 4

#: stand-in for an inadmissible (inf) serving price: large enough that
#: the window serves ~nothing, finite so the fluid model stays NaN-free
_BLACKOUT_S = 1e9


@dataclasses.dataclass(frozen=True)
class Discipline:
    """What a fabric lets a tenant do: how chips are sliced, what its links
    cost, which collective algorithms its topology can run, and whether
    the fabric is a reconfigurable photonic one (placement-sensitive
    pricing against the LUMORPH rack model) or a fixed electrical
    topology (topology-blind rank-space schedules)."""

    name: str
    link: cm.LinkModel
    algos: tuple[str, ...]
    photonic: bool = False

    def make_allocator(self, n_chips: int,
                       policy: "PlacementPolicy | str | None" = None,
                       ) -> BaseAllocator:
        if self.photonic:  # electrical slicing rules admit no policy choice
            return make_allocator(self.name, n_chips, policy=policy)
        return make_allocator(self.name, n_chips)


#: The paper's three-way comparison.  LUMORPH runs the reconfigurable
#: LUMORPH-2/4 schedules (paying MZI delay per circuit change) on the
#: tenant's actual chips; torus and SiPAC are modeled with fixed-topology
#: Ring/Tree on an ideal electrical link — the paper's hardest baseline,
#: which overstates (not understates) their collective performance.
DISCIPLINES: dict[str, Discipline] = {
    "lumorph": Discipline("lumorph", cm.LUMORPH_LINK,
                          ("ring", "lumorph2", "lumorph4"), photonic=True),
    "torus": Discipline("torus", cm.IDEAL_SWITCH, ("ring", "tree")),
    "sipac": Discipline("sipac", cm.IDEAL_SWITCH, ("ring", "tree")),
}


def make_discipline(kind: str) -> Discipline:
    try:
        return DISCIPLINES[kind]
    except KeyError:
        raise ValueError(f"unknown discipline {kind!r}; have {sorted(DISCIPLINES)}")


@dataclasses.dataclass
class _Job:
    spec: JobSpec
    rec: TenantRecord
    chips: tuple[int, ...]
    step: int = 0
    alive: bool = True
    #: bumped on every recovery; phase/departure events carry the epoch they
    #: were scheduled under, so events from before a re-slice are ignored
    epoch: int = 0
    #: memoized locality-ordered participant tuple (photonic pricing);
    #: reset to None whenever ``chips`` changes
    ordered: Optional[tuple[int, ...]] = None
    #: memoized per-step collective seconds; valid until the slice changes
    #: (reset alongside ``ordered``), so steady-state phase events price in
    #: O(1) instead of re-canonicalizing the layout every step
    coll_s: Optional[float] = None
    #: the job's one in-flight event ``(prio, time)``; lets a morph pause
    #: the job by cancelling (epoch bump) and re-pushing it shifted
    pending: Optional[tuple[int, float]] = None

    is_serve = False

    @property
    def width(self) -> int:
        """Collective participant count: the tenant's data-parallel width.
        Overallocated chips (torus padding) don't join the ALLREDUCE; a
        shrunk slice uses everything it has left."""
        return min(self.spec.chips, len(self.chips))


@dataclasses.dataclass
class _ServeJob:
    """A serving tenant (``spec.serve`` set): no training steps — the job
    lives through its load windows, its slice grows/shrinks live under
    the autoscaler, and it departs after the last window."""

    spec: JobSpec
    rec: TenantRecord
    chips: tuple[int, ...]
    anchor: float  # arrival time the windows' relative starts anchor to
    widx: int = 0  # next window to close
    alive: bool = True
    epoch: int = 0
    #: memoized locality-ordered chips (replica groups are its g-blocks)
    ordered: Optional[tuple[int, ...]] = None
    #: memoized layout-dependent prices (TP stream, KV handoff affine)
    prices: Optional[serve_model.SlicePrices] = None
    pending: Optional[tuple[int, float]] = None
    #: serving time lost to morphs/reconfigs since the last window closed —
    #: charged against the next window's capacity, then reset
    penalty_s: float = 0.0
    #: consecutive calm windows (the autoscaler's shrink hysteresis)
    calm_windows: int = 0
    #: previous window's utilization (the autoscaler's rising-ramp guard)
    prev_rho: Optional[float] = None
    #: replica count that utilization was measured against
    prev_n: int = 0
    #: fluid prefill backlog carried into the next window (requests)
    queue_carry: float = 0.0

    is_serve = True

    @property
    def width(self) -> int:
        """Every held chip serves (no overallocation padding)."""
        return len(self.chips)

    @property
    def granularity(self) -> int:
        return serve_model.granularity(self.spec.profile)


class RackSimulator:
    """Replay one trace against one discipline; returns :class:`SimMetrics`."""

    #: bound on the shared pricer's LRU, keyed (algo, canonical layout,
    #: n_bytes); a rack trace repeats the same tenant shapes — on the
    #: same or isomorphic chips — thousands of times, so hits dominate
    SCHED_CACHE_SIZE = 4096

    def __init__(self, discipline: Discipline | str, trace: Trace,
                 n_chips: int = 64, check_invariants: bool = True,
                 tiles_per_server: int = 8,
                 fibers_per_server_pair: Optional[int] = None,
                 morph: "MorphConfig | bool | None" = None,
                 n_racks: int = 1,
                 rails_per_rack_pair: Optional[int] = None,
                 span_racks: bool = True,
                 serve_autoscale: "AutoscaleConfig | bool | None" = None,
                 policy: "str | PlacementPolicy | None" = None,
                 ocs_retry: "OCSRetryPolicy | bool | None" = True):
        if isinstance(discipline, str):
            discipline = make_discipline(discipline)
        self.discipline = discipline
        self.trace = trace
        self.n_racks = n_racks
        self.span_racks = span_racks
        #: placement policy (repro_torch.core.policy): which free chips a tenant
        #: gets.  A fabric capability like morphing — fixed electrical
        #: disciplines place by their own slice rules, so a non-default
        #: policy is ignored there and `compare` can pass one setting for
        #: all disciplines.  Bound to the shared pricer below.
        self.policy: PlacementPolicy = make_policy(
            policy if discipline.photonic else None)
        #: pod mode (``n_racks > 1``): rack granularity of the chip space;
        #: None means the classic single-rack simulation
        self.chips_per_rack: Optional[int] = None
        if n_racks > 1:
            if not discipline.photonic:
                raise ValueError(
                    "pod mode (n_racks > 1) needs a reconfigurable photonic "
                    f"discipline, not {discipline.name!r}")
            if n_chips % n_racks:
                raise ValueError(
                    f"n_chips {n_chips} not divisible into {n_racks} racks")
            self.chips_per_rack = n_chips // n_racks
            self.allocator: BaseAllocator = PodAllocator(
                n_chips, self.chips_per_rack, tiles_per_server,
                span_racks=span_racks, policy=self.policy)
        else:
            self.allocator = discipline.make_allocator(n_chips,
                                                       policy=self.policy)
        self.n_chips = self.allocator.n_chips  # torus may round the request
        self.metrics = SimMetrics(self.n_chips)
        self.check_invariants = check_invariants
        self.tiles_per_server = tiles_per_server
        if fibers_per_server_pair is None:
            # "given enough fibers between servers" (paper §3): a
            # locality-ordered *contiguous* slice peaks at 4× the tile
            # count per server pair (LUMORPH-4's high-stride rounds open
            # r−1 = 3 circuits per chip, ~2 of them crossing the cut, from
            # both sides), so this default keeps packed tenants free of
            # fiber time-sharing; scattered placements can still exceed it
            fibers_per_server_pair = 4 * tiles_per_server
        #: photonic resource model the IR schedules are validated/priced on
        #: — a Pod in pod mode, so rail contention is charged as β
        #: time-sharing and rounds crossing racks run at the rail link
        if self.chips_per_rack is not None:
            self.rack: "LumorphRack | Pod" = Pod(
                n_racks=n_racks, chips_per_rack=self.chips_per_rack,
                tiles_per_server=tiles_per_server,
                fibers_per_server_pair=fibers_per_server_pair,
                rails_per_rack_pair=rails_per_rack_pair)
        else:
            self.rack = LumorphRack(
                n_servers=max(1, math.ceil(self.n_chips / tiles_per_server)),
                tiles_per_server=tiles_per_server,
                fibers_per_server_pair=fibers_per_server_pair)
        #: fabric health (repro_torch.core.health): the engine owns the one
        #: mutable health state and shares it with the rack, so the
        #: vectorized validators, the degraded per-pair fallbacks, and
        #: the pricer's health-epoch cache suffix all see the same
        #: faults.  Electrical disciplines stay immortal (fabric faults
        #: in their traces are ignored — they model no photonic parts).
        self.health: Optional[FabricHealth] = None
        if self.discipline.photonic:
            self.health = FabricHealth()
            self.rack.health = self.health
        #: OCS glitch retry/backoff; None stalls establishment until the
        #: glitch window passes (the no-retry baseline sim_chaos compares)
        self.ocs_retry: Optional[OCSRetryPolicy] = None
        if ocs_retry:
            self.ocs_retry = (ocs_retry if isinstance(ocs_retry,
                                                      OCSRetryPolicy)
                              else OCSRetryPolicy())
        #: fault key → injection time, for MTTR accounting on repair
        self._fault_started: dict[tuple, float] = {}
        #: health epoch the last fabric re-plan ran under (no-op repairs
        #: don't bump the epoch, so they trigger no re-plan churn)
        self._replanned_epoch = 0
        #: schedule pricer shared by the engine and the morph policy:
        #: bounded LRU on canonical layouts, bound-and-prune candidate
        #: search, hit/miss counters (surfaced in SimMetrics) — see
        #: ``repro_torch.core.pricing``
        self.pricer = SchedulePricer(
            link=self.discipline.link, rack=self.rack,
            tiles_per_server=tiles_per_server,
            chips_per_rack=self.chips_per_rack,
            cache_size=self.SCHED_CACHE_SIZE)
        # the policy prices candidate placements through the same cache
        # the engine prices steps from (identical minima, shared entries)
        self.policy.bind(self.pricer, self.discipline.algos)
        self._transfer_tables_at_start = transfer_tables_built()
        #: online slice morphing (repro_torch.morph): compaction on departure,
        #: bypass on failure.  Only meaningful on a reconfigurable photonic
        #: fabric — ignored for fixed electrical disciplines, so `compare`
        #: can pass one setting for all disciplines.
        self.morph: Optional[MorphPolicy] = None
        if morph and self.discipline.photonic:
            cfg = morph if isinstance(morph, MorphConfig) else MorphConfig()
            self.morph = MorphPolicy(cfg, rack=self.rack,
                                     link=self.discipline.link,
                                     algos=self.discipline.algos,
                                     tiles_per_server=tiles_per_server,
                                     pricer=self.pricer,
                                     chips_per_rack=self.chips_per_rack,
                                     objective=self.policy.morph_objective())
        #: SLO-driven serving autoscaler (repro_torch.serve.autoscale): a fabric
        #: capability like morphing — ignored on electrical disciplines.
        #: Its scale morphs go through a MorphPolicy of their own when the
        #: trace-level ``morph`` flag is off, so enabling autoscaling never
        #: changes training tenants' compaction/bypass behavior.
        self._autoscaler: Optional[Autoscaler] = None
        self._scale_policy: Optional[MorphPolicy] = None
        if serve_autoscale and self.discipline.photonic:
            _serve_imports()
            acfg = (serve_autoscale if isinstance(serve_autoscale,
                                                  AutoscaleConfig)
                    else AutoscaleConfig())
            self._autoscaler = Autoscaler(acfg)
            self._scale_policy = self.morph or MorphPolicy(
                MorphConfig(), rack=self.rack, link=self.discipline.link,
                algos=self.discipline.algos,
                tiles_per_server=tiles_per_server, pricer=self.pricer,
                chips_per_rack=self.chips_per_rack,
                objective=self.policy.morph_objective())
        self.now = 0.0
        self.dead: set[int] = set()
        #: chip-layout version: bumped by every handler that moves chips
        #: (arrival grant, departure, failure, morph commit).  Occupancy
        #: aggregates and the conservation check depend on nothing else,
        #: so phase-only stretches — the vast majority of events in a
        #: steady-state trace — reuse the cached values in O(1) instead
        #: of rescanning every job, free chip, and allocation per event.
        self._layout_version = 0
        self._agg: tuple[int, int, Optional[float], int] = (0, 0, None, 0)
        self._agg_version = -1
        self._check_version = -1
        #: live tenants (accepted, not departed): training _Jobs and
        #: serving _ServeJobs share the dict (duck-typed on width/chips)
        self._jobs: dict[str, "_Job | _ServeJob"] = {}
        self._heap: list[tuple[float, int, int, object]] = []
        self._seq = 0
        names = [j.tenant for j in trace.jobs]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"trace has duplicate tenant ids: {dupes}")
        for job in trace.jobs:
            self._push(job.arrival, _ARRIVAL, job)
        for fail in trace.failures:
            self._push(fail.time, _FAILURE, fail)

    # -- event plumbing ------------------------------------------------------
    def _push(self, time: float, prio: int, payload) -> None:
        heapq.heappush(self._heap, (time, prio, self._seq, payload))
        self._seq += 1

    def _push_job(self, time: float, prio: int, job: "_Job") -> None:
        """Schedule a job's next phase/departure and remember it, so a
        morph can pause the job by re-pushing the event shifted in time."""
        job.pending = (prio, time)
        self._push(time, prio, (job, job.epoch))

    def _pause_job(self, job: "_Job", delay: float) -> None:
        """Charge ``delay`` seconds of morph time to the job: cancel its
        in-flight event (epoch bump) and re-push it ``delay`` later."""
        assert job.pending is not None, "live job has no pending event"
        prio, time = job.pending
        job.epoch += 1
        self._push_job(max(time, self.now) + delay, prio, job)

    def _advance_to(self, time: float) -> None:
        if self._agg_version != self._layout_version:
            self._agg = (sum(len(j.chips) for j in self._jobs.values()),
                         sum(j.width for j in self._jobs.values()),
                         self._locality(), self._stranded_free())
            self._agg_version = self._layout_version
        allocated, requested, locality, stranded = self._agg
        degraded = (self.health.degraded_overlap(self.now, time)
                    if self.health is not None else 0.0)
        self.metrics.advance(time - self.now, allocated, requested,
                             locality=locality, stranded=stranded,
                             degraded_s=degraded)
        self.now = time

    def _locality(self) -> Optional[float]:
        """Mean span ratio of live tenants: servers spanned over the
        minimum servers the slice size needs (1.0 = perfectly packed)."""
        if not self._jobs:
            return None
        tiles = self.tiles_per_server
        total = 0.0
        for j in self._jobs.values():
            spans = len({c // tiles for c in j.chips})
            ideal = -(-len(j.chips) // tiles)
            total += spans / ideal
        return total / len(self._jobs)

    def _stranded_free(self) -> int:
        """Free chips on *partially occupied* servers: the scattered
        spares a future tenant would pay fiber time-sharing to use.
        Chips on entirely-free servers are not stranded (an idle or
        perfectly compacted rack reports 0)."""
        free = self.allocator.free
        if not free:
            return 0
        tiles = self.tiles_per_server
        per_server: dict[int, int] = {}
        for c in free:
            per_server[c // tiles] = per_server.get(c // tiles, 0) + 1
        full = min(tiles, self.n_chips)  # a 1-server rack can be smaller
        return sum(n for n in per_server.values() if n < full)

    def _check(self) -> None:
        allocated = set()
        for a in self.allocator.allocations.values():
            allocated.update(a.chips)
        free = self.allocator.free
        assert not (allocated & free), "chip both allocated and free"
        assert not (allocated & self.dead), "dead chip still allocated"
        assert not (free & self.dead), "dead chip still free"
        total = len(allocated) + len(free) + len(self.dead)
        assert total == self.n_chips, (
            f"conservation violated: {len(allocated)} allocated + "
            f"{len(free)} free + {len(self.dead)} dead != {self.n_chips}")

    # -- pricing -------------------------------------------------------------
    def _algo_cost(self, algo: str, chips: tuple[int, ...],
                   n_bytes: float) -> float:
        """Thin alias of ``self.pricer.price`` (see
        :class:`~repro_torch.core.pricing.SchedulePricer` for semantics), kept
        for tests and external callers probing individual candidates —
        the engine itself prices through ``pricer.cheapest``."""
        return self.pricer.price(algo, chips, n_bytes)

    def _collective_s(self, job: _Job) -> float:
        cost = self._try_collective_s(job)
        assert cost != float("inf"), \
            f"no admissible collective for {job.spec.tenant} on {job.chips}"
        return cost

    def _try_collective_s(self, job: _Job) -> float:
        """Price the job's per-step collective; unlike
        :meth:`_collective_s` this may return ``inf`` when the (degraded)
        fabric admits no schedule on the job's chips — the caller then
        walks the degradation ladder (:meth:`_replan_job`) instead of
        asserting."""
        if job.coll_s is not None:
            return job.coll_s
        p = job.width
        if p <= 1:
            job.coll_s = 0.0
            return 0.0
        prof = job.spec.profile
        if not self.discipline.photonic:
            # fixed electrical topology: rank-space schedules, so the price
            # depends only on width — algorithm_cost is the IR behind a
            # global cache keyed exactly on (algo, p, bytes)
            if prof is None:
                cost = min(cm.algorithm_cost(a, job.spec.coll_bytes, p,
                                             self.discipline.link)
                           for a in self.discipline.algos)
            else:
                cost = self._profile_cost_width(prof, p)
            job.coll_s = cost
            return cost
        # participants: the tenant's actual chips (overallocated padding
        # never joins the ALLREDUCE), locality-ordered so frequent
        # low-stride rounds stay inside servers (and, in pod mode, racks);
        # memoized per (re)slice.  Rack-spanning slices with equal shares
        # additionally price the hierarchical compositions.
        if job.ordered is None:
            job.ordered = tuple(order_for_locality(
                job.chips[:p], self.tiles_per_server,
                chips_per_rack=self.chips_per_rack))
        chips = job.ordered
        if prof is None:
            cost = self.pricer.cheapest(
                candidate_algos(self.discipline.algos, chips,
                                self.chips_per_rack),
                chips, job.spec.coll_bytes)
        else:
            cost = self._profile_cost_chips(prof, chips)
        job.coll_s = cost
        return cost

    def _profile_cost_width(self, prof, p: int) -> float:
        """Width-only profile pricing (fixed electrical fabrics): the
        tenant's TP degree is what divides its slice (``gcd``), DP rings
        reduce each gradient bucket once per ``cadence`` steps, and the
        TP activation stream runs every step."""
        tp = math.gcd(prof.tp, p)
        dp = p // tp
        algos = self.discipline.algos
        link = self.discipline.link
        cost = 0.0
        if dp > 1:
            cost += sum(min(cm.algorithm_cost(a, b, dp, link) for a in algos)
                        for b in prof.buckets) / prof.cadence
        if tp > 1 and prof.tp_collectives:
            cost += prof.tp_collectives * min(
                cm.algorithm_cost(a, prof.tp_bytes, tp, link) for a in algos)
        return cost

    def _profile_cost_chips(self, prof, chips: tuple[int, ...]) -> float:
        """Layout-aware profile pricing (photonic fabrics).  Over the
        locality-ordered slice, TP groups are the *contiguous* blocks
        ``chips[j*tp:(j+1)*tp]`` (activation ALLREDUCEs stay inside a
        server whenever the packing allows) and DP rings are the strided
        complements ``chips[j::tp]``.  Rings are chip-disjoint so they
        reduce their buckets concurrently — the step pays the slowest
        ring, amortized over the accumulation cadence — and likewise the
        slowest TP block paces every step's activation stream.
        Isomorphic rings/blocks collapse onto one pricer entry via the
        canonical cache key."""
        p = len(chips)
        tp = math.gcd(prof.tp, p)
        dp = p // tp
        cost = 0.0
        if dp > 1:
            rings: dict = {}
            for j in range(tp):
                ring = chips[j::tp]
                rings.setdefault(self.pricer.cache_key_chips(ring), ring)
            cost += max(
                sum(self.pricer.cheapest(
                    candidate_algos(self.discipline.algos, ring,
                                    self.chips_per_rack),
                    ring, b) for b in prof.buckets)
                for ring in rings.values()) / prof.cadence
        if tp > 1 and prof.tp_collectives:
            blocks: dict = {}
            for j in range(dp):
                blk = chips[j * tp:(j + 1) * tp]
                blocks.setdefault(self.pricer.cache_key_chips(blk), blk)
            cost += prof.tp_collectives * max(
                self.pricer.cheapest(
                    candidate_algos(self.discipline.algos, blk,
                                    self.chips_per_rack),
                    blk, prof.tp_bytes)
                for blk in blocks.values())
        return cost

    def _reconfig_window(self, chips: Sequence[int]) -> float:
        """The window to (re-)establish a slice's circuits: the slower
        rail OCS window when the slice spans racks in pod mode (its
        circuit set then includes rail circuits), else the link's own.
        A live OCS glitch adds retry/backoff delay on top (see
        :meth:`_ocs_delay`)."""
        reconf = self.discipline.link.reconfig
        if reconf and isinstance(self.rack, Pod):
            reconf = self.rack.reconfig_window(chips, reconf)
        if reconf and self.health is not None and self.health._glitches:
            reconf += self._ocs_delay()
        return reconf

    def _ocs_delay(self) -> float:
        """Extra circuit-establishment latency while an OCS glitch window
        is live.  With a retry policy, each failed attempt backs off
        exponentially; a hard (prob = 1) glitch that outlives the whole
        retry budget *escalates* to a permanent OCS failure — rail loss
        for a pod-tier switch, ``mzi_failed`` for the rack's own — and
        repair events are then the only way back.  Without a policy,
        establishment simply stalls until the window passes."""
        h = self.health
        gw = h.active_glitch(self.now)
        if gw is None:
            return 0.0
        pol = self.ocs_retry
        if pol is None:
            # no-retry baseline: the OCS controller blocks until the
            # glitch clears, unbounded by any backoff budget
            delay = max(0.0, gw.end - self.now)
            self.metrics.on_ocs(delay, 0.0)
            return delay
        if gw.prob >= 1.0:
            # deterministic failure: walk the backoff ladder; the first
            # attempt landing past the window's end succeeds
            delay, backoff, retries = 0.0, pol.backoff_s, 0
            ok = False
            for _ in range(pol.max_retries):
                delay += backoff
                retries += 1
                if self.now + delay >= gw.end:
                    ok = True
                    break
                backoff *= pol.multiplier
            if not ok:
                self.metrics.ocs_escalations += 1
                rail_budget = (self.rack.rails_per_rack_pair
                               if isinstance(self.rack, Pod) else 0)
                h.escalate_ocs(gw.link, rail_budget=rail_budget)
                self._invalidate_prices()
            self.metrics.on_ocs(delay, float(retries))
            return delay
        # probabilistic glitch: charge the analytic expectation (the
        # engine is deterministic — randomness lives in the generators)
        delay = pol.expected_delay(gw.prob)
        self.metrics.on_ocs(delay, pol.expected_retries(gw.prob))
        return delay

    def _invalidate_prices(self) -> None:
        """Drop every live tenant's memoized prices; each re-prices
        lazily at its next phase/window (inf routes into
        :meth:`_replan_job` from :meth:`_on_phase`)."""
        for job in self._jobs.values():
            job.ordered = None
            if job.is_serve:
                job.prices = None
            else:
                job.coll_s = None

    # -- handlers ------------------------------------------------------------
    def _on_arrival(self, spec: JobSpec) -> None:
        self.metrics.arrivals += 1
        if self.health is not None and self.health.mzi_failed:
            # the rack-tier OCS is down: no new circuits can be built at
            # all, so admission waits for the repair crew
            self.metrics.rejected += 1
            return
        try:
            alloc = self.allocator.allocate(spec.tenant, spec.chips)
        except AllocationError:
            self.metrics.rejected += 1
            if spec.chips <= len(self.allocator.free):
                self.metrics.fragmentation_rejects += 1
            return
        if (self.health is not None and self.health and spec.serve is None
                and spec.chips > 1):
            # degraded fabric: probe the placement before accepting — a
            # tenant whose only available slice admits no schedule (dead
            # fibers/rails in every round) would never step
            probe = _Job(spec=spec,
                         rec=TenantRecord(tenant=spec.tenant,
                                          requested=spec.chips,
                                          arrival=self.now,
                                          granted=len(alloc.chips)),
                         chips=alloc.chips)
            if self._try_collective_s(probe) == float("inf"):
                self.allocator.release(spec.tenant)
                self.metrics.rejected += 1
                return
        self.metrics.accepted += 1
        rec = TenantRecord(tenant=spec.tenant, requested=spec.chips,
                           arrival=self.now, granted=len(alloc.chips))
        self.metrics.tenants[spec.tenant] = rec
        # establish the slice's circuits: one MZI window on photonic
        # fabrics (the slower rail OCS window for rack-spanning slices)
        reconf = self._reconfig_window(alloc.chips)
        if spec.serve is not None:
            _serve_imports()
            sjob = _ServeJob(spec=spec, rec=rec, chips=alloc.chips,
                             anchor=self.now)
            self._jobs[spec.tenant] = sjob
            self._layout_version += 1
            if reconf:
                self.metrics.on_reconfig(rec, reconf)
                sjob.penalty_s += reconf
            w0 = spec.serve.windows[0]
            # windows stay anchored to the arrival: traffic doesn't wait
            # for the fabric — setup time is capacity lost to the window
            self._push_job(self.now + w0.start + w0.duration, _WINDOW, sjob)
            return
        job = _Job(spec=spec, rec=rec, chips=alloc.chips)
        self._jobs[spec.tenant] = job
        self._layout_version += 1
        if reconf:
            self.metrics.on_reconfig(rec, reconf)
        self._push_job(self.now + reconf + spec.compute_s, _PHASE, job)

    def _on_phase(self, payload: tuple[_Job, int]) -> None:
        """A compute phase just finished: price the step's collective and
        schedule the next step (or the departure)."""
        job, epoch = payload
        if not job.alive or epoch != job.epoch:
            return  # stale event from before an eviction or a re-slice
        coll = self._try_collective_s(job)
        if coll == float("inf"):
            # the fabric degraded under this job's feet (e.g. an OCS
            # escalation invalidated its price lazily): walk the
            # degradation ladder; the surviving slice replays the step
            self._replan_job(job)
            return
        self.metrics.on_collective(job.rec, coll)
        self.metrics.compute_s += job.spec.compute_s
        job.step += 1
        job.rec.steps_done = job.step
        if job.step >= job.spec.steps:
            self._push_job(self.now + coll, _DEPART, job)
        else:
            self._push_job(self.now + coll + job.spec.compute_s, _PHASE, job)

    def _on_depart(self, payload: tuple[_Job, int]) -> None:
        job, epoch = payload
        if not job.alive or epoch != job.epoch:
            return
        job.alive = False
        self.allocator.release(job.spec.tenant)
        del self._jobs[job.spec.tenant]
        self._layout_version += 1
        job.rec.completed = True
        job.rec.end = self.now
        self.metrics.completed += 1
        self._maybe_compact()

    # -- serving (repro_torch.serve) -----------------------------------------------
    def _slice_prices(self, job: _ServeJob,
                      groups: Sequence[tuple[int, ...]]) -> serve_model.SlicePrices:
        """Layout-dependent serving prices, recomputed on every re-slice:
        the TP activation collective on the *worst* replica block (mirrors
        ``_profile_cost_chips``; distinct canonical blocks collapse onto
        shared pricer entries) and the prefill→decode KV handoff as a
        two-point affine fit of a Schedule-IR transfer wave."""
        prof = job.spec.profile
        sv = job.spec.serve
        g = len(groups[0])

        def tp_price(n_bytes: float) -> float:
            if g <= 1 or prof is None or not prof.tp_collectives:
                return 0.0
            if not self.discipline.photonic:
                return min(cm.algorithm_cost(a, n_bytes, g,
                                             self.discipline.link)
                           for a in self.discipline.algos)
            blocks: dict = {}
            for blk in groups:
                blocks.setdefault(self.pricer.cache_key_chips(blk), blk)
            return max(self.pricer.cheapest(
                candidate_algos(self.discipline.algos, blk,
                                self.chips_per_rack), blk, n_bytes)
                for blk in blocks.values())

        tp_pf = tp_price(prof.tp_bytes) if prof is not None else 0.0
        tp_dec = (tp_price(prof.tp_bytes * sv.decode_batch
                           / serve_model.PROFILE_TOKENS)
                  if prof is not None else 0.0)
        kv_base = kv_slope = 0.0
        if len(groups) >= 2 and sv.kv_bytes_per_token > 0:
            # representative handoff pair: first (prefill-side) and last
            # (decode-side) replica; Schedule cost is affine in bytes for
            # a fixed layout, so two points pin the whole request range
            pairs = list(zip(groups[0], groups[-1]))
            rack = self.rack if self.discipline.photonic else None

            def kv_cost(total_bytes: float) -> float:
                sched = transfer_schedule([pairs], total_bytes / g,
                                          tag="kv-handoff")
                return sched.cost(self.discipline.link, rack=rack)

            b0, b1 = float(1 << 20), float(4 << 20)
            c0, c1 = kv_cost(b0), kv_cost(b1)
            kv_slope = (c1 - c0) / (b1 - b0)
            kv_base = c0 - kv_slope * b0
        return serve_model.SlicePrices(tp_prefill_s=tp_pf, tp_decode_s=tp_dec,
                                       kv_base_s=kv_base,
                                       kv_per_byte_s=kv_slope)

    def _serve_window_stats(self, job: _ServeJob, w) -> serve_model.WindowStats:
        g = job.granularity
        if job.ordered is None:
            job.ordered = tuple(order_for_locality(
                job.chips, self.tiles_per_server,
                chips_per_rack=self.chips_per_rack))
        n_rep = len(job.ordered) // g
        groups = [job.ordered[i * g:(i + 1) * g] for i in range(max(1, n_rep))]
        if job.prices is None:
            pr = self._slice_prices(job, groups)
            if not all(math.isfinite(v) for v in
                       (pr.tp_prefill_s, pr.tp_decode_s, pr.kv_base_s,
                        pr.kv_per_byte_s)):
                # the degraded fabric admits no schedule for some replica
                # block or the KV wave: clamp to a huge finite price so the
                # fluid window math stays well-defined — the window serves
                # ~nothing and later repairs/recoveries re-price it
                pr = serve_model.SlicePrices(
                    tp_prefill_s=min(pr.tp_prefill_s, _BLACKOUT_S),
                    tp_decode_s=min(pr.tp_decode_s, _BLACKOUT_S),
                    kv_base_s=min(pr.kv_base_s, _BLACKOUT_S),
                    kv_per_byte_s=min(pr.kv_per_byte_s, _BLACKOUT_S))
            job.prices = pr
        lost = job.penalty_s
        if n_rep < 2:
            # degenerate single-replica slice (post-failure floor): prefill
            # and decode time-share the one replica at half capacity each
            n_pf = n_dec = max(1, n_rep)
            lost += w.duration / 2.0
        else:
            n_pf, n_dec = serve_model.split_slice(job.spec.serve,
                                                  job.spec.profile, n_rep,
                                                  job.prices)
        stats = serve_model.window_stats(job.spec.serve, job.spec.profile, w,
                                         n_pf, n_dec, job.prices, lost_s=lost,
                                         q0=job.queue_carry)
        job.queue_carry = stats.queue_carry
        return stats

    def _on_window(self, payload: "tuple[_ServeJob, int]") -> None:
        """A load window just closed: score it on the chips that served
        it, let the autoscaler resize for the next window, and schedule
        the next window close (or the departure after the last one)."""
        job, epoch = payload
        if not job.alive or epoch != job.epoch:
            return
        sv = job.spec.serve
        w = sv.windows[job.widx]
        stats = self._serve_window_stats(job, w)
        self.metrics.on_serve_window(job.rec, stats, len(job.chips),
                                     w.duration)
        job.penalty_s = 0.0
        job.widx += 1
        if job.widx >= len(sv.windows):
            self._push_job(self.now, _DEPART, job)
            return
        if self._autoscaler is not None:
            self._autoscale(job, stats)
        nw = sv.windows[job.widx]
        self._push_job(job.anchor + nw.start + nw.duration, _WINDOW, job)

    def _autoscale(self, job: _ServeJob, stats: serve_model.WindowStats) -> None:
        """Execute one autoscaler decision as a priced scale morph."""
        g = job.granularity
        n_rep = len(job.chips) // g
        if n_rep < 1:
            return
        prev = job.prev_rho
        if prev is not None and job.prev_n and job.prev_n != n_rep:
            # the policy's trend guards compare *load*, and rho is load per
            # replica: normalize across resizes, else every shrink reads as
            # a rising ramp (same load, fewer replicas) and stalls the next
            prev = prev * job.prev_n / n_rep
        want, job.calm_windows = self._autoscaler.decide(
            n_rep, stats, job.calm_windows, prev_rho=prev)
        job.prev_rho = max(stats.rho_prefill, stats.rho_decode)
        job.prev_n = n_rep
        sv = job.spec.serve
        prof = job.spec.profile
        whatif = prof.tp_bytes if prof is not None and prof.tp_bytes \
            else sv.weight_bytes
        if want > n_rep:
            free = sorted(self._morph_pool(job))
            # whole replicas only: grow by as many as the pool can host
            grow = min(want - n_rep, len(free) // g)
            if grow < 1:
                return
            pm = self._scale_policy.propose_scale_up(
                job.spec.tenant, job.chips, grow * g,
                state_bytes=sv.weight_bytes, free=free, whatif_bytes=whatif)
            if pm is not None:
                self._commit_serve_morph(job, pm)
        elif want < n_rep:
            # shed the tail replicas in locality order: the packed prefix
            # keeps its low-stride TP blocks intact
            keep = job.ordered[:want * g]
            prompt, output = serve_model.mean_lengths(sv)
            drain = (sv.decode_batch * (prompt + output / 2.0)
                     * sv.kv_bytes_per_token / g)
            pm = self._scale_policy.propose_scale_down(
                job.spec.tenant, job.chips, keep, drain_bytes=drain,
                whatif_bytes=whatif)
            if pm is not None:
                self._commit_serve_morph(job, pm)

    def _commit_serve_morph(self, job: _ServeJob, pm: PricedMorph) -> None:
        """Apply a scale plan: chips change under the conservation proofs;
        the windows keep their cadence (traffic is anchored to wall time),
        so the morph's cost is charged as lost capacity to the next window
        instead of pausing the event like a training morph."""
        apply_plan(self.allocator, pm.plan, rack=self.rack,
                   dead_chips=self._dead_outside_allocator())
        job.chips = self.allocator.allocations[job.spec.tenant].chips
        self._layout_version += 1
        job.ordered = None
        job.prices = None
        job.penalty_s += pm.cost.total_s
        self.metrics.on_morph(job.rec, pm.plan.kind, pm.cost.total_s,
                              pm.cost.bytes_moved, pm.cost.reconfig_windows,
                              pm.old_step_s, pm.new_step_s)

    def _recover_serve(self, job: _ServeJob) -> None:
        """Re-slice a serving tenant that lost chips to a failure: the
        widest whole-replica slice the rack still admits, never below the
        two-replica disaggregation floor; the autoscaler restores width
        on later windows if traffic warrants it."""
        g = job.granularity
        surviving = sum(1 for c in job.chips if c not in self.dead)
        want = (surviving // g) * g
        alloc = None
        while want >= 2 * g:
            try:
                alloc = self.allocator.allocate(job.spec.tenant, want)
                break
            except AllocationError:
                want -= g
        if alloc is None:
            job.alive = False
            del self._jobs[job.spec.tenant]
            job.rec.evicted = True
            job.rec.end = self.now
            self.metrics.evicted += 1
            return
        assert job.pending is not None, "live serve job has no pending event"
        prio, time = job.pending
        job.chips = alloc.chips
        job.ordered = None
        job.prices = None
        job.epoch += 1  # invalidate the window scheduled on the old slice
        self.metrics.recoveries += 1
        job.rec.shrunk_to = (len(alloc.chips)
                             if len(alloc.chips) < job.spec.chips else None)
        reconf = self._reconfig_window(alloc.chips)
        if reconf:
            self.metrics.on_reconfig(job.rec, reconf)
            job.penalty_s += reconf
        self._push_job(max(time, self.now), prio, job)

    # -- morphing ------------------------------------------------------------
    def _dead_outside_allocator(self) -> int:
        """Dead chips currently tracked by neither the free pool nor any
        allocation (the conservation checker's third bucket)."""
        held = sum(len(a.chips) for a in self.allocator.allocations.values())
        return self.n_chips - held - len(self.allocator.free)

    def _morph_pool(self, job: "_Job") -> set[int]:
        """Free chips a morph may draw on for this tenant: everything,
        unless the pod is rack-confined — then only the tenant's own
        racks, so a bypass or compaction cannot silently turn a confined
        tenant into a rack-spanning one (the allocator's invariant)."""
        free = self.allocator.free
        if self.chips_per_rack is not None and not self.span_racks:
            racks = {c // self.chips_per_rack for c in job.chips}
            free = {c for c in free if c // self.chips_per_rack in racks}
        return free

    def _commit_morph(self, job: _Job, pm: PricedMorph) -> None:
        """Apply an endorsed plan: reassign chips under the conservation
        proofs, re-price future collectives on the new layout, and charge
        the pause to the tenant."""
        apply_plan(self.allocator, pm.plan, rack=self.rack,
                   dead_chips=self._dead_outside_allocator())
        job.chips = self.allocator.allocations[job.spec.tenant].chips
        self._layout_version += 1
        job.ordered = None  # future schedules re-priced on the new chips
        job.coll_s = None
        if pm.plan.kind == "bypass":
            # a partial bypass shrinks by the dead chips the pool could
            # not replace; a full bypass (or a later one that back-fills)
            # restores full width
            job.rec.shrunk_to = (len(job.chips)
                                 if len(job.chips) < job.spec.chips else None)
        self._pause_job(job, pm.cost.total_s)
        self.metrics.on_morph(job.rec, pm.plan.kind, pm.cost.total_s,
                              pm.cost.bytes_moved, pm.cost.reconfig_windows,
                              pm.old_step_s, pm.new_step_s)

    def _maybe_compact(self) -> None:
        """Departure freed chips: offer every surviving tenant a locality
        compaction (tenant order is deterministic; each commit updates the
        free pool the next proposal sees)."""
        if self.morph is None:
            return
        if self.health is not None and self.health.mzi_failed:
            return  # no OCS, no new circuits, no compaction
        for tenant in sorted(self._jobs):
            job = self._jobs[tenant]
            if not job.alive or job.is_serve or job.width <= 1:
                # serving slices are resized by the autoscaler, not the
                # compaction policy — their layout churn is SLO-driven
                continue
            pm = self.morph.propose_compaction(
                tenant, job.chips, job.width, job.spec.coll_bytes,
                remaining_steps=job.spec.steps - job.step,
                free=sorted(self._morph_pool(job)))
            if pm is not None:
                self._commit_morph(job, pm)

    # -- fabric faults (repro_torch.core.health) -----------------------------------
    def _banks_per_tile(self) -> int:
        r = self.rack
        return (r.racks[0] if isinstance(r, Pod) else r) \
            .servers[0].trx_banks_per_tile

    def _on_fabric_fault(self, fail: FailureSpec) -> None:
        """Apply one non-chip fault to the health state, then re-plan the
        tenants it degraded.  A chip that lost its *last* TRX lane is
        operationally dead and escalates to the chip-failure path (bypass
        → elastic restart) before the re-plan."""
        h = self.health
        self.metrics.fabric_faults += 1
        self._fault_started.setdefault((fail.kind, fail.link, fail.chips),
                                       self.now)
        if fail.kind == "link_fail":
            h.fail_fibers(fail.link, fail.count)
        elif fail.kind == "trx_fail":
            for chip in fail.chips:
                h.fail_lanes(chip, fail.count)
            banks = self._banks_per_tile()
            dead = tuple(c for c in fail.chips
                         if h.lanes_lost(c) >= banks and c not in self.dead)
            if dead:
                self._on_failure(FailureSpec(self.now, dead))
        elif fail.kind == "rail_fail":
            h.fail_rails(fail.link, fail.count)
        elif fail.kind == "degrade":
            for chip in fail.chips:
                h.set_derate(chip, fail.derate)
        elif fail.kind == "ocs_glitch":
            h.start_glitch(self.now, self.now + fail.duration, fail.prob,
                           link=fail.link)
            return  # transient: establishment slows, but no price changes
        else:
            raise ValueError(f"unknown fabric fault kind {fail.kind!r}")
        self._fabric_replan()

    def _on_repair(self, fail: FailureSpec) -> None:
        """Undo the ``fail.target``-kind fault on the same chips/link.
        Chips the TRX fault operationally killed stay dead — the repair
        restores the *fabric* element, not checkpointed tenant state."""
        h = self.health
        started = self._fault_started.pop(
            (fail.target, fail.link, fail.chips), None)
        if fail.target == "link_fail":
            h.repair_fibers(fail.link)
        elif fail.target == "trx_fail":
            for chip in fail.chips:
                h.repair_lanes(chip)
        elif fail.target == "rail_fail":
            h.repair_rails(fail.link)
        elif fail.target == "degrade":
            for chip in fail.chips:
                h.clear_derate(chip)
        elif fail.target == "ocs_glitch":
            h.repair_ocs(fail.link)
        else:
            raise ValueError(f"unknown repair target {fail.target!r}")
        self.metrics.on_repair(None if started is None
                               else self.now - started)
        self._fabric_replan()

    def _fabric_replan(self) -> None:
        """A permanent fault or repair changed what circuits cost:
        invalidate every live tenant's memoized prices and re-plan the
        ones the degraded fabric no longer admits.  Repairs that cleared
        nothing leave the health epoch alone and cost no churn."""
        h = self.health
        if h.epoch == self._replanned_epoch:
            return
        self._replanned_epoch = h.epoch
        for tenant in sorted(self._jobs):
            job = self._jobs.get(tenant)
            if job is None or not job.alive:
                continue
            job.ordered = None
            if job.is_serve:
                if job.prices is not None:
                    job.prices = None  # next window re-prices degraded
                    self.metrics.on_reroute(job.rec)
                continue
            old = job.coll_s
            job.coll_s = None
            cost = self._try_collective_s(job)
            if cost != float("inf"):
                if old is not None and cost != old:
                    self.metrics.on_reroute(job.rec)
                continue
            self._replan_job(job)

    def _replan_job(self, job: _Job) -> None:
        """The degradation ladder for a training tenant whose chips admit
        no schedule: re-pricing on the same chips (the reroute rung)
        already failed, so (1) morph away from the broken hardware,
        (2) elastically shrink through powers of two, (3) evict."""
        if (self.morph is not None
                and not (self.health is not None and self.health.mzi_failed)):
            pm = self.morph.propose_compaction(
                job.spec.tenant, job.chips, job.width, job.spec.coll_bytes,
                remaining_steps=max(1, job.spec.steps - job.step),
                free=sorted(self._morph_pool(job)))
            if pm is not None and pm.new_step_s != float("inf"):
                self._commit_morph(job, pm)
                self.metrics.on_reroute(job.rec)
                if self._try_collective_s(job) != float("inf"):
                    return  # profiled jobs may still be stuck — fall through
        self.allocator.release(job.spec.tenant)
        self._layout_version += 1
        want = largest_pow2_leq(len(job.chips))
        while want >= 1:
            try:
                alloc = self.allocator.allocate(job.spec.tenant, want)
            except AllocationError:
                want = largest_pow2_leq(want - 1) if want > 1 else 0
                continue
            job.chips = alloc.chips
            job.ordered = None
            job.coll_s = None
            if self._try_collective_s(job) == float("inf"):
                # this width still prices inf on the degraded fabric;
                # narrower slices need fewer circuits per round
                self.allocator.release(job.spec.tenant)
                want = largest_pow2_leq(want - 1) if want > 1 else 0
                continue
            job.epoch += 1  # cancel events scheduled on the old slice
            self.metrics.recoveries += 1
            self.metrics.on_reroute(job.rec)
            job.rec.shrunk_to = (len(alloc.chips)
                                 if len(alloc.chips) < job.spec.chips
                                 else None)
            reconf = self._reconfig_window(alloc.chips)
            if reconf:
                self.metrics.on_reconfig(job.rec, reconf)
            if job.step >= job.spec.steps:
                self._push_job(self.now + reconf, _DEPART, job)
            else:
                # the in-flight step replays on the surviving slice
                self._push_job(self.now + reconf + job.spec.compute_s,
                               _PHASE, job)
            return
        job.alive = False
        job.epoch += 1
        del self._jobs[job.spec.tenant]
        job.rec.evicted = True
        job.rec.end = self.now
        self.metrics.evicted += 1

    def _on_failure(self, fail: FailureSpec) -> None:
        if getattr(fail, "kind", "chip") != "chip":
            if self.health is None:
                return  # electrical fabrics model no photonic plumbing
            if fail.kind == "repair":
                self._on_repair(fail)
            else:
                self._on_fabric_fault(fail)
            return
        fresh = [c for c in fail.chips if c not in self.dead]
        if not fresh:
            return
        self.dead.update(fresh)
        self._layout_version += 1  # dead set + the re-slices below
        self.metrics.failures_injected += len(fresh)
        dead = set(fresh)
        if self.morph is not None:
            # failure bypass: swap free chips into hit slices and replay
            # the lost shards from surviving peers — the job keeps its
            # width and its in-flight step.  Tenants the planner cannot
            # serve (no free chip, no surviving peer) fall through to the
            # elastic-restart path below.
            for tenant in sorted(self._jobs):
                job = self._jobs[tenant]
                lost = dead & set(job.chips)
                if not job.alive or not lost:
                    continue
                if job.is_serve:
                    # serving tenants re-slice on replica boundaries via
                    # _recover_serve below; a single-chip bypass would
                    # leave a torn replica group
                    continue
                if job.step >= job.spec.steps:
                    # no work left — don't spend spare chips on a tenant
                    # that is about to depart; the elastic path below
                    # hands its slice straight back
                    continue
                pm = self.morph.propose_bypass(
                    tenant, job.chips, job.width, job.spec.coll_bytes,
                    dead=sorted(lost), free=sorted(self._morph_pool(job) - dead))
                if pm is not None:
                    self._commit_morph(job, pm)
        victims = self.allocator.fail_chips(fresh)
        for tenant in victims:
            job = self._jobs.get(tenant)
            if job is None or not job.alive:
                continue
            if job.is_serve:
                self._recover_serve(job)
                continue
            alloc = reallocate_after_failure(self.allocator, tenant,
                                             job.spec.chips)
            if alloc is None:
                # rack exhausted: the tenant is evicted mid-job
                job.alive = False
                del self._jobs[tenant]
                job.rec.evicted = True
                job.rec.end = self.now
                self.metrics.evicted += 1
                continue
            job.chips = alloc.chips
            job.ordered = None  # re-derive locality order for the new slice
            job.coll_s = None
            job.epoch += 1  # invalidate phases scheduled on the old slice
            self.metrics.recoveries += 1
            # reflect the *current* width: a later full-width recovery
            # clears a shrink recorded by an earlier one
            job.rec.shrunk_to = (len(alloc.chips)
                                 if len(alloc.chips) < job.spec.chips else None)
            # rebuilding circuits on the new slice costs one MZI window
            # (rail OCS window for a rack-spanning slice); the in-flight
            # step restarts after it (checkpoint restore and parameter
            # broadcast are priced by recovery_cost_model when a caller
            # wants wall-clock recovery time — the rack-occupancy metrics
            # here only need the window)
            reconf = self._reconfig_window(alloc.chips)
            if reconf:
                self.metrics.on_reconfig(job.rec, reconf)
            if job.step >= job.spec.steps:
                # the failure landed between the job's last collective and
                # its departure: no work is left, just hand the slice back
                self._push_job(self.now + reconf, _DEPART, job)
            else:
                self._push_job(self.now + reconf + job.spec.compute_s,
                               _PHASE, job)

    # -- main loop -----------------------------------------------------------
    def run(self, max_events: Optional[int] = None) -> SimMetrics:
        handlers = {_ARRIVAL: self._on_arrival, _PHASE: self._on_phase,
                    _DEPART: self._on_depart, _FAILURE: self._on_failure,
                    _WINDOW: self._on_window}
        while self._heap:
            if max_events is not None and self.metrics.events >= max_events:
                break
            time, prio, _, payload = heapq.heappop(self._heap)
            self._advance_to(time)
            handlers[prio](payload)
            self.metrics.events += 1
            if (self.check_invariants
                    and self._check_version != self._layout_version):
                self._check()
                self._check_version = self._layout_version
        self.metrics.horizon = self.now
        # pricing fast-path accounting (satellite of the lazy-IR work):
        # cache hit rate, schedules built, candidates pruned, and how many
        # Transfer tables this run materialized (steady-state pricing must
        # materialize none — execution is the only legitimate consumer)
        st = self.pricer.stats
        self.metrics.sched_cache_hits = st.hits
        self.metrics.sched_cache_misses = st.misses
        self.metrics.schedules_built = st.built
        self.metrics.candidates_pruned = st.pruned
        self.metrics.transfers_materialized = (
            transfer_tables_built() - self._transfer_tables_at_start)
        self.metrics.retired_chips = len(self.allocator.retired)
        return self.metrics

    # -- what-if capacity planning -------------------------------------------
    def whatif(self, k: int, coll_bytes: Optional[float] = None) -> Admission:
        """Can this fabric absorb a ``k``-chip tenant right now, without
        evictions, and at what collective stretch?  Pure query: prices the
        candidate placement through the shared pricer, commits nothing."""
        if not self.discipline.photonic:
            raise ValueError(
                f"what-if planning needs a photonic discipline, "
                f"not {self.discipline.name!r}")
        return self.policy.whatif(self.allocator.free, k,
                                  self.allocator.geometry, coll_bytes)


def simulate(kind: str, trace: Trace, n_chips: int = 64,
             check_invariants: bool = True,
             morph: "MorphConfig | bool | None" = None,
             n_racks: int = 1, span_racks: bool = True,
             rails_per_rack_pair: Optional[int] = None,
             serve_autoscale: "AutoscaleConfig | bool | None" = None,
             policy: "str | PlacementPolicy | None" = None,
             ocs_retry: "OCSRetryPolicy | bool | None" = True,
             fibers_per_server_pair: Optional[int] = None,
             ) -> SimMetrics:
    """Convenience wrapper: replay ``trace`` on discipline ``kind``
    (``n_racks > 1`` simulates a pod of racks joined by photonic rails)."""
    kw = {}
    if fibers_per_server_pair is not None:
        kw["fibers_per_server_pair"] = fibers_per_server_pair
    return RackSimulator(kind, trace, n_chips=n_chips,
                         check_invariants=check_invariants, morph=morph,
                         n_racks=n_racks, span_racks=span_racks,
                         rails_per_rack_pair=rails_per_rack_pair,
                         serve_autoscale=serve_autoscale,
                         policy=policy, ocs_retry=ocs_retry, **kw).run()


def compare(trace: Trace, kinds: Sequence[str] = ("lumorph", "torus", "sipac"),
            n_chips: int = 64, check_invariants: bool = True,
            morph: "MorphConfig | bool | None" = None,
            serve_autoscale: "AutoscaleConfig | bool | None" = None,
            ) -> dict[str, SimMetrics]:
    """Replay the same trace on every discipline (the Fig 2a experiment).
    ``morph`` and ``serve_autoscale`` only affect photonic disciplines
    (both are fabric capabilities)."""
    return {k: simulate(k, trace, n_chips=n_chips,
                        check_invariants=check_invariants, morph=morph,
                        serve_autoscale=serve_autoscale)
            for k in kinds}
