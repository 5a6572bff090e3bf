"""Morph decision logic: *when* is a live transformation worth it?

The port's copy of ``repro.morph.policy``, line for line.

The planners (`repro_torch.morph.plan`) say what a morph would look like; the
policy prices both worlds and only proposes plans that pay for
themselves:

  * a **compaction** is proposed when the tenant's cheapest admissible
    per-step collective on the compacted layout is strictly cheaper than
    on the current (fragmented) layout, and — with amortization on — the
    per-step saving times the steps the tenant still has to run exceeds
    the morph's own cost (MZI windows + state-move time).
  * a **bypass** is proposed whenever it is feasible (free replacement
    chips + a surviving peer to replay state from); preserving the
    slice's full width is worth a pause of a few state-move times, since
    the alternative — the elastic shrink-to-pow2 restart — loses capacity
    for the tenant's whole remaining lifetime.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from repro_torch.core.cost_model import LinkModel
from repro_torch.core.fabric import CircuitError, LumorphRack
from repro_torch.core.policy import MorphObjective
from repro_torch.core.pricing import SchedulePricer
from repro_torch.core.scheduler import (build_any_schedule, candidate_algos,
                                  order_for_locality)
from repro_torch.morph.plan import (MorphCost, MorphPlan, plan_bypass,
                              plan_compaction, plan_scale_down, plan_scale_up)

#: price one algorithm on one concrete, ordered chip tuple
PriceFn = Callable[[str, tuple[int, ...], float], float]


@dataclasses.dataclass(frozen=True)
class MorphConfig:
    """Knobs for the morph policy (all default to the paper-faithful
    aggressive setting: morph whenever it provably helps)."""

    compaction: bool = True
    bypass: bool = True
    #: require at least this many seconds of per-step collective saving
    min_gain_s: float = 0.0
    #: only compact when saving × remaining steps > morph cost
    amortize: bool = True
    #: per-chip shard state each move ships; ``None`` → the tenant's
    #: collective buffer size (DP training: every rank holds a full
    #: parameter replica of the same order as the gradient buffer)
    state_bytes: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class PricedMorph:
    """A plan the policy endorses, with both worlds priced."""

    plan: MorphPlan
    cost: MorphCost
    old_step_s: float  # per-step collective on the current layout
    new_step_s: float  # per-step collective on the morphed layout

    @property
    def step_gain_s(self) -> float:
        return self.old_step_s - self.new_step_s


class MorphPolicy:
    """Prices candidate morphs against a rack model and a link model.

    ``pricer`` lets a caller share its
    :class:`~repro_torch.core.pricing.SchedulePricer` — the rack simulator
    passes its own, so policy decisions and simulated collectives are
    priced by literally the same cache (canonical layouts, lower-bound
    pruning and all).  ``price`` injects a bare pricing function instead
    (no pruning) for callers that want full control.
    """

    def __init__(self, config: MorphConfig, rack: LumorphRack,
                 link: LinkModel, algos: Sequence[str],
                 tiles_per_server: int,
                 price: Optional[PriceFn] = None,
                 chips_per_rack: Optional[int] = None,
                 pricer: Optional[SchedulePricer] = None,
                 objective: Optional[MorphObjective] = None):
        self.config = config
        self.rack = rack
        self.link = link
        self.algos = tuple(algos)
        self.tiles_per_server = tiles_per_server
        #: ranks candidate compaction targets; the default objective is
        #: the legacy behavior exactly (one pack_layout target)
        self.objective = objective if objective is not None else MorphObjective()
        #: pod morphs: rack granularity for same-rack-preferring targets
        #: and hierarchical collective candidates (None = single rack)
        self.chips_per_rack = chips_per_rack
        self.pricer = pricer
        #: an explicitly injected price function takes precedence over the
        #: shared pricer everywhere (including step_cost's pruned path)
        self._explicit_price = price is not None
        if price is None and pricer is not None:
            price = pricer.price
        self._price = price or self._default_price

    # -- pricing -------------------------------------------------------------
    def _default_price(self, algo: str, chips: tuple[int, ...],
                       n_bytes: float) -> float:
        try:
            sched = build_any_schedule(algo, chips, n_bytes,
                                       chips_per_rack=self.chips_per_rack)
        except ValueError:
            if not algo.startswith("hier:"):
                raise  # a flat-builder bug must fail loudly, not price inf
            return float("inf")  # hier inadmissible on this layout
        try:
            sched.validate(self.rack, check_fibers=False)
        except CircuitError:
            return float("inf")
        return sched.cost(self.link, rack=self.rack)

    def step_cost(self, chips: Sequence[int], width: int,
                  n_bytes: float) -> float:
        """Cheapest admissible per-step ALLREDUCE on this concrete layout
        (participants locality-ordered, hierarchical candidates included
        for rack-spanning slices — exactly like the simulator)."""
        if width <= 1:
            return 0.0
        ordered = tuple(order_for_locality(tuple(chips)[:width],
                                           self.tiles_per_server,
                                           chips_per_rack=self.chips_per_rack))
        algos = candidate_algos(self.algos, ordered, self.chips_per_rack)
        if self.pricer is not None and not self._explicit_price:
            # shared fast path: bound-and-prune over the same cache the
            # simulator prices steps from (identical minima by the lower-
            # bound contract)
            return self.pricer.cheapest(algos, ordered, n_bytes)
        return min(self._price(a, ordered, n_bytes) for a in algos)

    def _state_bytes(self, coll_bytes: float) -> float:
        return (self.config.state_bytes if self.config.state_bytes is not None
                else coll_bytes)

    # -- proposals -----------------------------------------------------------
    def propose_compaction(self, tenant: str, chips: Sequence[int],
                           width: int, coll_bytes: float,
                           remaining_steps: int,
                           free: Sequence[int]) -> Optional[PricedMorph]:
        """Endorse a compaction iff it strictly lowers the tenant's
        per-step collective cost and (if amortizing) pays for itself over
        the tenant's remaining steps.  The objective may supply several
        candidate targets; every candidate must pass the same strict-gain
        and amortization gates, then the objective ranks the survivors."""
        if not self.config.compaction or remaining_steps <= 0:
            return None
        state_bytes = self._state_bytes(coll_bytes)
        targets = self.objective.compaction_targets(
            chips, free, self.tiles_per_server, self.chips_per_rack)
        move_s = (self.link.alpha + self.link.reconfig
                  + state_bytes / self.link.bw)
        best: Optional[tuple[float, PricedMorph]] = None
        for target in targets:
            plan = plan_compaction(tenant, chips, free, self.tiles_per_server,
                                   state_bytes, rack=self.rack,
                                   chips_per_rack=self.chips_per_rack,
                                   target=target)
            if plan is None:
                continue
            old_s = self.step_cost(plan.old_chips, width, coll_bytes)
            new_s = self.step_cost(plan.new_chips, width, coll_bytes)
            gain = old_s - new_s
            if not (gain > self.config.min_gain_s and gain > 0.0):
                continue
            cost = plan.cost(self.link, rack=self.rack)
            if self.config.amortize and gain * remaining_steps <= cost.total_s:
                continue
            pm = PricedMorph(plan=plan, cost=cost, old_step_s=old_s,
                             new_step_s=new_s)
            free_after = (set(free) | set(plan.old_chips)) - set(plan.new_chips)
            score = self.objective.score(pm, remaining_steps, free_after,
                                         self.tiles_per_server, move_s)
            if best is None or score < best[0]:
                best = (score, pm)
        return best[1] if best is not None else None

    def propose_bypass(self, tenant: str, chips: Sequence[int], width: int,
                       coll_bytes: float, dead: Sequence[int],
                       free: Sequence[int]) -> Optional[PricedMorph]:
        """Endorse a bypass whenever the planner finds one: full width is
        preserved and the job's in-flight step survives, at the price of
        the state replay (charged to the tenant by the caller)."""
        if not self.config.bypass:
            return None
        plan = plan_bypass(tenant, chips, dead, free, self.tiles_per_server,
                           self._state_bytes(coll_bytes), rack=self.rack,
                           chips_per_rack=self.chips_per_rack)
        if plan is None:
            return None
        old_s = self.step_cost(plan.old_chips, width, coll_bytes)
        new_s = self.step_cost(plan.new_chips, width, coll_bytes)
        return PricedMorph(plan=plan, cost=plan.cost(self.link, rack=self.rack),
                           old_step_s=old_s, new_step_s=new_s)

    def propose_scale_up(self, tenant: str, chips: Sequence[int], n_new: int,
                         state_bytes: float, free: Sequence[int],
                         whatif_bytes: Optional[float] = None,
                         ) -> Optional[PricedMorph]:
        """Endorse growing a serving slice by ``n_new`` chips iff the pool
        can supply them *and* the grown layout admits a collective — the
        what-if admission test: the candidate layout is priced through the
        shared :class:`~repro_torch.core.pricing.SchedulePricer` before any chip
        moves, so an autoscaler never grows into a layout the fabric
        cannot serve."""
        plan = plan_scale_up(tenant, chips, free, n_new, self.tiles_per_server,
                             state_bytes, rack=self.rack,
                             chips_per_rack=self.chips_per_rack)
        if plan is None:
            return None
        b = whatif_bytes if whatif_bytes is not None else state_bytes
        old_s = self.step_cost(plan.old_chips, len(plan.old_chips), b)
        new_s = self.step_cost(plan.new_chips, len(plan.new_chips), b)
        if new_s == float("inf"):
            return None  # no admissible collective on the grown layout
        return PricedMorph(plan=plan, cost=plan.cost(self.link, rack=self.rack),
                           old_step_s=old_s, new_step_s=new_s)

    def propose_scale_down(self, tenant: str, chips: Sequence[int],
                           keep: Sequence[int], drain_bytes: float,
                           whatif_bytes: Optional[float] = None,
                           ) -> Optional[PricedMorph]:
        """Endorse shrinking a serving slice to ``keep``: worth it
        whenever feasible (the freed chips return to the pool; the only
        price is draining in-flight state off the leaving chips) — but
        never onto a layout with no admissible collective, the same
        what-if admission guard as :meth:`propose_scale_up`."""
        plan = plan_scale_down(tenant, chips, keep, self.tiles_per_server,
                               drain_bytes, rack=self.rack,
                               chips_per_rack=self.chips_per_rack)
        if plan is None:
            return None
        b = whatif_bytes if whatif_bytes is not None else drain_bytes
        old_s = self.step_cost(plan.old_chips, len(plan.old_chips), b)
        new_s = self.step_cost(plan.new_chips, len(plan.new_chips), b)
        if new_s == float("inf"):
            return None  # no admissible collective on the shrunk layout
        return PricedMorph(plan=plan, cost=plan.cost(self.link, rack=self.rack),
                           old_step_s=old_s, new_step_s=new_s)
