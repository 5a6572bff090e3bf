"""Pluggable placement and morph objectives (ROADMAP item 4).

The port's copy of ``repro.core.policy`` (the placement policies, not
``sharding.policy``). It keeps the reference's behaviour exactly, including
``whatif``'s ideal layout ``range(k)``, which is not always the cheapest, so
an ``Admission.stretch`` can fall below 1 (ROADMAP, reference fault (b)).

Placement, compaction and admission were each hard-coded to a single
heuristic (densest-server-first packing, best-fit racks).  This module
turns them into *policies*:

  * :class:`PlacementPolicy` scores candidate chip sets for an
    allocation request.  Three built-in objectives:

      - ``packing`` — the legacy densest-server-first heuristic,
        bit-identical to the pre-policy allocators (the default).
      - ``locality`` — among a small candidate set (legacy choice, a
        best-fit "tight" variant, alternate racks on a pod), pick the
        placement whose cheapest admissible collective — priced through
        the shared :class:`~repro_torch.core.pricing.SchedulePricer` — is
        strictly cheapest.  Ties keep the legacy choice.
      - ``future-morph`` — *Morphlux*-style lookahead: price the
        placement's collective **plus** the expected future compaction
        cost of the residual free-pool shape (stranded chips on
        partially-free servers will eventually be morphed together; a
        placement that strands fewer chips is worth a slightly dearer
        step today).

  * :class:`MorphObjective` scores candidate compaction targets for
    :class:`~repro_torch.morph.policy.MorphPolicy` — the same three flavors,
    so a simulator run can thread one objective through admission *and*
    runtime morphing (``PlacementPolicy.morph_objective()``).

  * :meth:`PlacementPolicy.whatif` is the what-if capacity planner: "can
    this pod absorb a ``k``-chip tenant without evictions, and at what
    collective stretch?" — answered by pricing the candidate placement
    through the shared pricer *without committing any chips*.  The
    serve autoscaler's ``propose_scale_up`` admission guard and the
    allocators' admission paths both reduce to this primitive.

Policies price layouts but never mutate allocator state; the allocator
remains the single owner of the free pool.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Iterable, Optional, Sequence

from repro_torch.core.rack import group_by_rack
from repro_torch.core.scheduler import candidate_algos, order_for_locality

if TYPE_CHECKING:  # avoid a hard import cycle with pricing/morph
    from repro_torch.core.pricing import SchedulePricer

#: reference ALLREDUCE payload for placement scoring and what-if pricing
#: when the caller does not know the tenant's real collective size yet.
#: Placement *ranking* is insensitive to the payload for a fixed algo set
#: (α and β terms scale together across candidate layouts), so one shared
#: size keeps the pricer cache hot across requests.
WHATIF_BYTES = float(64 << 20)

#: steps over which a lookahead policy amortizes expected future morph
#: cost (the zoo mix's mean job runs ~20 steps).
LOOKAHEAD_STEPS = 20

PLACEMENTS = ("packing", "locality", "future-morph")


@dataclasses.dataclass(frozen=True)
class FabricGeometry:
    """The placement-relevant shape of the fabric, built by the allocator."""

    tiles_per_server: int
    chips_per_rack: Optional[int] = None  # None → single rack
    span_racks: bool = True


@dataclasses.dataclass(frozen=True)
class Admission:
    """A what-if verdict: would this request be admitted, where, at what
    collective stretch — priced without committing chips."""

    admitted: bool
    chips: tuple[int, ...]  # the placement that would be committed
    step_s: float  # cheapest admissible per-step collective there
    ideal_s: float  # same-width collective on an ideal dense layout
    reason: str = ""  # "" | "capacity" | "fragmentation" | "inadmissible"

    @property
    def stretch(self) -> float:
        """How much dearer the placed collective is than the ideal one."""
        if self.step_s == float("inf"):
            return float("inf")  # rejected / inadmissible: no finite stretch
        if self.step_s == self.ideal_s:
            return 1.0
        if self.ideal_s <= 0.0:
            return float("inf")
        return self.step_s / self.ideal_s


# ---------------------------------------------------------------------------
# Packing primitives (moved verbatim from the allocators)
# ---------------------------------------------------------------------------

def pack_dense(candidates: Iterable[int], k: int,
               tiles_per_server: int) -> list[int]:
    """Densest-server-first packing of ``k`` chips from ``candidates``:
    minimizes the number of servers a tenant spans, conserving the
    rack's inter-server fiber budget.  (The legacy
    ``LumorphAllocator._pack``, verbatim — tie-breaking is stable over
    the iteration order of ``candidates``.)"""
    by_server: dict[int, list[int]] = {}
    for c in candidates:
        by_server.setdefault(c // tiles_per_server, []).append(c)
    order = sorted(by_server.values(), key=len, reverse=True)
    picked: list[int] = []
    for server_chips in order:
        take = min(k - len(picked), len(server_chips))
        picked.extend(sorted(server_chips)[:take])
        if len(picked) == k:
            break
    return picked


def pack_tight(candidates: Iterable[int], k: int,
               tiles_per_server: int) -> list[int]:
    """Best-fit packing: take the *smallest* server hole that still fits
    the whole request, preserving fully-free servers for future wide
    tenants; requests wider than any hole fill partially-free servers
    first and break into whole servers last."""
    by_server: dict[int, list[int]] = {}
    for c in candidates:
        by_server.setdefault(c // tiles_per_server, []).append(c)
    fitting = [s for s in by_server if len(by_server[s]) >= k]
    if fitting:
        best = min(fitting, key=lambda s: (len(by_server[s]), s))
        return sorted(by_server[best])[:k]
    order = sorted(by_server, key=lambda s: (
        len(by_server[s]) >= tiles_per_server, -len(by_server[s]), s))
    picked: list[int] = []
    for srv in order:
        take = min(k - len(picked), len(by_server[srv]))
        picked.extend(sorted(by_server[srv])[:take])
        if len(picked) == k:
            break
    return picked


def place_packing(free: Iterable[int], k: int,
                  geom: FabricGeometry) -> Optional[tuple[int, ...]]:
    """The legacy placement, bit-identical to the pre-policy allocators:
    densest-server-first on a rack; best-fit rack then minimal equal-share
    spanning on a pod.  ``None`` means fragmentation (rack-confined pod
    with no single-rack fit) — a capacity shortfall is the caller's check."""
    tps = geom.tiles_per_server
    if geom.chips_per_rack is None:
        return tuple(pack_dense(free, k, tps))
    by_rack = group_by_rack(free, geom.chips_per_rack)
    fits = [r for r, chips in by_rack.items() if len(chips) >= k]
    if fits:  # rack-first: zero rail crossings, best-fit rack
        rack = min(fits, key=lambda r: (len(by_rack[r]), r))
        return tuple(pack_dense(by_rack[rack], k, tps))
    if not geom.span_racks:
        return None
    # span the minimal number of racks (most-free racks first)
    racks = sorted(by_rack, key=lambda r: (-len(by_rack[r]), r))
    span, have = [], 0
    for r in racks:
        span.append(r)
        have += len(by_rack[r])
        if have >= k:
            break
    share, rem = divmod(k, len(span))
    if rem == 0 and all(len(by_rack[r]) >= share for r in span):
        # equal shares: the hierarchical collective is admissible
        picked = [c for r in span for c in pack_dense(by_rack[r], share, tps)]
    else:  # uneven free pools: greedy fill, still minimal rack count
        picked = []
        for r in span:
            take = min(k - len(picked), len(by_rack[r]))
            picked.extend(pack_dense(by_rack[r], take, tps))
            if len(picked) == k:
                break
    return tuple(picked)


def placement_candidates(free: Iterable[int], k: int,
                         geom: FabricGeometry) -> list[tuple[int, ...]]:
    """The candidate placements a scored policy ranks.  The legacy packing
    choice always comes first, so a policy that ties everywhere reproduces
    it exactly.  Kept small (≤ ~5): every candidate costs one pricer probe."""
    tps = geom.tiles_per_server
    cands: list[tuple[int, ...]] = []
    seen: set[tuple[int, ...]] = set()

    def add(chips) -> None:
        if chips is None or len(chips) != k:
            return
        key = tuple(sorted(chips))
        if key not in seen:
            seen.add(key)
            cands.append(key)

    add(place_packing(free, k, geom))
    if geom.chips_per_rack is None:
        add(pack_tight(free, k, tps))
        return cands
    by_rack = group_by_rack(free, geom.chips_per_rack)
    fits = [r for r, chips in by_rack.items() if len(chips) >= k]
    if fits:
        best = min(fits, key=lambda r: (len(by_rack[r]), r))
        most = max(fits, key=lambda r: (len(by_rack[r]), -r))
        for r in (best, most) if most != best else (best,):
            add(pack_dense(by_rack[r], k, tps))
            add(pack_tight(by_rack[r], k, tps))
    # no single-rack fit: the legacy spanning placement (already added)
    # is the only spanning candidate — alternates rarely beat its
    # equal-share shape and each one costs a rail-tier pricer probe.
    return cands


def stranded_free(free: Iterable[int], tiles_per_server: int) -> int:
    """Free chips stuck on partially-free servers: each will eventually
    cost a state move to defragment (or force a future tenant to span)."""
    by_server: dict[int, int] = {}
    for c in free:
        s = c // tiles_per_server
        by_server[s] = by_server.get(s, 0) + 1
    return sum(n for n in by_server.values() if n < tiles_per_server)


# ---------------------------------------------------------------------------
# Placement policies
# ---------------------------------------------------------------------------

class PlacementPolicy:
    """Scores candidate chip sets for an allocation request.

    The allocator calls :meth:`place` with its live free pool; the
    policy returns the chip set to commit (or ``None`` for a
    fragmentation reject on a rack-confined pod) and never mutates
    allocator state.  Priced policies need :meth:`bind` called once with
    the simulation's shared pricer — the engine does this right after it
    builds the pricer, so policy decisions and simulated collectives are
    priced by literally the same cache.
    """

    name = "base"

    def __init__(self) -> None:
        self._pricer: "Optional[SchedulePricer]" = None
        self._algos: tuple[str, ...] = ()

    # -- wiring --------------------------------------------------------------
    def bind(self, pricer: "SchedulePricer",
             algos: Sequence[str]) -> "PlacementPolicy":
        """Attach the shared pricer + the fabric's algorithm menu."""
        self._pricer = pricer
        self._algos = tuple(algos)
        return self

    @property
    def bound(self) -> bool:
        return self._pricer is not None

    def morph_objective(self) -> "MorphObjective":
        """The matching runtime-morph objective (same flavor)."""
        return MorphObjective()

    # -- placement -----------------------------------------------------------
    def place(self, free: Iterable[int], k: int,
              geom: FabricGeometry) -> Optional[tuple[int, ...]]:
        raise NotImplementedError

    # -- pricing -------------------------------------------------------------
    def _step_price(self, chips: Sequence[int], geom: FabricGeometry,
                    coll_bytes: Optional[float] = None) -> float:
        """Cheapest admissible per-step ALLREDUCE on this concrete layout
        (locality-ordered, hierarchical candidates included) — the same
        pricing the simulator charges per training step."""
        if self._pricer is None:
            raise RuntimeError(
                f"policy {self.name!r} is unbound: call bind(pricer, algos) "
                "before pricing placements")
        if len(chips) <= 1:
            return 0.0
        b = coll_bytes if coll_bytes is not None else WHATIF_BYTES
        ordered = tuple(order_for_locality(tuple(chips), geom.tiles_per_server,
                                           chips_per_rack=geom.chips_per_rack))
        algos = candidate_algos(self._algos, ordered, geom.chips_per_rack)
        return self._pricer.cheapest(algos, ordered, b)

    # -- what-if capacity planner --------------------------------------------
    def whatif(self, free: Iterable[int], k: int, geom: FabricGeometry,
               coll_bytes: Optional[float] = None) -> Admission:
        """Admission verdict for a ``k``-chip tenant against the current
        free pool, priced without committing chips.  The verdict matches
        what :meth:`place` + commit would do: same placement, same
        accept/reject, plus the collective stretch the tenant would pay
        relative to an ideal dense layout."""
        if k <= 0:
            raise ValueError("k must be positive")
        # never copy an incoming set: ``pack_dense`` tie-breaking is stable
        # over its iteration order, and a rebuilt set can iterate
        # differently than the allocator's own — the verdict must pick the
        # *same* chips the allocator would commit
        free = free if isinstance(free, set) else set(free)
        if k > len(free):
            return Admission(admitted=False, chips=(), step_s=float("inf"),
                             ideal_s=float("inf"), reason="capacity")
        chips = self.place(free, k, geom)
        if chips is None:
            return Admission(admitted=False, chips=(), step_s=float("inf"),
                             ideal_s=float("inf"), reason="fragmentation")
        step = self._step_price(chips, geom, coll_bytes)
        ideal = self._step_price(tuple(range(k)), geom, coll_bytes)
        if step == float("inf"):
            return Admission(admitted=False, chips=tuple(sorted(chips)),
                             step_s=step, ideal_s=ideal, reason="inadmissible")
        return Admission(admitted=True, chips=tuple(sorted(chips)),
                         step_s=step, ideal_s=ideal)


class PackingPolicy(PlacementPolicy):
    """The legacy heuristic, bit-identical to the pre-policy allocators."""

    name = "packing"

    def place(self, free, k, geom):
        return place_packing(free, k, geom)


class _ScoredPolicy(PlacementPolicy):
    """Shared shape of the priced policies: enumerate candidates, score
    each, keep the first minimum (so ties preserve the legacy choice)."""

    def _score(self, chips: tuple[int, ...], free: set[int],
               geom: FabricGeometry) -> float:
        raise NotImplementedError

    def place(self, free, k, geom):
        # keep the caller's set object: candidate generation tie-breaks on
        # its iteration order (see whatif)
        free = free if isinstance(free, set) else set(free)
        cands = placement_candidates(free, k, geom)
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0]
        best, best_s = cands[0], None
        for c in cands:
            s = self._score(c, free, geom)
            if best_s is None or s < best_s:
                best, best_s = c, s
        return best


class LocalityPolicy(_ScoredPolicy):
    """Minimize the tenant's own priced collective stretch: among the
    candidates, commit the placement whose cheapest admissible collective
    is strictly cheapest (ties → the legacy packing choice)."""

    name = "locality"

    def _score(self, chips, free, geom):
        return self._step_price(chips, geom)


class FutureMorphPolicy(_ScoredPolicy):
    """*Morphlux*-style lookahead: the step price **plus** the expected
    future morph cost of the free-pool shape the placement leaves behind.
    Each chip stranded on a partially-free server is one future
    compaction state-move, amortized over :data:`LOOKAHEAD_STEPS`; a
    placement that carves up a fully-free server pays for it here."""

    name = "future-morph"

    def morph_objective(self):
        return FutureMorphObjective()

    def _move_s(self) -> float:
        """One-chip state-move estimate in the link's α–β currency."""
        link = self._pricer.link
        return link.alpha + link.reconfig + WHATIF_BYTES / link.bw

    def _score(self, chips, free, geom):
        step = self._step_price(chips, geom)
        residual = free - set(chips)
        stranded = stranded_free(residual, geom.tiles_per_server)
        return step + stranded * self._move_s() / LOOKAHEAD_STEPS


# ---------------------------------------------------------------------------
# Morph objectives
# ---------------------------------------------------------------------------

class MorphObjective:
    """Scores candidate compaction targets for
    :class:`~repro_torch.morph.policy.MorphPolicy`.

    ``compaction_targets`` yields target layouts to plan toward —
    ``None`` entries mean the planner's own default (densest-server-first
    ``pack_layout``).  ``score`` ranks the priced plans (lower is
    better); the default keeps the legacy behavior exactly: one default
    target, ranked by the new layout's step cost.
    """

    name = "packing"

    def compaction_targets(self, chips: Sequence[int], free: Sequence[int],
                           tiles_per_server: int,
                           chips_per_rack: Optional[int] = None,
                           ) -> tuple[Optional[tuple[int, ...]], ...]:
        return (None,)

    def score(self, priced, remaining_steps: int, free_after: set[int],
              tiles_per_server: int, move_s: float) -> float:
        return priced.new_step_s


class LocalityObjective(MorphObjective):
    """Rank by the morphed layout's step cost alone (the default rule,
    named so ``locality`` placement can thread a matching objective)."""

    name = "locality"


class FutureMorphObjective(MorphObjective):
    """Also plan toward a best-fit "tight" target and charge each target
    for the free-pool stranding it leaves — the compaction twin of
    :class:`FutureMorphPolicy`."""

    name = "future-morph"

    def compaction_targets(self, chips, free, tiles_per_server,
                           chips_per_rack=None):
        targets: list[Optional[tuple[int, ...]]] = [None]
        pool = set(chips) | set(free)
        tight = tuple(sorted(pack_tight(pool, len(chips), tiles_per_server)))
        targets.append(tight)
        return tuple(targets)

    def score(self, priced, remaining_steps, free_after, tiles_per_server,
              move_s):
        stranded = stranded_free(free_after, tiles_per_server)
        horizon = max(remaining_steps, 1)
        return (priced.new_step_s
                + stranded * move_s / min(horizon, LOOKAHEAD_STEPS))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_PLACEMENT_REGISTRY: dict[str, type[PlacementPolicy]] = {
    "packing": PackingPolicy,
    "locality": LocalityPolicy,
    "future-morph": FutureMorphPolicy,
}


def register_placement(name: str, cls: type[PlacementPolicy]) -> None:
    """Register a custom placement policy under ``name`` (overwrites)."""
    _PLACEMENT_REGISTRY[name] = cls


def make_policy(name: "str | PlacementPolicy | None") -> PlacementPolicy:
    """Resolve a policy spec: a name from the registry, an instance
    (passed through), or ``None`` → the legacy ``packing`` default."""
    if name is None:
        return PackingPolicy()
    if isinstance(name, PlacementPolicy):
        return name
    cls = _PLACEMENT_REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown placement policy {name!r}; "
                         f"registered: {sorted(_PLACEMENT_REGISTRY)}")
    return cls()
