"""Morph planning: live slice transformations on a LUMORPH rack.

The port's copy of ``repro.morph.plan``, line for line.

A *morph* changes a running tenant's chip set without stopping the job:
the fabric reprograms circuits (3.7 µs MZI windows) and the tenant's
shard state rides along as Schedule-IR :class:`~repro_torch.core.scheduler.Transfer`
rounds.  Two plan families:

  * **compaction** — after departures scatter the rack, remap a
    surviving tenant's chips toward the densest-server-first layout its
    size admits, so low-stride collective rounds stay inside servers and
    the slice's ``Schedule.cost`` drops (fewer inter-server circuits to
    time-share over scarce fibers).
  * **failure bypass** — when a chip dies and a free chip exists, swap
    the free chip into the slice and replay the lost shard's state from a
    surviving data-parallel peer (every DP rank holds a full parameter
    replica), instead of tearing the slice down for an elastic
    shrink-to-pow2 restart.

Every plan is *priced* (``MorphPlan.cost``: MZI reconfigurations +
state-move bytes over ``Schedule.cost``) and *validated*
(``MorphPlan.validate``: chip conservation, disjoint move endpoints,
TRX-bank feasibility of every intermediate wave, and the
state-never-lost rule that each chip in the new layout either keeps its
state in place or receives it from exactly one live source).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.cost_model import LinkModel
from repro_torch.core.fabric import LumorphRack
from repro_torch.core.rack import Pod, group_by_rack
from repro_torch.core.scheduler import Schedule, transfer_schedule

#: plan kinds
COMPACTION = "compaction"
BYPASS = "bypass"
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"


class MorphError(RuntimeError):
    """A morph plan is structurally invalid or cannot be applied."""


@dataclasses.dataclass(frozen=True)
class MorphCost:
    """Price of executing one plan, in the α–β + MZI currency."""

    move_s: float  # state-move schedule time (waves: α + reconfig + bytes·β)
    reestablish_s: float  # final MZI window restoring the tenant's circuits
    reconfig_windows: int  # MZI windows total (one per wave + re-establish)
    bytes_moved: float

    @property
    def total_s(self) -> float:
        return self.move_s + self.reestablish_s


@dataclasses.dataclass(frozen=True)
class MorphPlan:
    """One live transformation of one tenant's slice.

    ``moves`` lists the state copies ``(src_chip, dst_chip)``; sources are
    live state holders (the moving chip itself for compaction, a surviving
    DP peer for bypass), destinations are the chips entering the slice.
    ``schedule`` is the same moves lowered to Schedule-IR waves.
    """

    tenant: str
    kind: str  # COMPACTION | BYPASS
    old_chips: tuple[int, ...]
    new_chips: tuple[int, ...]
    moves: tuple[tuple[int, int], ...]
    state_bytes: float  # per-chip shard state shipped by each move
    schedule: Schedule

    @property
    def n_moves(self) -> int:
        return len(self.moves)

    def cost(self, link: LinkModel,
             rack: "Optional[LumorphRack | Pod]" = None) -> MorphCost:
        """MZI reconfigurations + state-move bytes, priced over
        ``Schedule.cost`` (fiber/rail time-sharing included when ``rack``
        is given), plus one final window to re-establish the tenant's
        collective circuits on the morphed layout — the slower rail OCS
        window when the morphed slice spans racks, since its collective
        circuits then include rail circuits."""
        move_s = self.schedule.cost(link, rack=rack)
        reestablish = link.reconfig
        if isinstance(rack, Pod):
            reestablish = rack.reconfig_window(self.new_chips, reestablish)
        return MorphCost(move_s=move_s,
                         reestablish_s=reestablish,
                         reconfig_windows=self.schedule.reconfigurations() + 1,
                         bytes_moved=self.state_bytes * len(self.moves))

    def validate(self, rack: Optional[LumorphRack] = None) -> None:
        """Raise :class:`MorphError` unless the plan upholds the morph
        invariants; with ``rack``, additionally check every intermediate
        wave against the photonic TRX/wavelength limits."""
        old, new = set(self.old_chips), set(self.new_chips)
        if len(old) != len(self.old_chips) or len(new) != len(self.new_chips):
            raise MorphError(f"{self.tenant}: duplicate chips in layout")
        entering = new - old
        if self.kind == COMPACTION and len(new) != len(old):
            raise MorphError(
                f"{self.tenant}: chip conservation violated "
                f"({len(old)} chips before, {len(new)} after)")
        if self.kind == BYPASS:
            # conservation with retirement: every old chip is either kept
            # or retired dead; the slice may shrink only by the dead chips
            # the free pool could not replace (still ≥ the pow2 shrink)
            if not new - entering <= old:
                raise MorphError(f"{self.tenant}: bypass invented chips")
            if len(new) > len(old):
                raise MorphError(f"{self.tenant}: bypass grew the slice")
        if self.kind == SCALE_UP:
            if not old <= new:
                raise MorphError(
                    f"{self.tenant}: scale-up dropped chips {sorted(old - new)}")
            if len(new) <= len(old):
                raise MorphError(f"{self.tenant}: scale-up did not grow the slice")
        if self.kind == SCALE_DOWN:
            if not new <= old:
                raise MorphError(
                    f"{self.tenant}: scale-down invented chips {sorted(new - old)}")
            if len(new) >= len(old):
                raise MorphError(
                    f"{self.tenant}: scale-down did not shrink the slice")
        dsts = [d for _, d in self.moves]
        survivors = old & new
        if self.kind == SCALE_DOWN:
            # drains, not replays: every leaving chip may hand its in-flight
            # state to a surviving chip (a survivor can absorb several drains
            # across waves, so destination uniqueness is per-wave only —
            # checked with the endpoint-disjointness below)
            srcs = {s for s, _ in self.moves}
            if not srcs <= old - new:
                raise MorphError(
                    f"{self.tenant}: drain sources {sorted(srcs - (old - new))} "
                    "are not leaving the slice")
            bad = sorted({d for d in dsts if d not in survivors})
            if bad:
                raise MorphError(
                    f"{self.tenant}: drain destinations {bad} leave the slice")
        else:
            if len(set(dsts)) != len(dsts):
                raise MorphError(f"{self.tenant}: chip receives two state copies")
            if set(dsts) != entering:
                raise MorphError(
                    f"{self.tenant}: state-never-lost violated — entering chips "
                    f"{sorted(entering)} vs move destinations {sorted(set(dsts))}")
        for s, d in self.moves:
            if self.kind == COMPACTION and s not in old:
                raise MorphError(f"{self.tenant}: move source {s} holds no state")
            if self.kind in (BYPASS, SCALE_UP) and s not in survivors:
                raise MorphError(
                    f"{self.tenant}: {self.kind} source {s} is not a "
                    "surviving peer")
        if self.kind == COMPACTION:
            # a compaction move relocates a chip's own shard
            srcs = {s for s, _ in self.moves}
            if srcs != old - new:
                raise MorphError(
                    f"{self.tenant}: leaving chips {sorted(old - new)} vs "
                    f"move sources {sorted(srcs)}")
        for i, wave in enumerate(self.schedule.rounds):
            ends: set[int] = set()
            for s, d in wave.pairs:
                if s in ends or d in ends:
                    raise MorphError(
                        f"{self.tenant}: wave {i} reuses an endpoint — "
                        f"state could be overwritten mid-flight")
                ends.update((s, d))
        if rack is not None:
            try:
                self.schedule.validate(rack, check_fibers=False)
            except Exception as e:
                raise MorphError(f"{self.tenant}: infeasible state move: {e}") from e


# ---------------------------------------------------------------------------
# Layout targets
# ---------------------------------------------------------------------------

def pack_layout(chips: Sequence[int], free: Sequence[int],
                tiles_per_server: int,
                chips_per_rack: Optional[int] = None) -> tuple[int, ...]:
    """Densest-server-first target layout for a ``len(chips)``-sized slice
    drawing on ``chips ∪ free``.

    Mirrors ``LumorphAllocator``'s admission-time packing, but breaks ties
    toward chips the tenant already holds so a compaction plan moves as
    little state as possible.  With ``chips_per_rack`` (pod morphs) racks
    are filled one at a time — tenant-occupied, candidate-dense racks
    first — so a compaction prefers same-rack remaps and shrinks the rack
    span before the server span (state over rails is the expensive move).
    """
    k = len(chips)
    owned = set(chips)
    candidates = owned | set(free)
    if chips_per_rack is not None:
        by_rack = group_by_rack(candidates, chips_per_rack)
        # a single rack that can host the whole slice wins outright: rack
        # span 1 frees every future step from rail pricing.  Prefer the
        # rack holding the most tenant chips (fewest cross-rack state
        # moves) — whether those moves pay off is the *policy's* call
        # (strict gain + amortization over the priced plan).
        hosts = [r for r in by_rack if len(by_rack[r]) >= k]
        if hosts:
            best = min(hosts, key=lambda r: (
                -sum(1 for c in by_rack[r] if c in owned),
                -len(by_rack[r]), r))
            return tuple(sorted(
                _pack_one_rack(by_rack[best], owned, k, tiles_per_server)))
        rack_order = sorted(
            by_rack,
            key=lambda r: (-sum(1 for c in by_rack[r] if c in owned),
                           -len(by_rack[r]), r))
        picked: list[int] = []
        for rk in rack_order:
            room = k - len(picked)
            if room <= 0:
                break
            picked.extend(_pack_one_rack(by_rack[rk], owned,
                                         min(room, len(by_rack[rk])),
                                         tiles_per_server))
        return tuple(sorted(picked))
    return tuple(sorted(_pack_one_rack(candidates, owned, k, tiles_per_server)))


def _pack_one_rack(candidates, owned: set, k: int,
                   tiles_per_server: int) -> list[int]:
    by_server: dict[int, list[int]] = {}
    for c in candidates:
        by_server.setdefault(c // tiles_per_server, []).append(c)
    # densest server first; among equally dense servers prefer the one
    # where the tenant already has the most chips (fewer moves), then the
    # lowest id for determinism
    order = sorted(
        by_server,
        key=lambda s: (-len(by_server[s]),
                       -sum(1 for c in by_server[s] if c in owned), s))
    picked: list[int] = []
    for srv in order:
        room = k - len(picked)
        if room <= 0:
            break
        # within a server prefer owned chips (no state move), then low ids
        chips_here = sorted(by_server[srv], key=lambda c: (c not in owned, c))
        picked.extend(sorted(chips_here[:min(room, len(chips_here))]))
    return picked


def _server_spans(chips: Sequence[int], tiles_per_server: int) -> int:
    return len({c // tiles_per_server for c in chips})


def _rack_spans(chips: Sequence[int], chips_per_rack: Optional[int]) -> int:
    if chips_per_rack is None:
        return 1
    return len({c // chips_per_rack for c in chips})


def _match_moves(leaving: Sequence[int], entering: Sequence[int],
                 tiles_per_server: int,
                 chips_per_rack: Optional[int] = None) -> list[tuple[int, int]]:
    """Pair each leaving chip with an entering chip, preferring moves that
    stay inside one server (free: no fiber, no time-sharing), then inside
    one rack (fiber, but no rail)."""
    leaving = sorted(leaving)
    entering = sorted(entering)
    moves: list[tuple[int, int]] = []
    remaining = list(entering)
    for src in leaving:
        srv = src // tiles_per_server
        same = [d for d in remaining if d // tiles_per_server == srv]
        if not same and chips_per_rack is not None:
            rk = src // chips_per_rack
            same = [d for d in remaining if d // chips_per_rack == rk]
        dst = same[0] if same else remaining[0]
        remaining.remove(dst)
        moves.append((src, dst))
    return moves


def _wave_split(moves: Sequence[tuple[int, int]],
                rack: Optional[LumorphRack]) -> list[list[tuple[int, int]]]:
    """Split moves into waves with pairwise-disjoint endpoints that each
    pass the rack's TRX dry check.  Planner moves are already endpoint-
    disjoint, so this is one wave unless the rack disagrees."""
    waves: list[list[tuple[int, int]]] = []
    for mv in moves:
        placed = False
        for wave in waves:
            ends = {c for p in wave for c in p}
            if mv[0] in ends or mv[1] in ends:
                continue
            if rack is None or rack.feasible_round(wave + [mv], check_fibers=False):
                wave.append(mv)
                placed = True
                break
        if not placed:
            waves.append([mv])
    return waves


def _replacements(anchors: Sequence[int], pool: Sequence[int], want: int,
                  tiles_per_server: int,
                  chips_per_rack: Optional[int]) -> list[int]:
    """Pick ``want`` free chips from ``pool`` to graft onto a slice whose
    live chips are ``anchors``: the anchors' own servers first, then their
    racks on a pod, densest free server as the fallback — shared by the
    failure-bypass and scale-up planners."""
    anchor_servers = {c // tiles_per_server for c in anchors}
    anchor_racks = ({c // chips_per_rack for c in anchors}
                    if chips_per_rack is not None else set())

    def _rack_of_server(s: int) -> int:
        return (s * tiles_per_server) // chips_per_rack if chips_per_rack else 0

    by_server: dict[int, list[int]] = {}
    for c in pool:
        by_server.setdefault(c // tiles_per_server, []).append(c)
    order = sorted(by_server, key=lambda s: (
        s not in anchor_servers,
        chips_per_rack is not None and _rack_of_server(s) not in anchor_racks,
        -len(by_server[s]), s))
    picked: list[int] = []
    for srv in order:
        room = want - len(picked)
        if room <= 0:
            break
        picked.extend(sorted(by_server[srv])[:room])
    return picked


# ---------------------------------------------------------------------------
# Planners
# ---------------------------------------------------------------------------

def plan_compaction(tenant: str, chips: Sequence[int], free: Sequence[int],
                    tiles_per_server: int, state_bytes: float,
                    rack: Optional[LumorphRack] = None,
                    chips_per_rack: Optional[int] = None,
                    target: Optional[Sequence[int]] = None) -> Optional[MorphPlan]:
    """Plan remapping ``tenant``'s slice toward the densest-server-first
    layout reachable from the current free pool.

    Returns ``None`` when the tenant is already packed as tightly as the
    free pool allows (no moves, or the target does not reduce the spans
    pricing keys on — on a pod the rack span first, then the server
    span; same-rack remaps are preferred because cross-rack state moves
    ride the slower rails).

    ``target`` overrides the default ``pack_layout`` destination — a
    :class:`~repro_torch.core.policy.MorphObjective` supplies alternates; an
    invalid target (wrong width, or chips outside the tenant's slice and
    the free pool) yields ``None`` rather than an unreachable plan."""
    old = tuple(sorted(chips))
    if target is None:
        target = pack_layout(chips, free, tiles_per_server,
                             chips_per_rack=chips_per_rack)
    else:
        target = tuple(sorted(target))
        if (len(target) != len(old) or len(set(target)) != len(target)
                or not set(target) <= set(chips) | set(free)):
            return None
    if target == old:
        return None
    span = (_rack_spans(target, chips_per_rack),
            _server_spans(target, tiles_per_server))
    if span >= (_rack_spans(old, chips_per_rack),
                _server_spans(old, tiles_per_server)):
        return None  # a sideways shuffle: no locality to gain
    leaving = sorted(set(old) - set(target))
    entering = sorted(set(target) - set(old))
    moves = _match_moves(leaving, entering, tiles_per_server,
                         chips_per_rack=chips_per_rack)
    sched = transfer_schedule(_wave_split(moves, rack), state_bytes,
                              tag="morph-compaction")
    plan = MorphPlan(tenant=tenant, kind=COMPACTION, old_chips=old,
                     new_chips=target, moves=tuple(moves),
                     state_bytes=state_bytes, schedule=sched)
    plan.validate(rack)
    return plan


def plan_bypass(tenant: str, chips: Sequence[int], dead: Sequence[int],
                free: Sequence[int], tiles_per_server: int,
                state_bytes: float,
                rack: Optional[LumorphRack] = None,
                chips_per_rack: Optional[int] = None) -> Optional[MorphPlan]:
    """Plan swapping ``dead`` chips out of ``tenant``'s slice for free
    replacements, replaying each lost shard from a surviving DP peer.

    All surviving shards stay in place.  When the free pool has fewer
    chips than died, the bypass is *partial*: it replaces what it can and
    the slice shrinks only by the unreplaced dead chips — still at least
    as wide as the elastic policy's shrink-to-pow2 restart, and without
    losing the in-flight step.  Returns ``None`` when no chip actually
    died or no peer survives to source the state."""
    old = tuple(sorted(chips))
    lost = sorted(set(dead) & set(old))
    if not lost:
        return None
    survivors = [c for c in old if c not in set(lost)]
    pool = sorted(set(free) - set(dead) - set(old))
    if not survivors:
        return None
    want = min(len(lost), len(pool))  # partial when the pool is short
    replacements = _replacements(survivors, pool, want, tiles_per_server,
                                 chips_per_rack)
    # each replacement replays state from a distinct surviving peer; more
    # dead chips than survivors → extra waves reuse peers sequentially
    moves = [(survivors[i % len(survivors)], r)
             for i, r in enumerate(replacements)]
    waves: list[list[tuple[int, int]]] = []
    for i in range(0, len(moves), len(survivors)):
        waves.extend(_wave_split(moves[i:i + len(survivors)], rack))
    sched = transfer_schedule(waves, state_bytes, tag="morph-bypass")
    plan = MorphPlan(tenant=tenant, kind=BYPASS, old_chips=old,
                     new_chips=tuple(sorted(survivors + replacements)),
                     moves=tuple(moves), state_bytes=state_bytes,
                     schedule=sched)
    plan.validate(rack)
    return plan


def plan_scale_up(tenant: str, chips: Sequence[int], free: Sequence[int],
                  n_new: int, tiles_per_server: int, state_bytes: float,
                  rack: Optional[LumorphRack] = None,
                  chips_per_rack: Optional[int] = None) -> Optional[MorphPlan]:
    """Plan growing ``tenant``'s live slice by ``n_new`` free chips
    (serving autoscale: adding prefill/decode replicas under traffic).

    Entering chips are packed next to the slice (same servers, then same
    racks, then densest free server — the bypass search).  Each entering
    chip receives its replica shard from an existing holder, round-robin
    over the old slice so the replays spread across source chips and the
    waves stay wide.  Returns ``None`` when the pool cannot supply all
    ``n_new`` chips — a partial grow would leave a ragged replica, so the
    caller retries with fewer replicas instead."""
    old = tuple(sorted(chips))
    pool = sorted(set(free) - set(old))
    if n_new <= 0 or not old or len(pool) < n_new:
        return None
    entering = sorted(_replacements(old, pool, n_new, tiles_per_server,
                                    chips_per_rack))
    if len(entering) < n_new:
        return None
    moves = [(old[i % len(old)], e) for i, e in enumerate(entering)]
    sched = transfer_schedule(_wave_split(moves, rack), state_bytes,
                              tag="morph-scale-up")
    plan = MorphPlan(tenant=tenant, kind=SCALE_UP, old_chips=old,
                     new_chips=tuple(sorted(old + tuple(entering))),
                     moves=tuple(moves), state_bytes=state_bytes,
                     schedule=sched)
    plan.validate(rack)
    return plan


def plan_scale_down(tenant: str, chips: Sequence[int], keep: Sequence[int],
                    tiles_per_server: int, drain_bytes: float,
                    rack: Optional[LumorphRack] = None,
                    chips_per_rack: Optional[int] = None) -> Optional[MorphPlan]:
    """Plan shrinking ``tenant``'s live slice to exactly ``keep`` (serving
    autoscale: releasing replicas back to the pool when traffic ebbs).

    Each leaving chip *drains* its in-flight state (KV cache of the
    requests it is still serving) to a surviving chip — same-server
    destinations first, then same-rack — so no request is dropped by the
    shrink.  Survivors may absorb several drains; the wave split keeps
    every wave endpoint-disjoint.  Returns ``None`` when ``keep`` is not
    a strict non-empty subset of the current slice."""
    old = tuple(sorted(chips))
    new = tuple(sorted(keep))
    if not new or set(new) == set(old) or not set(new) < set(old):
        return None
    leaving = sorted(set(old) - set(new))
    survivors = list(new)
    moves: list[tuple[int, int]] = []
    for i, src in enumerate(leaving):
        srv = src // tiles_per_server
        cands = [d for d in survivors if d // tiles_per_server == srv]
        if not cands and chips_per_rack is not None:
            rk = src // chips_per_rack
            cands = [d for d in survivors if d // chips_per_rack == rk]
        if not cands:
            cands = survivors
        moves.append((src, cands[i % len(cands)]))
    sched = transfer_schedule(_wave_split(moves, rack), drain_bytes,
                              tag="morph-scale-down")
    plan = MorphPlan(tenant=tenant, kind=SCALE_DOWN, old_chips=old,
                     new_chips=new, moves=tuple(moves),
                     state_bytes=drain_bytes, schedule=sched)
    plan.validate(rack)
    return plan
