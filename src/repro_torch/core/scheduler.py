"""The Schedule IR: circuit schedules for collectives on LUMORPH (paper §4).

The port's copy of ``repro.core.scheduler``, line for line: the builders,
pricing on the ideal fabric, a rack or a pod, ``validate``, the chunked
lowering of overlap mode, hierarchical composition, ``candidate_algos``,
``fiber_demand``, ``order_for_locality`` and ``transfer_schedule`` (the
morph planner's state moves), so that both executors read the same
tables and both pricers give the same numbers. One addition: pricing or
validating against anything that is not a ``LumorphRack`` or a ``Pod``
raises ``TypeError`` (the reference fails on a missing attribute).

A :class:`Schedule` is the repo's **single source of truth** for a
collective.  One builder per algorithm lowers ``(participant chips,
n_bytes)`` into rounds of directed circuit pairs *plus* the chunk-index
arithmetic each round needs, and its consumers derive from it:

  * **execution** — ``repro_torch.core.collectives`` runs the rounds on the
    virtual-rank executor (a round's :class:`Transfer` perms are its
    partner maps; the JAX package runs them as ``ppermute``);
  * **pricing** — :meth:`Schedule.cost` prices the rounds with the α–β
    model (``repro_torch.core.cost_model.algorithm_cost`` delegates here);
  * **placement and simulation** — ``core.pricing``, ``core.policy`` and
    ``repro_torch.sim.engine`` price schedules on each tenant's actual
    chips, validated against the rack's photonic limits, with inter-server
    fiber contention.

**Shape vs. Transfer tables.**  The three consumers need very different
amounts of the IR.  Pricing and validation only read each round's
*shape* — the circuit-pair array, payload bytes, egress fanout, tier and
phase tag — while only execution needs the per-rank :class:`Transfer`
chunk tables.  Builders therefore construct the shape eagerly (as numpy
``(n, 2)`` chip-pair arrays, vectorized) and defer the Transfer tables
behind :meth:`Schedule.materialize`: pricing a candidate schedule
allocates **no per-rank chunk-id lists**, which is what makes pod-scale
planner sweeps cheap (see ``docs/performance.md``).  The module-level
:func:`transfer_tables_built` counter lets the simulator assert that a
churn trace's pricing steady state materialized nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.cost_model import (LinkModel, mixed_radix_factorization,
                                   pipeline_time)
from repro_torch.core.fabric import LumorphRack, peak_pair_multiplicity
from repro_torch.core.rack import Pod, group_by_rack

#: Transfer tables built so far (one count per schedule whose lazy fill
#: actually ran).  ``repro_torch.sim`` snapshots this around a run to report —
#: and test — that pricing materializes nothing.
_TRANSFER_TABLES_BUILT = 0


def transfer_tables_built() -> int:
    """Process-wide count of schedules whose Transfer tables were built."""
    return _TRANSFER_TABLES_BUILT


@dataclasses.dataclass(frozen=True, eq=False)
class Transfer:
    """One ppermute inside a round, with its chunk arithmetic.

    The buffer is viewed as ``Schedule.n_chunks`` equal chunks.  Rank ``i``
    ships the chunks ``send[i]`` to its partner under ``perm`` and applies
    the incoming chunks at ``recv[i]`` — accumulating when ``reduce`` is
    set (reduce-scatter phases), overwriting otherwise (all-gather /
    broadcast phases).  Ranks absent from ``perm``'s destinations receive
    nothing; their ``recv`` rows are placeholders the compiler masks out.
    """

    perm: tuple[tuple[int, int], ...]  # (src_rank, dst_rank), partial permutation
    send: np.ndarray  # int32 (p, k): chunk ids each rank ships
    recv: np.ndarray  # int32 (p, k): chunk ids each rank updates
    reduce: bool = True  # True → add incoming, False → overwrite


class Round:
    """One communication round: simultaneous directed transfers.

    The round's *shape* — ``pairs_arr`` (an ``(n, 2)`` int array of
    ``(src_chip, dst_chip)`` circuits), payload bytes, egress fanout,
    planned ``tier`` and ``reduce`` phase tag — is what the fabric sees:
    the circuit set to program, validate, and price.  The ``transfers``
    (rank space) are what the executable compiler consumes; they exist
    only after :meth:`Schedule.materialize` ran, and their union maps 1:1
    onto the pairs through the schedule's participant list.
    """

    __slots__ = ("pairs_arr", "bytes_per_circuit", "egress_fanout", "tier",
                 "reduce", "_transfers", "_pairs", "_sig")

    def __init__(self, pairs, bytes_per_circuit: float,
                 egress_fanout: int = 1, tier: int = 0,
                 reduce: Optional[bool] = None,
                 transfers: Optional[tuple[Transfer, ...]] = None):
        if isinstance(pairs, np.ndarray):
            arr = pairs
        else:
            arr = np.asarray(list(pairs), dtype=np.int64).reshape(-1, 2)
        #: (n, 2) int array of directed circuits — the canonical storage
        self.pairs_arr = arr
        #: payload each circuit carries this round
        self.bytes_per_circuit = bytes_per_circuit
        #: circuits sharing one chip's egress this round (bandwidth divisor)
        self.egress_fanout = egress_fanout
        #: fabric tier the round was *planned* for: 0 = intra-rack, 1 = the
        #: inter-rack rail stage of a hierarchical composition.  Pricing
        #: does not trust the tag — it re-derives the tier from the pod
        #: geometry — but the tag lets consumers decompose hier programs.
        self.tier = tier
        #: shape-level phase tag: True = reduce-scatter (accumulate),
        #: False = all-gather/broadcast (overwrite), None = untagged.
        #: Mirrors the transfers' ``reduce`` flags without materializing
        #: them — hierarchical composition splits phases on this.
        self.reduce = reduce
        self._transfers = transfers
        self._pairs = None
        self._sig = None

    @property
    def pairs(self) -> tuple[tuple[int, int], ...]:
        """The circuits as a tuple of ``(src_chip, dst_chip)`` pairs
        (compat/introspection view of :attr:`pairs_arr`)."""
        if self._pairs is None:
            self._pairs = tuple(map(tuple, self.pairs_arr.tolist()))
        return self._pairs

    @property
    def transfers(self) -> tuple[Transfer, ...]:
        """Execution lowering: one ppermute per entry (rank space).
        Only available on a materialized schedule."""
        t = self._transfers
        if t is None:
            raise RuntimeError(
                "Transfer tables are lazy: call Schedule.materialize() "
                "before reading Round.transfers (pricing never needs them)")
        return t

    @property
    def circuit_signature(self) -> bytes:
        """Canonical identity of the round's circuit *set* (sorted unique
        pairs) — two rounds reprogram no MZIs iff signatures match."""
        if self._sig is None:
            self._sig = np.unique(self.pairs_arr, axis=0).tobytes()
        return self._sig


@dataclasses.dataclass(frozen=True, eq=False)
class Schedule:
    algo: str
    participants: tuple[int, ...]
    rounds: tuple[Round, ...]
    n_bytes: float  # full ALLREDUCE buffer size
    #: chunk granularity of the executable lowering (buffer padded to a
    #: multiple of this; 1 for whole-buffer algorithms like tree)
    n_chunks: int = 1
    #: lazy Transfer-table builder: returns one tuple of transfers per
    #: round.  ``materialize`` invokes it at most once.
    _fill: Optional[Callable[[], tuple[tuple[Transfer, ...], ...]]] = \
        dataclasses.field(default=None, repr=False)

    # -- lazy transfer tables ------------------------------------------------
    @property
    def materialized(self) -> bool:
        return all(r._transfers is not None for r in self.rounds)

    def materialize(self) -> "Schedule":
        """Build the per-round :class:`Transfer` tables (idempotent).

        Execution (``compile_schedule``) calls this; pricing never does —
        the benchmark and the simulator assert as much through
        :func:`transfer_tables_built`.  Returns ``self`` for chaining.
        """
        global _TRANSFER_TABLES_BUILT
        if self._fill is not None and not self.materialized:
            tables = self._fill()
            if len(tables) != len(self.rounds):
                raise RuntimeError(
                    f"{self.algo}: transfer fill produced {len(tables)} "
                    f"tables for {len(self.rounds)} rounds")
            for rnd, ts in zip(self.rounds, tables):
                rnd._transfers = tuple(ts)
            _TRANSFER_TABLES_BUILT += 1
        else:
            for rnd in self.rounds:
                if rnd._transfers is None:
                    raise RuntimeError(
                        f"{self.algo}: round has no transfer lowering and "
                        "no fill function")
        return self

    # -- pricing -------------------------------------------------------------
    def _changed_flags(self):
        """Yield ``(round, changed)`` where ``changed`` means the round's
        circuit set differs from the previous round's (an MZI window)."""
        prev_arr: Optional[np.ndarray] = None
        prev_sig: bytes = b""
        for r in self.rounds:
            arr = r.pairs_arr
            if prev_arr is not None and arr is prev_arr:
                yield r, False  # same array object → identical circuits
                continue
            sig = r.circuit_signature
            yield r, sig != prev_sig
            prev_arr, prev_sig = arr, sig

    def reconfigurations(self) -> int:
        """Rounds whose circuit set differs from the previous round's."""
        return sum(1 for _, changed in self._changed_flags() if changed)

    def _priced_rounds(self, link: LinkModel,
                       rack: "Optional[LumorphRack | Pod]" = None):
        """Yield ``(tier, seconds)`` per round under the α–β model.

        Per round: α of the governing link (+ its reconfig if the circuit
        set changed) + serialized egress bytes × β.  With a rack, fiber
        shortage stretches the intra-rack β term by ``ceil(demand /
        fibers)``; with a :class:`~repro_torch.core.rack.Pod`, rounds whose
        circuits cross racks are additionally governed by the pod's rail
        link: their α/reconfig come from the rail tier and their β term
        is the *bottleneck* of the intra path and the rail path (rail
        demand time-shares ``rails_per_rack_pair`` the same way fibers
        do).  The tier yielded is derived from the geometry (1 = crosses
        racks), not from the round's tag.  Geometry-derived terms
        (crossing, fiber/rail stretch) are reused across consecutive
        rounds with an unchanged circuit set — e.g. ring's 2(p−1)
        identical rounds are analyzed once.

        With live fabric faults (``rack.health`` truthy — see
        :mod:`repro_torch.core.health`) each pair time-shares its own *healthy*
        budget, the round's β pays the worst derate among its chips, and
        a round whose circuits need a pair with no healthy medium left
        prices ``inf`` (no amount of time-sharing crosses a dark cut).
        A fault-free health object takes the exact legacy path, so
        zero-fault prices are bit-identical to a fabric with no health
        model at all.
        """
        if rack is not None:
            _check_fabric(rack)
        pod = rack if isinstance(rack, Pod) else None
        cpr = pod.chips_per_rack if pod is not None else None
        health = getattr(rack, "health", None) if rack is not None else None
        if health is not None and not health:
            health = None
        geom_arr: Optional[np.ndarray] = None
        crossing = False
        stretch = 1
        rail_stretch = 1
        derate = 1.0
        dead_round = False
        for r, changed in self._changed_flags():
            arr = r.pairs_arr
            # `changed` (the MZI-window flag) compares circuit *sets*, but
            # demand counts multiplicities — reuse the geometry terms only
            # when the pairs match element-for-element
            if geom_arr is None or not (arr is geom_arr
                                        or np.array_equal(arr, geom_arr)):
                geom_arr = arr
                crossing = pod is not None and bool(
                    (arr[:, 0] // cpr != arr[:, 1] // cpr).any())
                stretch = 1
                dead_round = False
                if rack is not None:
                    if health is None:
                        demand = _round_fiber_demand(arr, rack.tiles_per_server,
                                                     chips_per_rack=cpr)
                        if demand > rack.fibers_per_server_pair:
                            stretch = -(-demand // rack.fibers_per_server_pair)
                    else:
                        stretch, dead_round = _degraded_fiber_stretch(
                            arr, rack, health, cpr)
                rail_stretch = 1
                if crossing:
                    if health is None:
                        demand = _round_rail_demand(arr, cpr)
                        if demand > pod.rails_per_rack_pair:
                            rail_stretch = -(-demand // pod.rails_per_rack_pair)
                    else:
                        rail_stretch, rail_dead = _degraded_rail_stretch(
                            arr, pod, health)
                        dead_round = dead_round or rail_dead
                derate = (health.worst_derate(int(c) for c in np.unique(arr))
                          if health is not None else 1.0)
            if dead_round:
                yield (1 if crossing else 0), float("inf")
                continue
            rail = pod.rail_link if crossing else None
            governing = rail if crossing else link
            seconds = governing.round_alpha(changed)
            beta_s = r.bytes_per_circuit * r.egress_fanout * link.beta * stretch
            if crossing:
                beta_s = max(beta_s, r.bytes_per_circuit * r.egress_fanout
                             * rail.beta * rail_stretch)
            if derate != 1.0:
                beta_s *= derate
            yield (1 if crossing else 0), seconds + beta_s

    def cost(self, link: LinkModel,
             rack: "Optional[LumorphRack | Pod]" = None) -> float:
        """Total α–β time of the program (see :meth:`_priced_rounds`).

        Placement quality (:func:`order_for_locality`) and — on a pod —
        rack spanning show up directly in this price: fiber and rail
        shortages are charged as β time-sharing, and any round that
        crosses racks runs at the rail tier's slower link parameters.
        MZIs for all sub-batches are programmed in one window, so α is
        never stretched.  Pricing reads only the schedule's shape — no
        Transfer tables are materialized.
        """
        return sum(s for _, s in self._priced_rounds(link, rack))

    def cost_by_tier(self, link: LinkModel,
                     rack: "Optional[LumorphRack | Pod]" = None) -> dict[int, float]:
        """Decompose :meth:`cost` into per-tier totals (0 = intra-rack
        rounds, 1 = rounds crossing racks).  ``sum(result.values())``
        equals :meth:`cost` — the pod property tests pin this so pricing
        and its decomposition cannot drift apart."""
        out: dict[int, float] = {}
        for tier, s in self._priced_rounds(link, rack):
            out[tier] = out.get(tier, 0.0) + s
        return out

    def validate(self, rack: "LumorphRack | Pod",
                 check_fibers: bool = True) -> None:
        """Check every round against the fabric's photonic limits (a rack
        or a pod — pods additionally enforce the rail budget when
        ``check_fibers`` is on).

        ``check_fibers=False`` skips the shared-medium budgets (fibers,
        and rails on a pod) — used by callers that model shortage as
        time-sharing (see :meth:`cost` with ``rack``) instead of
        infeasibility.
        """
        _check_fabric(rack)
        for i, r in enumerate(self.rounds):
            try:
                rack.validate_round(r.pairs_arr, check_fibers=check_fibers)
            except Exception as e:  # re-raise with round context
                raise type(e)(f"round {i}: {e}") from e


def _check_fabric(rack) -> None:
    if not isinstance(rack, (LumorphRack, Pod)):
        raise TypeError(f"prices and validates on a LumorphRack or a Pod (or rack=None, "
                        f"the ideal fabric), not {type(rack).__name__}")


def _round_fiber_demand(pairs, tiles_per_server: int,
                        chips_per_rack: Optional[int] = None) -> int:
    """Peak circuits any one server pair must carry for this round.

    With ``chips_per_rack``, circuits that cross racks are excluded —
    they ride the pod's rails (see :func:`_round_rail_demand`), not the
    intra-rack server-pair fibers.
    """
    arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if chips_per_rack is not None:
        arr = arr[arr[:, 0] // chips_per_rack == arr[:, 1] // chips_per_rack]
    srv = arr // tiles_per_server
    srv = srv[srv[:, 0] != srv[:, 1]]
    return peak_pair_multiplicity(srv[:, 0], srv[:, 1])


def _round_rail_demand(pairs, chips_per_rack: int) -> int:
    """Peak circuits any one *rack* pair must carry for this round."""
    arr = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    rk = arr // chips_per_rack
    rk = rk[rk[:, 0] != rk[:, 1]]
    return peak_pair_multiplicity(rk[:, 0], rk[:, 1])


def _pair_demands(ab: np.ndarray) -> dict[tuple[int, int], int]:
    """Unordered-pair circuit counts of one round — the per-pair form of
    ``peak_pair_multiplicity``, for budgets that differ per pair (a
    faulted fabric)."""
    if ab.size == 0:
        return {}
    lo = np.minimum(ab[:, 0], ab[:, 1])
    hi = np.maximum(ab[:, 0], ab[:, 1])
    base = int(hi.max()) + 1
    uniq, counts = np.unique(lo * base + hi, return_counts=True)
    return {(int(k // base), int(k % base)): int(c)
            for k, c in zip(uniq.tolist(), counts.tolist())}


def _degraded_fiber_stretch(arr: np.ndarray, rack, health,
                            chips_per_rack: Optional[int]) -> tuple[int, bool]:
    """``(stretch, dead)`` for one round on a faulted fabric: every
    server pair serializes over its own healthy fiber budget; a pair
    with demand but no healthy fiber makes the round inadmissible."""
    a = arr
    if chips_per_rack is not None:
        a = a[a[:, 0] // chips_per_rack == a[:, 1] // chips_per_rack]
    srv = a // rack.tiles_per_server
    srv = srv[srv[:, 0] != srv[:, 1]]
    stretch = 1
    for pair, demand in _pair_demands(srv).items():
        budget = rack.fibers_per_server_pair - health.fibers_lost(pair)
        if budget <= 0:
            return 1, True
        stretch = max(stretch, -(-demand // budget))
    return stretch, False


def _degraded_rail_stretch(arr: np.ndarray, pod, health) -> tuple[int, bool]:
    """Rail analogue of :func:`_degraded_fiber_stretch` (pod tier)."""
    rk = arr // pod.chips_per_rack
    rk = rk[rk[:, 0] != rk[:, 1]]
    stretch = 1
    for pair, demand in _pair_demands(rk).items():
        budget = pod.rails_per_rack_pair - health.rails_lost(pair)
        if budget <= 0:
            return 1, True
        stretch = max(stretch, -(-demand // budget))
    return stretch, False


# ---------------------------------------------------------------------------
# Schedule builders
# ---------------------------------------------------------------------------

def ring_schedule(chips: Sequence[int], n_bytes: float) -> Schedule:
    """Ring ALLREDUCE: 2(p−1) rounds, each chip ships n/p to its successor.

    Chunk map (n_chunks = p): reduce-scatter round ``t`` sends chunk
    ``(i−t) mod p`` and accumulates into ``(i−t−1) mod p``; the all-gather
    mirrors with overwrites.  The ring circuit set never changes (all
    rounds share one pairs array).
    """
    chips = tuple(chips)
    p = len(chips)
    rounds: list[Round] = []
    fill = None
    if p > 1:
        arr = np.asarray(chips, dtype=np.int64)
        ring_pairs = np.stack([arr, np.roll(arr, -1)], axis=1)
        chunk = n_bytes / p
        for _ in range(p - 1):  # reduce-scatter
            rounds.append(Round(ring_pairs, chunk, reduce=True))
        for _ in range(p - 1):  # all-gather
            rounds.append(Round(ring_pairs, chunk, reduce=False))

        def fill():
            perm = tuple((i, (i + 1) % p) for i in range(p))
            ranks = np.arange(p, dtype=np.int32)
            tables = []
            for t in range(p - 1):  # reduce-scatter
                tables.append((Transfer(perm=perm,
                                        send=((ranks - t) % p)[:, None],
                                        recv=((ranks - t - 1) % p)[:, None],
                                        reduce=True),))
            for t in range(p - 1):  # all-gather
                tables.append((Transfer(perm=perm,
                                        send=((ranks + 1 - t) % p)[:, None],
                                        recv=((ranks - t) % p)[:, None],
                                        reduce=False),))
            return tuple(tables)

    return Schedule("ring", chips, tuple(rounds), n_bytes,
                    n_chunks=max(p, 1), _fill=fill)


def _chunk_range(start: int, size: int) -> np.ndarray:
    return np.arange(start, start + size, dtype=np.int32)


def rhd_schedule(chips: Sequence[int], n_bytes: float) -> Schedule:
    """LUMORPH-2: recursive halving reduce-scatter + doubling all-gather.

    Chunk map (n_chunks = p): every rank tracks a live contiguous chunk
    region, initially the whole buffer.  A halving round at XOR distance
    ``d`` splits the region; the rank keeps the half selected by its bit
    at ``d``, ships the other half, and accumulates the partner's copy of
    the kept half.  Doubling mirrors: ship the own region, adopt the
    sibling's.
    """
    chips = tuple(chips)
    p = len(chips)
    if p & (p - 1):
        return ring_schedule(chips, n_bytes)  # paper §3 fallback
    rounds: list[Round] = []
    steps = int(math.log2(p)) if p > 1 else 0
    arr = np.asarray(chips, dtype=np.int64)
    idx = np.arange(p)
    chunk = n_bytes / 2
    dist = p // 2
    for _ in range(steps):  # halving
        rounds.append(Round(np.stack([arr, arr[idx ^ dist]], axis=1),
                            chunk, reduce=True))
        chunk /= 2
        dist //= 2
    chunk = n_bytes / p
    dist = 1
    for _ in range(steps):  # doubling
        rounds.append(Round(np.stack([arr, arr[idx ^ dist]], axis=1),
                            chunk, reduce=False))
        chunk *= 2
        dist *= 2

    def fill():
        tables = []
        regions = [(0, p)] * p  # (start chunk, size) per rank
        d = p // 2
        for _ in range(steps):  # halving
            perm = tuple((i, i ^ d) for i in range(p))
            send = np.empty((p, regions[0][1] // 2), dtype=np.int32)
            recv = np.empty_like(send)
            for i in range(p):
                start, size = regions[i]
                half = size // 2
                if (i // d) % 2 == 0:  # keep low half, ship high half
                    keep, ship = (start, half), (start + half, half)
                else:
                    keep, ship = (start + half, half), (start, half)
                send[i] = _chunk_range(*ship)
                recv[i] = _chunk_range(*keep)
                regions[i] = keep
            tables.append((Transfer(perm, send, recv, reduce=True),))
            d //= 2
        d = 1
        for _ in range(steps):  # doubling
            perm = tuple((i, i ^ d) for i in range(p))
            send = np.empty((p, regions[0][1]), dtype=np.int32)
            recv = np.empty_like(send)
            for i in range(p):
                send[i] = _chunk_range(*regions[i])
                recv[i] = _chunk_range(*regions[i ^ d])
            for i in range(p):  # merge sibling regions
                start, size = regions[i]
                sib_start, _ = regions[i ^ d]
                regions[i] = (min(start, sib_start), size * 2)
            tables.append((Transfer(perm, send, recv, reduce=False),))
            d *= 2
        return tuple(tables)

    return Schedule("lumorph2", chips, tuple(rounds), n_bytes,
                    n_chunks=max(p, 1), _fill=fill if steps else None)


def _rqq_round_pairs(arr: np.ndarray, idx: np.ndarray, r: int,
                     stride: int) -> np.ndarray:
    """Circuit pairs of one radix-``r`` round: per digit offset, every
    chip pairs with the member of its digit group ``off`` digits away
    (blocks concatenated in offset order — the builder's round layout)."""
    digit = (idx // stride) % r
    blocks = []
    for off in range(1, r):
        j = idx + (((digit + off) % r) - digit) * stride
        blocks.append(np.stack([arr, arr[j]], axis=1))
    return np.concatenate(blocks, axis=0)


def rqq_schedule(chips: Sequence[int], n_bytes: float, radix: int = 4) -> Schedule:
    """LUMORPH-4: radix-r quartering/quadrupling with (r−1) circuits/chip/round.

    Mixed-radix generalization handles any p that factors into ≤radix terms.
    Digit groups follow the mixed-radix factorization of p; in a radix-r
    round every chip exchanges distinct sub-chunks with the r−1 other chips
    in its digit group (egress bandwidth split r−1 ways).  Each round
    lowers to r−1 transfers — one ppermute per digit offset.
    """
    chips = tuple(chips)
    p = len(chips)
    radices = mixed_radix_factorization(p, radix) if p > 1 else []
    arr = np.asarray(chips, dtype=np.int64)
    idx = np.arange(p)
    rounds: list[Round] = []
    group = 1  # how many ways the buffer is already scattered
    strides: list[tuple[int, int]] = []  # (radix, stride) per phase
    stride = 1
    for r in radices:  # ---- reduce-scatter ----
        chunk = n_bytes / group  # bytes currently owned by each chip
        rounds.append(Round(_rqq_round_pairs(arr, idx, r, stride),
                            chunk / r, egress_fanout=r - 1, reduce=True))
        strides.append((r, stride))
        stride *= r
        group *= r
    for r, st in reversed(strides):  # ---- all-gather (mirror) ----
        group //= r
        chunk = n_bytes / group
        rounds.append(Round(_rqq_round_pairs(arr, idx, r, st),
                            chunk / r, egress_fanout=r - 1, reduce=False))

    def fill():
        tables = []
        regions = [(0, p)] * p
        for r, stride in strides:  # reduce-scatter
            xfers = []
            sub = regions[0][1] // r
            for off in range(1, r):
                perm = []
                send = np.empty((p, sub), dtype=np.int32)
                recv = np.empty_like(send)
                for i in range(p):
                    digit = (i // stride) % r
                    j = i + ((digit + off) % r - digit) * stride
                    perm.append((i, j))
                    start, _ = regions[i]
                    # ship the partner's digit block, accumulate into own
                    send[i] = _chunk_range(start + ((digit + off) % r) * sub, sub)
                    recv[i] = _chunk_range(start + digit * sub, sub)
                xfers.append(Transfer(tuple(perm), send, recv, reduce=True))
            for i in range(p):
                start, _ = regions[i]
                digit = (i // stride) % r
                regions[i] = (start + digit * sub, sub)
            tables.append(tuple(xfers))
        for r, st in reversed(strides):  # all-gather (mirror)
            sub = regions[0][1]
            xfers = []
            for off in range(1, r):
                perm = []
                send = np.empty((p, sub), dtype=np.int32)
                recv = np.empty_like(send)
                for i in range(p):
                    digit = (i // st) % r
                    j = i + ((digit + off) % r - digit) * st
                    perm.append((i, j))
                    start, _ = regions[i]
                    parent = start - digit * sub
                    send[i] = _chunk_range(start, sub)
                    # the arriving block was digit (digit−off) of the parent
                    recv[i] = _chunk_range(parent + ((digit - off) % r) * sub, sub)
                xfers.append(Transfer(tuple(perm), send, recv, reduce=False))
            for i in range(p):
                start, _ = regions[i]
                digit = (i // st) % r
                regions[i] = (start - digit * sub, sub * r)
            tables.append(tuple(xfers))
        return tuple(tables)

    return Schedule(f"lumorph{radix}", chips, tuple(rounds), n_bytes,
                    n_chunks=max(p, 1), _fill=fill if radices else None)


def tree_schedule(chips: Sequence[int], n_bytes: float) -> Schedule:
    """Binomial-tree reduce to rank 0 + broadcast back: 2·⌈log2 p⌉ rounds.

    The fixed-topology baseline of torus/SiPAC disciplines (full buffer per
    hop, n_chunks = 1).  On a reconfigurable fabric every round's circuit
    set differs from the previous one, so each round pays the MZI window —
    the closed form in ``cost_model.tree_all_reduce_cost`` mirrors this.
    Works for any p (ranks ≥ p simply never appear in a perm).
    """
    chips = tuple(chips)
    p = len(chips)
    rounds: list[Round] = []
    fill = None
    if p > 1:
        arr = np.asarray(chips, dtype=np.int64)
        steps = math.ceil(math.log2(p))
        levels = []
        for k in range(steps):
            senders = np.asarray([i for i in range(p)
                                  if i % (1 << (k + 1)) == (1 << k)])
            levels.append((k, senders))
        for k, senders in levels:  # reduce toward rank 0
            rounds.append(Round(
                np.stack([arr[senders], arr[senders - (1 << k)]], axis=1),
                n_bytes, reduce=True))
        for k, senders in reversed(levels):  # broadcast back
            rounds.append(Round(
                np.stack([arr[senders - (1 << k)], arr[senders]], axis=1),
                n_bytes, reduce=False))

        def fill():
            zeros = np.zeros((p, 1), dtype=np.int32)
            tables = []
            for k, senders in levels:
                perm = tuple((int(i), int(i) - (1 << k)) for i in senders)
                tables.append((Transfer(perm, zeros, zeros, reduce=True),))
            for k, senders in reversed(levels):
                perm = tuple((int(i) - (1 << k), int(i)) for i in senders)
                tables.append((Transfer(perm, zeros, zeros, reduce=False),))
            return tuple(tables)

    return Schedule("tree", chips, tuple(rounds), n_bytes, n_chunks=1,
                    _fill=fill)


def transfer_schedule(move_rounds: Sequence[Sequence[tuple[int, int]]],
                      bytes_per_move: float, tag: str = "transfer") -> Schedule:
    """Point-to-point state movement as a first-class Schedule.

    ``move_rounds`` is a list of waves; each wave is a set of simultaneous
    directed ``(src_chip, dst_chip)`` copies of ``bytes_per_move`` bytes
    (whole-buffer, ``n_chunks=1``, overwrite semantics — a state *replay*,
    not a reduction).  Used by ``repro_torch.morph`` to ship a chip's shard
    state during compaction and failure bypass; because the result is an
    ordinary :class:`Schedule`, the moves are priced by :meth:`Schedule.cost`
    (MZI window per wave + bytes × β with fiber time-sharing) and checked
    by :meth:`Schedule.validate` like any collective.
    """
    chips: list[int] = []
    for wave in move_rounds:
        for s, d in wave:
            if s == d:
                raise ValueError(f"state move {s}→{d} is a no-op loopback")
            for c in (s, d):
                if c not in chips:
                    chips.append(c)
    rank = {c: i for i, c in enumerate(chips)}
    p = len(chips)
    rounds = []
    perms = []
    for wave in move_rounds:
        if not wave:
            continue
        fanout: dict[int, int] = {}
        for s, _ in wave:
            fanout[s] = fanout.get(s, 0) + 1
        perms.append(tuple((rank[s], rank[d]) for s, d in wave))
        rounds.append(Round(np.asarray(list(wave), dtype=np.int64),
                            bytes_per_move, egress_fanout=max(fanout.values()),
                            reduce=False))

    def fill():
        zeros = np.zeros((max(p, 1), 1), dtype=np.int32)
        return tuple((Transfer(perm, zeros, zeros, reduce=False),)
                     for perm in perms)

    return Schedule(tag, tuple(chips), tuple(rounds),
                    n_bytes=bytes_per_move, n_chunks=1,
                    _fill=fill if rounds else None)


# ---------------------------------------------------------------------------
# chunked / pipelined lowering (PCCL-style overlap)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Wave:
    """One overlappable unit of a :class:`ChunkedSchedule`.

    A wave is a dependency-closed run of same-phase rounds operating on one
    ``1/C`` slice of the payload: chunk ``chunk``'s reduce-scatter prefix
    (``phase == "rs"``) or its all-gather suffix (``phase == "ag"``).  The
    wave's ``schedule`` is an ordinary :class:`Schedule` over the slice —
    ``compile_schedule`` lowers it, :meth:`Schedule.validate` checks it
    against a fabric — and is shared between chunks (every chunk runs the
    same program on its own slice).  Dependencies: a chunk's ``ag`` wave
    needs its ``rs`` wave; waves of different chunks are independent, which
    is exactly what lets wave ``k``'s ppermutes hide behind chunk
    ``k−1``'s compute.
    """

    chunk: int
    phase: str  # "rs" (reduce-scatter, accumulate) | "ag" (all-gather)
    schedule: Schedule


class ChunkedSchedule:
    """A :class:`Schedule` lowered onto ``n_chunks`` payload slices.

    The base program's rounds are split at the reduce-scatter/all-gather
    phase boundary (the shape-level ``Round.reduce`` tags) and re-emitted
    once per payload chunk at ``n_bytes / C`` — ``2·C`` waves (``C`` when a
    phase is empty, e.g. ``transfer_schedule``'s pure-overwrite programs)
    whose serial concatenation is provably equivalent to the base program
    (``tests/test_overlap.py``).  Pricing walks that serial concatenation
    with the ordinary :meth:`Schedule._priced_rounds` machinery, so MZI
    windows are only charged where a chunk boundary actually changes the
    circuit set (ring's never does; LUMORPH-2's boundary reuses the
    distance-``p/2`` circuits of the previous chunk's last round), and no
    Transfer tables are materialized.  Execution (``repro_torch.core.collectives
    .overlapped_all_reduce``) compiles the shared per-phase wave schedules
    once and double-buffers chunks against a compute stream.
    """

    def __init__(self, base: Schedule, n_chunks: int):
        if n_chunks < 1:
            raise ValueError(f"n_chunks must be ≥ 1, got {n_chunks}")
        self.base = base
        self.n_chunks = n_chunks
        rs_rounds, ag_rounds = _split_phases(base)

        def scaled(rounds, fill_rounds):
            scale = 1.0 / n_chunks
            new = tuple(Round(r.pairs_arr, r.bytes_per_circuit * scale,
                              egress_fanout=r.egress_fanout, tier=r.tier,
                              reduce=r.reduce) for r in rounds)

            def fill():
                # the chunk tables of a 1/C slice ARE the base tables: the
                # slice is a full buffer of n/C bytes with the same chunk
                # granularity, so materialize the base once and share
                base.materialize()
                return tuple(r.transfers for r in fill_rounds)

            return Schedule(base.algo, base.participants, new,
                            base.n_bytes / n_chunks, n_chunks=base.n_chunks,
                            _fill=fill if new else None)

        self._rs = scaled(rs_rounds, rs_rounds) if rs_rounds else None
        self._ag = scaled(ag_rounds, ag_rounds) if ag_rounds else None
        waves: list[Wave] = []
        for c in range(n_chunks):
            if self._rs is not None:
                waves.append(Wave(c, "rs", self._rs))
            if self._ag is not None:
                waves.append(Wave(c, "ag", self._ag))
        self.waves: tuple[Wave, ...] = tuple(waves)
        #: the serial program: every chunk's waves back to back, priced as
        #: one ordinary Schedule (rounds are shared objects, so pricing's
        #: geometry reuse sees through the repetition)
        serial_rounds = tuple(r for w in self.waves for r in w.schedule.rounds)
        self._serial = Schedule(f"{base.algo}|chunks={n_chunks}",
                                base.participants, serial_rounds,
                                base.n_bytes, n_chunks=base.n_chunks)

    # -- structure -----------------------------------------------------------
    @property
    def algo(self) -> str:
        return self._serial.algo

    @property
    def participants(self) -> tuple[int, ...]:
        return self.base.participants

    def waves_of_chunk(self, chunk: int) -> tuple[Wave, ...]:
        return tuple(w for w in self.waves if w.chunk == chunk)

    # -- pricing -------------------------------------------------------------
    def wave_costs(self, link: LinkModel,
                   rack: "Optional[LumorphRack | Pod]" = None) -> list[float]:
        """Per-wave α–β time, attributed by walking the *serial* program —
        so ``sum(wave_costs()) == cost()`` exactly, and a wave whose first
        round reuses the previous wave's circuits pays no MZI window."""
        priced = iter(self._serial._priced_rounds(link, rack))
        out = []
        for w in self.waves:
            out.append(sum(next(priced)[1] for _ in w.schedule.rounds))
        return out

    def chunk_costs(self, link: LinkModel,
                    rack: "Optional[LumorphRack | Pod]" = None) -> list[float]:
        """Per-chunk wire time (each chunk's rs + ag waves summed)."""
        per_chunk = [0.0] * self.n_chunks
        for w, s in zip(self.waves, self.wave_costs(link, rack)):
            per_chunk[w.chunk] += s
        return per_chunk

    def cost(self, link: LinkModel,
             rack: "Optional[LumorphRack | Pod]" = None) -> float:
        """Serial (overlap-disabled) α–β time of the chunked program.  With
        ``n_chunks == 1`` this equals the base schedule's cost bit-for-bit;
        more chunks add α/MZI rounds but never β bytes."""
        return self._serial.cost(link, rack)

    def overlapped_cost(self, link: LinkModel,
                        rack: "Optional[LumorphRack | Pod]" = None,
                        compute_s: float = 0.0) -> float:
        """Pipelined makespan: chunk collectives serialized on the fabric,
        ``compute_s`` of compute split across chunks and double-buffered
        (``cost_model.pipeline_time``) — the price the overlap claim is
        gated on."""
        return pipeline_time(self.chunk_costs(link, rack), compute_s)

    # -- validation ----------------------------------------------------------
    def validate(self, rack: "LumorphRack | Pod",
                 check_fibers: bool = True) -> None:
        """Every wave must satisfy the fabric's photonic limits (waves run
        one at a time on the wire, so per-wave feasibility is the right
        granularity — identical to the base program's rounds)."""
        _check_fabric(rack)
        for w in (self._rs, self._ag):
            if w is not None:
                w.validate(rack, check_fibers=check_fibers)


def chunk_schedule(schedule: Schedule, n_chunks: int) -> ChunkedSchedule:
    """Lower ``schedule`` into ``n_chunks`` overlappable waves (see
    :class:`ChunkedSchedule`).  Shape-only: no Transfer tables are built —
    planning and pricing a chunked program stays as lazy as the base IR."""
    return ChunkedSchedule(schedule, n_chunks)


# ---------------------------------------------------------------------------
# hierarchical (pod-tier) composition
# ---------------------------------------------------------------------------

def _split_phases(sched: Schedule) -> tuple[list[Round], list[Round]]:
    """Split an ALLREDUCE schedule into its reduce-scatter prefix and
    all-gather suffix using the rounds' shape-level phase tags.  Every
    builder in this module emits that shape; anything else (interleaved
    phases, untagged rounds) cannot anchor a hierarchical composition and
    raises."""
    rs: list[Round] = []
    ag: list[Round] = []
    for r in sched.rounds:
        if r.reduce is None:
            raise ValueError(
                f"{sched.algo}: round without a phase-tagged lowering "
                "cannot be composed")
        if r.reduce:
            if ag:
                raise ValueError(f"{sched.algo}: reduce round after all-gather began")
            rs.append(r)
        else:
            ag.append(r)
    return rs, ag


def _expand_chunks(ids: np.ndarray, factor: int) -> np.ndarray:
    """Re-index chunk tables from granularity ``k`` to ``k·factor``: chunk
    ``c`` becomes the sub-chunks ``c·factor .. c·factor+factor−1``."""
    out = ids.astype(np.int64)[:, :, None] * factor + np.arange(factor)
    return out.reshape(ids.shape[0], -1).astype(np.int32)


def _merge_rack_shapes(rounds_by_rack: Sequence[Round]) -> Round:
    """One pod-wide round shape from structurally identical per-rack
    rounds: all racks run their local round simultaneously (pair arrays
    concatenate in rack order)."""
    r0 = rounds_by_rack[0]
    return Round(np.concatenate([r.pairs_arr for r in rounds_by_rack], axis=0),
                 r0.bytes_per_circuit, egress_fanout=r0.egress_fanout,
                 reduce=r0.reduce)


def _merge_rack_transfers(rounds_by_rack: Sequence[Round], m: int,
                          factor: int) -> tuple[Transfer, ...]:
    """Merged transfer tables of one pod-wide round: rank spaces
    concatenate (rack ``r``'s local rank ``i`` → global rank ``r·m + i``)
    and chunk ids expand to the composed schedule's finer granularity."""
    r0 = rounds_by_rack[0]
    if any(len(r.transfers) != len(r0.transfers) for r in rounds_by_rack):
        raise ValueError("per-rack rounds disagree on transfer structure")
    transfers = []
    for u in range(len(r0.transfers)):
        perm = tuple((r * m + s, r * m + d)
                     for r, rnd in enumerate(rounds_by_rack)
                     for s, d in rnd.transfers[u].perm)
        send = np.vstack([_expand_chunks(rnd.transfers[u].send, factor)
                          for rnd in rounds_by_rack])
        recv = np.vstack([_expand_chunks(rnd.transfers[u].recv, factor)
                          for rnd in rounds_by_rack])
        transfers.append(Transfer(perm, send, recv, r0.transfers[u].reduce))
    return tuple(transfers)


def compose_hierarchical(intra: Sequence[Schedule],
                         inter: str = "ring") -> Schedule:
    """Stitch per-rack Schedules into one pod-wide ALLREDUCE program.

    ``intra`` holds one schedule per rack — all built by the *same*
    builder over the *same* participant count ``m`` on disjoint chips, so
    after their reduce-scatter prefix, corresponding local ranks own the
    same chunk region (the symmetry the inter stage relies on; it is
    asserted at materialization, not assumed).  The composed program is:

      1. every rack runs its reduce-scatter rounds simultaneously
         (merged rank spaces, chunk ids refined ``R``-fold);
      2. an **inter-rack stage** (``inter="ring"``): each of the ``m``
         shard-owner groups — local rank ``i`` of every rack — ring
         reduce-scatters then all-gathers its owned region across the
         ``R`` racks in ``2(R−1)`` rounds of ``n/(m·R)``-byte sub-chunks,
         all groups in parallel (``m`` circuits per rack pair per round,
         tagged ``tier=1`` and priced at the rail link);
      3. every rack runs its all-gather rounds simultaneously.

    The result is an ordinary :class:`Schedule`: `compile_schedule` can
    execute it, :meth:`Schedule.cost` prices it per tier against a
    :class:`~repro_torch.core.rack.Pod` — from the shape alone, without ever
    materializing the per-rack Transfer tables — and the simulator treats
    it like any other candidate algorithm.
    """
    intra = tuple(intra)
    if not intra:
        raise ValueError("compose_hierarchical needs ≥ 1 per-rack schedule")
    if len(intra) == 1:
        return intra[0]
    if inter != "ring":
        raise ValueError(f"unsupported inter-rack stage {inter!r}; have ['ring']")
    first = intra[0]
    m = len(first.participants)
    for s in intra[1:]:
        if (s.algo != first.algo or len(s.participants) != m
                or s.n_bytes != first.n_bytes or s.n_chunks != first.n_chunks):
            raise ValueError(
                "hierarchical composition needs structurally identical "
                "per-rack schedules (same algorithm, width, bytes)")
    if m > 1 and first.n_chunks != m:
        raise ValueError(
            f"intra algorithm {first.algo!r} does not scatter the buffer "
            f"(n_chunks={first.n_chunks}); use ring/lumorph2/lumorph4")
    chips = tuple(c for s in intra for c in s.participants)
    if len(set(chips)) != len(chips):
        raise ValueError("per-rack schedules share chips")
    R = len(intra)
    K = first.n_chunks * R
    splits = [_split_phases(s) for s in intra]
    if (len({len(rs) for rs, _ in splits}) != 1
            or len({len(ag) for _, ag in splits}) != 1):
        raise ValueError("per-rack schedules disagree on phase structure")
    n_rs, n_ag = len(splits[0][0]), len(splits[0][1])
    rounds: list[Round] = []
    for j in range(n_rs):  # simultaneous per-rack reduce-scatter
        rounds.append(_merge_rack_shapes([splits[r][0][j] for r in range(R)]))
    # after its rack's reduce-scatter each local rank owns exactly one
    # intra chunk (n_chunks == m is enforced above; m == 1 owns its single
    # chunk trivially) — asserted against the tables at materialization
    w = 1
    perm = tuple((r * m + i, ((r + 1) % R) * m + i)
                 for r in range(R) for i in range(m))
    inter_pairs = np.asarray(chips, dtype=np.int64)[
        np.asarray(perm, dtype=np.int64).reshape(-1, 2)]
    sub_bytes = first.n_bytes / K
    for _ in range(R - 1):  # inter reduce-scatter (ring over racks)
        rounds.append(Round(inter_pairs, w * sub_bytes, tier=1, reduce=True))
    for _ in range(R - 1):  # inter all-gather (mirror; same circuits)
        rounds.append(Round(inter_pairs, w * sub_bytes, tier=1, reduce=False))
    for j in range(n_ag):  # simultaneous per-rack all-gather
        rounds.append(_merge_rack_shapes([splits[r][1][j] for r in range(R)]))

    def fill():
        for s in intra:
            s.materialize()
        tables: list[tuple[Transfer, ...]] = []
        for j in range(n_rs):
            tables.append(_merge_rack_transfers(
                [splits[r][0][j] for r in range(R)], m, R))
        # chunk region each local rank owns after its rack's reduce-scatter:
        # the last reduce round's recv row (what the rank accumulated last)
        # — identical across racks by builder symmetry, asserted here
        if splits[0][0]:
            own = np.asarray(splits[0][0][-1].transfers[0].recv, dtype=np.int64)
            for rs, _ in splits[1:]:
                if not np.array_equal(rs[-1].transfers[0].recv, own):
                    raise ValueError("per-rack reduce-scatters own different regions")
        else:  # m == 1: the single local rank owns the whole (1-chunk) buffer
            own = np.zeros((m, 1), dtype=np.int64)
        assert own.shape[1] == w, "composed inter stage assumes 1-chunk regions"
        for t in range(R - 1):  # inter reduce-scatter
            send = np.vstack([own * R + (r - t) % R
                              for r in range(R)]).astype(np.int32)
            recv = np.vstack([own * R + (r - t - 1) % R
                              for r in range(R)]).astype(np.int32)
            tables.append((Transfer(perm, send, recv, reduce=True),))
        for t in range(R - 1):  # inter all-gather
            send = np.vstack([own * R + (r + 1 - t) % R
                              for r in range(R)]).astype(np.int32)
            recv = np.vstack([own * R + (r - t) % R
                              for r in range(R)]).astype(np.int32)
            tables.append((Transfer(perm, send, recv, reduce=False),))
        for j in range(n_ag):
            tables.append(_merge_rack_transfers(
                [splits[r][1][j] for r in range(R)], m, R))
        return tuple(tables)

    return Schedule(f"hier:{first.algo}:{inter}", chips, tuple(rounds),
                    first.n_bytes, n_chunks=K, _fill=fill)


def hierarchical_schedule(chips: Sequence[int], n_bytes: float,
                          chips_per_rack: int, intra: str = "lumorph4",
                          inter: str = "ring") -> Schedule:
    """Build a hierarchical ALLREDUCE over chips spanning racks: group the
    chips by rack (order preserved — feed locality-ordered chips), build
    the ``intra`` algorithm per rack, and compose with the ``inter``
    stage.  Racks must hold equal shares (the shard-alignment condition);
    a single-rack chip set degenerates to the flat ``intra`` schedule.
    """
    groups = group_by_rack(chips, chips_per_rack)
    if len({len(g) for g in groups.values()}) != 1:
        raise ValueError(
            f"hierarchical schedule needs equal per-rack shares, got "
            f"{sorted((r, len(g)) for r, g in groups.items())}")
    if len(groups) == 1:
        return build_schedule(intra, tuple(chips), n_bytes)
    return compose_hierarchical(
        [build_schedule(intra, tuple(g), n_bytes) for g in groups.values()],
        inter)


SCHEDULE_BUILDERS = {
    "ring": ring_schedule,
    "lumorph2": rhd_schedule,
    "lumorph4": rqq_schedule,
    "tree": tree_schedule,
}


def build_schedule(algo: str, chips: Sequence[int], n_bytes: float) -> Schedule:
    try:
        builder = SCHEDULE_BUILDERS[algo]
    except KeyError:
        raise ValueError(f"no schedule builder for {algo!r}; have {sorted(SCHEDULE_BUILDERS)}")
    return builder(chips, n_bytes)


def build_any_schedule(algo: str, chips: Sequence[int], n_bytes: float,
                       chips_per_rack: Optional[int] = None) -> Schedule:
    """:func:`build_schedule` extended with the pod tier's virtual
    algorithms: ``"hier:<intra>"`` builds :func:`hierarchical_schedule`
    with ``<intra>`` inside each rack and the ring inter-rack stage."""
    if algo.startswith("hier:"):
        if chips_per_rack is None:
            raise ValueError(f"{algo!r} needs chips_per_rack (pod geometry)")
        return hierarchical_schedule(chips, n_bytes, chips_per_rack,
                                     intra=algo.split(":", 1)[1])
    return build_schedule(algo, chips, n_bytes)


def candidate_algos(algos: Sequence[str], chips: Sequence[int],
                    chips_per_rack: Optional[int] = None) -> tuple[str, ...]:
    """The algorithms admissible on this concrete chip set: the flat ones
    as given, plus one ``"hier:<intra>"`` candidate per flat algorithm
    when the chips span ≥ 2 racks in equal shares (the shard-alignment
    condition of :func:`compose_hierarchical`; ``tree`` cannot anchor a
    composition and gets no hierarchical variant)."""
    cands = tuple(algos)
    if chips_per_rack is None:
        return cands
    groups = group_by_rack(chips, chips_per_rack)
    if len(groups) >= 2 and len({len(g) for g in groups.values()}) == 1:
        cands += tuple(f"hier:{a}" for a in algos if a != "tree")
    return cands


# ---------------------------------------------------------------------------
# fiber-aware placement
# ---------------------------------------------------------------------------

def fiber_demand(schedule: Schedule, tiles_per_server: int,
                 chips_per_rack: Optional[int] = None,
                 health=None) -> int:
    """Peak per-server-pair fiber demand across the schedule's rounds
    (cross-rack circuits excluded when ``chips_per_rack`` is given).

    With a faulted ``health`` (:class:`repro_torch.core.health.FabricHealth`),
    each pair's demand is inflated by its dark fibers — comparing the
    result against the *full* per-pair budget then accounts for losses,
    so existing callers see degraded capacity without changing their
    comparison."""
    if health is not None and not health:
        health = None
    peak = 0
    for r in schedule.rounds:
        if health is None:
            peak = max(peak, _round_fiber_demand(r.pairs_arr, tiles_per_server,
                                                 chips_per_rack=chips_per_rack))
            continue
        arr = np.asarray(r.pairs_arr, dtype=np.int64).reshape(-1, 2)
        if chips_per_rack is not None:
            arr = arr[arr[:, 0] // chips_per_rack
                      == arr[:, 1] // chips_per_rack]
        srv = arr // tiles_per_server
        srv = srv[srv[:, 0] != srv[:, 1]]
        for pair, demand in _pair_demands(srv).items():
            peak = max(peak, demand + health.fibers_lost(pair))
    return peak


def rail_demand(schedule: Schedule, chips_per_rack: int, health=None) -> int:
    """Peak per-rack-pair rail demand across the schedule's rounds
    (``health`` inflates each pair's demand by its dark rails, like
    :func:`fiber_demand`)."""
    if health is not None and not health:
        health = None
    peak = 0
    for r in schedule.rounds:
        if health is None:
            peak = max(peak, _round_rail_demand(r.pairs_arr, chips_per_rack))
            continue
        arr = np.asarray(r.pairs_arr, dtype=np.int64).reshape(-1, 2)
        rk = arr // chips_per_rack
        rk = rk[rk[:, 0] != rk[:, 1]]
        for pair, demand in _pair_demands(rk).items():
            peak = max(peak, demand + health.rails_lost(pair))
    return peak


def order_for_locality(chips: Sequence[int], tiles_per_server: int,
                       radix: int = 4,
                       chips_per_rack: Optional[int] = None) -> list[int]:
    """Reorder a tenant's chips so low-stride (frequent, intra-group)
    collective rounds stay inside servers and only high-stride rounds cross
    fibers: sort by server, then fill digit groups server-by-server.  With
    ``chips_per_rack``, racks are grouped first (densest rack's chips
    contiguous), so rack crossings are pushed to the highest strides —
    and the per-rack groups line up for :func:`hierarchical_schedule`.

    For LUMORPH-2/4 the partner maps are index-arithmetic over the chip
    *list*, so placement is free — this is the software knob the photonic
    fabric gives us that a fixed torus does not (paper §3).
    """
    if chips_per_rack is not None:
        by_rack = group_by_rack(chips, chips_per_rack)
        out: list[int] = []
        for rk in sorted(by_rack, key=lambda r: (-len(by_rack[r]), r)):
            out.extend(order_for_locality(by_rack[rk], tiles_per_server, radix))
        return out
    by_server: dict[int, list[int]] = {}
    for c in chips:
        by_server.setdefault(c // tiles_per_server, []).append(c)
    out = []
    for srv in sorted(by_server, key=lambda s: -len(by_server[s])):
        out.extend(sorted(by_server[srv]))
    return out
