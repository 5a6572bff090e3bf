"""The port's copy of the Schedule IR (``repro.core.scheduler``).

A :class:`Schedule` is the single description of a collective: rounds of
directed circuit pairs plus, per round, the :class:`Transfer` chunk tables
that execution needs. The builders here are copies of the JAX package's
``ring_schedule``, ``rhd_schedule`` (LUMORPH-2), ``rqq_schedule``
(LUMORPH-4) and ``tree_schedule``, so both executors read the same tables
and both pricers the same shapes.

Pricing is copied with them: :meth:`Schedule.cost` and
:meth:`Schedule.cost_by_tier` price the rounds with the α–β model
(``core.cost_model.algorithm_cost`` delegates here, so ``--comm auto``
does), and the chunked lowering of overlap mode (:class:`ChunkedSchedule`,
its :class:`Wave` s and :func:`chunk_schedule`) prices its serial program
per wave, per chunk and pipelined against compute. The float operations
run in the reference's order, so the prices are the JAX package's to the
bit.

Left out: the fabric, rack, pod and health models, which belong to the
JAX package's rack simulator and are not JAX-bound. So pricing takes only
``rack=None`` (a rack or pod raises ``NotImplementedError``), and
``ChunkedSchedule.validate``, which checks waves against a rack, raises.
Also left out: hierarchical composition and the ``hier:*`` schedules it
makes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.cost_model import LinkModel, mixed_radix_factorization, pipeline_time

_NO_FABRIC = ("the port prices schedules on an ideal fabric only (rack=None): the fabric, "
              "rack, pod and health models belong to the JAX package's rack simulator")


@dataclasses.dataclass(frozen=True, eq=False)
class Transfer:
    """One point-to-point move inside a round, with its chunk arithmetic.

    The buffer is viewed as ``Schedule.n_chunks`` equal chunks. Rank ``i``
    ships the chunks ``send[i]`` to its partner under ``perm`` and applies
    the incoming chunks at ``recv[i]``: accumulating when ``reduce`` is
    set (reduce-scatter phases), overwriting otherwise (all-gather /
    broadcast phases). Ranks absent from ``perm``'s destinations receive
    nothing; their ``recv`` rows are placeholders the executor masks out.
    """

    perm: tuple[tuple[int, int], ...]  # (src_rank, dst_rank), partial permutation
    send: np.ndarray  # int32 (p, k): chunk ids each rank ships
    recv: np.ndarray  # int32 (p, k): chunk ids each rank updates
    reduce: bool = True  # True → add incoming, False → overwrite


class Round:
    """One communication round: simultaneous directed transfers.

    ``pairs_arr`` is the ``(n, 2)`` array of ``(src_chip, dst_chip)``
    circuits with the bytes each carries; ``transfers`` (rank space) exist
    only after :meth:`Schedule.materialize` ran.
    """

    __slots__ = ("pairs_arr", "bytes_per_circuit", "egress_fanout", "reduce", "_transfers",
                 "_sig")

    def __init__(self, pairs, bytes_per_circuit: float, egress_fanout: int = 1,
                 reduce: Optional[bool] = None,
                 transfers: Optional[tuple[Transfer, ...]] = None):
        self.pairs_arr = (pairs if isinstance(pairs, np.ndarray)
                          else np.asarray(list(pairs), dtype=np.int64).reshape(-1, 2))
        self.bytes_per_circuit = bytes_per_circuit
        self.egress_fanout = egress_fanout
        #: True = reduce-scatter (accumulate), False = all-gather (overwrite)
        self.reduce = reduce
        self._transfers = transfers
        self._sig = None

    @property
    def transfers(self) -> tuple[Transfer, ...]:
        """Execution lowering: one move per entry (rank space). Only
        available on a materialized schedule."""
        if self._transfers is None:
            raise RuntimeError("Transfer tables are lazy: call Schedule.materialize() "
                               "before reading Round.transfers")
        return self._transfers

    @property
    def circuit_signature(self) -> bytes:
        """Canonical identity of the round's circuit *set* (sorted unique
        pairs): two rounds reprogram no MZIs iff their signatures match."""
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
    #: lazy Transfer-table builder: one tuple of transfers per round
    _fill: Optional[Callable[[], tuple[tuple[Transfer, ...], ...]]] = \
        dataclasses.field(default=None, repr=False)

    @property
    def materialized(self) -> bool:
        return all(r._transfers is not None for r in self.rounds)

    def materialize(self) -> "Schedule":
        """Build the per-round :class:`Transfer` tables (idempotent)."""
        if self._fill is not None and not self.materialized:
            tables = self._fill()
            if len(tables) != len(self.rounds):
                raise RuntimeError(f"{self.algo}: transfer fill produced {len(tables)} "
                                   f"tables for {len(self.rounds)} rounds")
            for rnd, ts in zip(self.rounds, tables):
                rnd._transfers = tuple(ts)
        elif any(r._transfers is None for r in self.rounds):
            raise RuntimeError(f"{self.algo}: round has no transfer lowering and no "
                               "fill function")
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

    def _priced_rounds(self, link: LinkModel, rack=None):
        """Yield ``(tier, seconds)`` per round under the α–β model: the
        link's α (plus its reconfiguration window if the circuit set
        changed) plus the round's serialized egress bytes × β. Every round
        is tier 0 on the ideal fabric (``rack=None``), the only one the
        port prices."""
        if rack is not None:
            raise NotImplementedError(_NO_FABRIC)
        for r, changed in self._changed_flags():
            seconds = link.round_alpha(changed)
            yield 0, seconds + r.bytes_per_circuit * r.egress_fanout * link.beta

    def cost(self, link: LinkModel, rack=None) -> float:
        """Total α–β time of the program (see :meth:`_priced_rounds`).
        Pricing reads only the schedule's shape: no Transfer tables are
        built."""
        return sum(s for _, s in self._priced_rounds(link, rack))

    def cost_by_tier(self, link: LinkModel, rack=None) -> dict[int, float]:
        """:meth:`cost` split by tier (0 = intra-rack rounds); the values
        sum to :meth:`cost`."""
        out: dict[int, float] = {}
        for tier, s in self._priced_rounds(link, rack):
            out[tier] = out.get(tier, 0.0) + s
        return out


# ---------------------------------------------------------------------------
# Schedule builders (copies of repro.core.scheduler's)
# ---------------------------------------------------------------------------

def ring_schedule(chips: Sequence[int], n_bytes: float) -> Schedule:
    """Ring ALLREDUCE: 2(p−1) rounds, each chip ships n/p to its successor.

    Chunk map (n_chunks = p): reduce-scatter round ``t`` sends chunk
    ``(i−t) mod p`` and accumulates into ``(i−t−1) mod p``; the all-gather
    mirrors with overwrites.
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
    region, initially the whole buffer. A halving round at XOR distance
    ``d`` splits the region; the rank keeps the half selected by its bit
    at ``d``, ships the other half, and accumulates the partner's copy of
    the kept half. Doubling mirrors: ship the own region, adopt the
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
        rounds.append(Round(np.stack([arr, arr[idx ^ dist]], axis=1), chunk, reduce=True))
        chunk /= 2
        dist //= 2
    chunk = n_bytes / p
    dist = 1
    for _ in range(steps):  # doubling
        rounds.append(Round(np.stack([arr, arr[idx ^ dist]], axis=1), chunk, reduce=False))
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


def _rqq_round_pairs(arr: np.ndarray, idx: np.ndarray, r: int, stride: int) -> np.ndarray:
    """Circuit pairs of one radix-``r`` round: per digit offset, every chip
    pairs with the member of its digit group ``off`` digits away."""
    digit = (idx // stride) % r
    blocks = []
    for off in range(1, r):
        j = idx + (((digit + off) % r) - digit) * stride
        blocks.append(np.stack([arr, arr[j]], axis=1))
    return np.concatenate(blocks, axis=0)


def rqq_schedule(chips: Sequence[int], n_bytes: float, radix: int = 4) -> Schedule:
    """LUMORPH-4: radix-r quartering/quadrupling with (r−1) circuits/chip/round.

    Digit groups follow the mixed-radix factorization of p; in a radix-r
    round every chip exchanges distinct sub-chunks with the r−1 other chips
    in its digit group. Each round lowers to r−1 transfers, one per digit
    offset.
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
        chunk = n_bytes / group
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

    Full buffer per hop (n_chunks = 1). Works for any p (ranks ≥ p never
    appear in a perm).
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
            senders = np.asarray([i for i in range(p) if i % (1 << (k + 1)) == (1 << k)])
            levels.append((k, senders))
        for k, senders in levels:  # reduce toward rank 0
            rounds.append(Round(np.stack([arr[senders], arr[senders - (1 << k)]], axis=1),
                                n_bytes, reduce=True))
        for k, senders in reversed(levels):  # broadcast back
            rounds.append(Round(np.stack([arr[senders - (1 << k)], arr[senders]], axis=1),
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

    return Schedule("tree", chips, tuple(rounds), n_bytes, n_chunks=1, _fill=fill)


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


# ---------------------------------------------------------------------------
# chunked / pipelined lowering (overlap mode)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Wave:
    """One overlappable unit of a :class:`ChunkedSchedule`: chunk ``chunk``'s
    reduce-scatter prefix (``phase == "rs"``) or its all-gather suffix
    (``phase == "ag"``) on one ``1/C`` slice of the payload. ``schedule`` is
    an ordinary :class:`Schedule` over the slice, shared by every chunk."""

    chunk: int
    phase: str  # "rs" (reduce-scatter, accumulate) | "ag" (all-gather)
    schedule: Schedule


class ChunkedSchedule:
    """A :class:`Schedule` lowered onto ``n_chunks`` payload slices.

    The base program's rounds are split at the reduce-scatter/all-gather
    boundary (the rounds' ``reduce`` tags) and emitted once per chunk at
    ``n_bytes / C``: ``2·C`` waves (``C`` when a phase is empty). The two
    per-phase wave schedules share the base's Transfer tables: a ``1/C``
    slice is a whole buffer with the same chunk granularity. Pricing walks
    the serial concatenation of the waves as one ordinary schedule, so an
    MZI window is charged only where a chunk boundary changes the circuit
    set.
    """

    def __init__(self, base: Schedule, n_chunks: int):
        if n_chunks < 1:
            raise ValueError(f"n_chunks must be ≥ 1, got {n_chunks}")
        self.base = base
        self.n_chunks = n_chunks
        rs_rounds, ag_rounds = _split_phases(base)

        def scaled(rounds):
            new = tuple(Round(r.pairs_arr, r.bytes_per_circuit * (1.0 / n_chunks),
                              egress_fanout=r.egress_fanout, reduce=r.reduce)
                        for r in rounds)

            def fill():
                base.materialize()
                return tuple(r.transfers for r in rounds)

            return Schedule(base.algo, base.participants, new, base.n_bytes / n_chunks,
                            n_chunks=base.n_chunks, _fill=fill if new else None)

        self._rs = scaled(rs_rounds) if rs_rounds else None
        self._ag = scaled(ag_rounds) if ag_rounds else None
        self.waves: tuple[Wave, ...] = tuple(
            Wave(c, phase, sched) for c in range(n_chunks)
            for phase, sched in (("rs", self._rs), ("ag", self._ag)) if sched is not None)
        # the serial program: every chunk's waves back to back, priced as one
        # Schedule (the rounds are shared objects across chunks)
        self._serial = Schedule(f"{base.algo}|chunks={n_chunks}", base.participants,
                                tuple(r for w in self.waves for r in w.schedule.rounds),
                                base.n_bytes, n_chunks=base.n_chunks)

    @property
    def algo(self) -> str:
        return self._serial.algo

    @property
    def participants(self) -> tuple[int, ...]:
        return self.base.participants

    def waves_of_chunk(self, chunk: int) -> tuple[Wave, ...]:
        return tuple(w for w in self.waves if w.chunk == chunk)

    def wave_costs(self, link: LinkModel, rack=None) -> list[float]:
        """Per-wave α–β time, attributed by walking the serial program, so
        that a wave whose first round reuses the previous wave's circuits
        pays no MZI window."""
        priced = iter(self._serial._priced_rounds(link, rack))
        return [sum(next(priced)[1] for _ in w.schedule.rounds) for w in self.waves]

    def chunk_costs(self, link: LinkModel, rack=None) -> list[float]:
        """Per-chunk wire time (each chunk's rs and ag waves summed)."""
        per_chunk = [0.0] * self.n_chunks
        for w, s in zip(self.waves, self.wave_costs(link, rack)):
            per_chunk[w.chunk] += s
        return per_chunk

    def cost(self, link: LinkModel, rack=None) -> float:
        """Serial (overlap-disabled) α–β time of the chunked program. More
        chunks add α and MZI rounds, never β bytes."""
        return self._serial.cost(link, rack)

    def overlapped_cost(self, link: LinkModel, rack=None, compute_s: float = 0.0) -> float:
        """Pipelined makespan: the chunks' collectives back to back on the
        fabric, ``compute_s`` of compute split across the chunks and
        double-buffered (``cost_model.pipeline_time``)."""
        return pipeline_time(self.chunk_costs(link, rack), compute_s)

    def validate(self, rack, check_fibers: bool = True) -> None:
        raise NotImplementedError(_NO_FABRIC)


def chunk_schedule(schedule: Schedule, n_chunks: int) -> ChunkedSchedule:
    """Lower ``schedule`` into ``n_chunks`` overlappable waves (see
    :class:`ChunkedSchedule`); builds no Transfer tables."""
    return ChunkedSchedule(schedule, n_chunks)


def _split_phases(sched: Schedule) -> tuple[list[Round], list[Round]]:
    """An ALLREDUCE schedule's reduce-scatter prefix and all-gather suffix,
    by the rounds' phase tags; interleaved phases or untagged rounds raise."""
    rs: list[Round] = []
    ag: list[Round] = []
    for r in sched.rounds:
        if r.reduce is None:
            raise ValueError(f"{sched.algo}: round without a phase-tagged lowering "
                             "cannot be composed")
        if r.reduce:
            if ag:
                raise ValueError(f"{sched.algo}: reduce round after all-gather began")
            rs.append(r)
        else:
            ag.append(r)
    return rs, ag
