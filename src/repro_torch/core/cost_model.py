"""α–β cost model for collective communication on LUMORPH (paper §4).

The port's own copy of ``repro.core.cost_model``, constant for constant and
formula for formula, so that every price comes out of the same float
operations in the same order (``tests/test_torch_cost_model.py`` holds
them to the bit). The prices are model outputs of the paper's link
constants, not measurements of any device.

The model prices an ALLREDUCE of ``n`` bytes across ``p`` accelerators:

  * α  — fixed per-round cost of sending one chunk (software + SerDes latency).
         On LUMORPH every round that establishes fresh circuits additionally
         pays the MZI reconfiguration delay (3.7 µs measured on the testbed).
  * β  — seconds per byte on one link (1 / link bandwidth). When a GPU splits
         its egress bandwidth across ``k`` simultaneous circuits (LUMORPH-4
         style), each circuit only gets ``BW / k``, i.e. the effective β is
         multiplied by ``k``: lower α-rounds are traded against higher β.

Paper constants (§4): NVLink-class 300 GB/s per direction, α = 0.7 µs,
MZI reconfiguration 3.7 µs. ``select_algorithm`` is what ``--comm auto``
asks per gradient bucket (``optim.grad_comm``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

# ---------------------------------------------------------------------------
# Hardware constants
# ---------------------------------------------------------------------------

#: Paper §4: per-direction NVLink-class bandwidth used in Fig 4.
PAPER_LINK_BW = 300e9  # bytes/s
#: Paper §4: α for NVLink derived by TACCL.
PAPER_ALPHA = 0.7e-6  # s
#: Paper §2: measured MZI reconfiguration delay on the LIGHTPATH testbed.
MZI_RECONFIG_DELAY = 3.7e-6  # s

#: TPU v5e ICI per-link bandwidth (used when pricing the executable
#: collectives for the TPU deployment target).
TPU_ICI_BW = 50e9  # bytes/s
TPU_ALPHA = 1.0e-6  # s (ICI per-hop launch cost, same order as NVLink's)

#: Inter-rack photonic rail parameters (pod tier; "Photonic Rails"-style
#: fabrics).  A rail is an 800G-class fiber pair between two racks: lower
#: bandwidth than an on-board NVLink-class port, a longer electrical +
#: optical path (higher α), and a rack-scale optical circuit switch that
#: reprograms more slowly than the on-wafer MZI mesh.
POD_RAIL_BW = 100e9  # bytes/s per rail, per direction
POD_RAIL_ALPHA = 1.2e-6  # s
RAIL_RECONFIG_DELAY = 25e-6  # s, rack-tier OCS reprogramming window

#: Degraded-link β multipliers (the JAX package's ``repro.core.health``,
#: kept here as constants only; the port has no health model): a link whose BER
#: climbed into the FEC-retransmit regime effectively halves its goodput;
#: a drifting laser forced down one modulation order loses ~2× as well,
#: compounding to ~4× before the lane is declared dead and the TRX bank
#: fails outright.  These seed chaos traces and the straggler→degrade
#: wiring in ``repro.runtime.fault_tolerance``.
BER_DERATE = 2.0
LASER_DRIFT_DERATE = 4.0


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Per-link α–β parameters of one fabric."""

    alpha: float  # s, fixed cost per chunk send
    bw: float  # bytes/s per direction per link
    reconfig: float = 0.0  # s, added to α on every round that reprograms MZIs
    name: str = "link"

    @property
    def beta(self) -> float:
        return 1.0 / self.bw

    def round_alpha(self, reconfigured: bool) -> float:
        return self.alpha + (self.reconfig if reconfigured else 0.0)


#: Ideal electrical switch baseline (paper's hardest baseline: no queuing).
IDEAL_SWITCH = LinkModel(alpha=PAPER_ALPHA, bw=PAPER_LINK_BW, reconfig=0.0, name="ideal-switch")
#: LUMORPH link: same SerDes α plus MZI reconfiguration on circuit changes.
LUMORPH_LINK = LinkModel(alpha=PAPER_ALPHA, bw=PAPER_LINK_BW, reconfig=MZI_RECONFIG_DELAY, name="lumorph")
#: TPU v5e ICI link for deployment-target pricing.
TPU_LINK = LinkModel(alpha=TPU_ALPHA, bw=TPU_ICI_BW, reconfig=0.0, name="tpu-ici")
#: Inter-rack photonic rail: the pod tier's link.  Rounds that cross racks
#: are priced with this model (bottleneck link of the round) and time-share
#: the per-rack-pair rail budget — see ``Schedule.cost`` with a ``Pod``.
POD_RAIL_LINK = LinkModel(alpha=POD_RAIL_ALPHA, bw=POD_RAIL_BW,
                          reconfig=RAIL_RECONFIG_DELAY, name="pod-rail")


# ---------------------------------------------------------------------------
# Collective cost formulas
# ---------------------------------------------------------------------------

def ring_all_reduce_cost(n_bytes: float, p: int, link: LinkModel) -> float:
    """Bandwidth-optimal Ring: 2(p−1) rounds of n/p bytes.

    Ring never reconfigures circuits after setup (fixed neighbour ring), so
    only the *first* round pays the reconfiguration penalty on LUMORPH: the
    ring topology is configured once at the start of the job (paper §3).
    """
    if p <= 1:
        return 0.0
    rounds = 2 * (p - 1)
    setup = link.reconfig  # one-time ring establishment
    return setup + rounds * (link.alpha + (n_bytes / p) * link.beta)


def tree_all_reduce_cost(n_bytes: float, p: int, link: LinkModel) -> float:
    """Binomial-tree reduce + broadcast: 2·⌈log2 p⌉ rounds of the full buffer.

    NCCL-style two-tree pipelining halves the β term; we model the classic
    single tree that the paper's Fig 4 baseline uses (full buffer per hop).
    Every tree level talks over a different circuit set, so on a
    reconfigurable fabric each round pays the MZI window in its α (on the
    ideal electrical links torus/SiPAC use, ``reconfig`` is 0 and this
    term vanishes) — matching ``tree_schedule`` priced round-by-round.
    """
    if p <= 1:
        return 0.0
    rounds = 2 * math.ceil(math.log2(p))
    return rounds * (link.round_alpha(True) + n_bytes * link.beta)


def rhd_all_reduce_cost(n_bytes: float, p: int, link: LinkModel) -> float:
    """LUMORPH-2: recursive halving (reduce-scatter) + doubling (all-gather).

    log2(p) halving rounds exchange n/2, n/4, … bytes; symmetric doubling.
    Every round talks to a *different* partner, so on LUMORPH every round
    pays the MZI reconfiguration in its α — except the first doubling
    round, whose distance-1 partners are exactly the last halving round's
    (the circuits are still up).  Total β bytes: 2·n·(p−1)/p —
    bandwidth-optimal, same as Ring, but only 2·log2(p) α-rounds.
    """
    if p <= 1:
        return 0.0
    if p & (p - 1):
        raise ValueError(f"recursive doubling/halving needs p=2^k, got {p}")
    rounds = int(math.log2(p))
    cost = 0.0
    chunk = n_bytes / 2
    for _ in range(rounds):  # reduce-scatter (halving)
        cost += link.round_alpha(True) + chunk * link.beta
        chunk /= 2
    chunk *= 2
    for i in range(rounds):  # all-gather (doubling); round 0 reuses circuits
        cost += link.round_alpha(i > 0) + chunk * link.beta
        chunk *= 2
    return cost


def rqq_all_reduce_cost(n_bytes: float, p: int, link: LinkModel, radix: int = 4) -> float:
    """LUMORPH-4 (radix-r quartering/quadrupling; paper's r=4).

    Each round a GPU opens ``radix−1`` simultaneous circuits and exchanges
    with ``radix−1`` partners, reducing the group radix-fold: log_r(p)
    rounds.  Egress bandwidth is *split* across the radix−1 circuits, so a
    round that ships (radix−1)·(chunk/radix) bytes out of one NIC takes
    (radix−1)·(chunk/radix)·β seconds — the α/β tradeoff of paper §4.

    Non-powers of ``radix`` fall back to mixed-radix factorization (a
    power-of-2 p always factors into 4s and a final 2).
    """
    if p <= 1:
        return 0.0
    radices = mixed_radix_factorization(p, radix)
    cost = 0.0
    group = 1
    # reduce-scatter phase: chunk per round = n / group_size_so_far
    for r in radices:
        chunk = n_bytes / group  # bytes each device currently owns
        sent = chunk * (r - 1) / r  # total egress this round
        cost += link.round_alpha(True) + sent * link.beta
        group *= r
    # all-gather phase mirrors in reverse; its first round reuses the last
    # reduce-scatter round's circuits (no MZI reprogramming needed)
    for i, r in enumerate(reversed(radices)):
        group //= r
        chunk = n_bytes / group
        sent = chunk * (r - 1) / r
        cost += link.round_alpha(i > 0) + sent * link.beta
    return cost


def dnc_greedy_cost(n_bytes: float, p: int, link: LinkModel) -> float:
    """D&C: greedy divide-and-conquer solution of the (intractable) custom
    circuit-schedule optimization (paper Fig 4b baseline).

    Greedy split: at each level pick the radix r ∈ {2, 4} that minimizes the
    *local* round cost — a faithful rendition of "greedy divide and conquer"
    over the non-convex α–β objective.
    """
    if p <= 1:
        return 0.0

    def best_split(group: int, chunk: float) -> float:
        if group == 1:
            return 0.0
        options = []
        for r in (2, 4):
            if group % r == 0:
                sent = chunk * (r - 1) / r
                round_cost = link.round_alpha(True) + sent * link.beta
                options.append(round_cost + best_split(group // r, chunk / r))
        if not options:  # odd group: one ring pass
            return (group - 1) * (link.round_alpha(True) + (chunk / group) * link.beta)
        return min(options)

    # reduce-scatter + all-gather are symmetric
    return 2.0 * best_split(p, n_bytes)


def pipeline_time(comm_per_chunk, compute_s: float = 0.0) -> float:
    """Makespan of a chunked collective double-buffered against compute.

    ``comm_per_chunk[c]`` is chunk ``c``'s wire time; ``compute_s`` is the
    *total* compute to hide, split evenly across the chunks (the per-bucket
    work a training step does as each reduced chunk lands).  Two engines:
    the fabric serializes the chunk collectives back-to-back, while the
    compute stream consumes chunk ``c`` as soon as both its collective and
    chunk ``c−1``'s compute finished — so each wave after the first costs
    ``max(comm, compute)`` and the total tends to
    ``max(Σcomm, Σcompute) + pipeline fill`` (PCCL's overlap argument).
    With ``compute_s == 0`` this degenerates to ``sum(comm_per_chunk)``.
    """
    comm = list(comm_per_chunk)
    if not comm:
        return compute_s
    per_chunk_compute = compute_s / len(comm)
    comm_end = 0.0
    compute_end = 0.0
    for m in comm:
        comm_end += m
        compute_end = max(compute_end, comm_end) + per_chunk_compute
    return compute_end


def mixed_radix_factorization(p: int, radix: int) -> list[int]:
    """Factor ``p`` into factors ≤ radix, preferring ``radix`` (e.g. 32 → [4,4,2])."""
    if p < 1:
        raise ValueError(f"p must be ≥ 1, got {p}")
    out: list[int] = []
    rem = p
    while rem > 1:
        if rem % radix == 0:
            out.append(radix)
            rem //= radix
            continue
        for r in range(min(radix, rem), 1, -1):
            if rem % r == 0:
                out.append(r)
                rem //= r
                break
        else:
            out.append(rem)  # prime > radix: single ring-style factor
            rem = 1
    return out


# ---------------------------------------------------------------------------
# Algorithm registry + selector
# ---------------------------------------------------------------------------

#: Closed-form α–β formulas.  Since the Schedule-IR refactor these are
#: **cross-checks only** (held against ``Schedule.cost`` in
#: ``tests/test_torch_cost_model.py``); pricing goes through the IR below.
ALGORITHMS: dict[str, Callable[[float, int, LinkModel], float]] = {
    "ring": ring_all_reduce_cost,
    "tree": tree_all_reduce_cost,
    "lumorph2": rhd_all_reduce_cost,
    "lumorph4": rqq_all_reduce_cost,
    "dnc": dnc_greedy_cost,
}

#: Algorithms whose price comes from the Schedule IR (one builder each in
#: ``repro_torch.core.scheduler``).  ``dnc`` is a search over schedules, not a
#: schedule, and keeps its closed form.
IR_PRICED = ("ring", "tree", "lumorph2", "lumorph4")


#: Explicit bound on the module-level pricing caches (``algorithm_cost``'s
#: IR delegate here, ``schedule_for_execution`` in ``core.collectives``):
#: long-lived processes — CI sweeps, notebooks, the scale benchmark —
#: must not grow them without bound.  See :func:`clear_pricing_caches`.
IR_COST_CACHE_SIZE = 65536


@functools.lru_cache(maxsize=IR_COST_CACHE_SIZE)
def _ir_cost(algo: str, n_bytes: float, p: int, link: LinkModel) -> float:
    # deferred import: scheduler builds on this module's LinkModel
    from repro_torch.core.scheduler import build_schedule
    return build_schedule(algo, tuple(range(p)), n_bytes).cost(link)


@functools.lru_cache(maxsize=IR_COST_CACHE_SIZE)
def _chunked_wave_costs(algo: str, n_bytes: float, p: int, link: LinkModel,
                        n_chunks: int) -> tuple[float, ...]:
    """Per-chunk wire time of ``algo`` chunked ``n_chunks`` ways (each entry
    one chunk's reduce-scatter + all-gather waves, priced in serial program
    order so MZI-window continuity across chunk boundaries is kept)."""
    from repro_torch.core.scheduler import build_schedule, chunk_schedule
    chunked = chunk_schedule(build_schedule(algo, tuple(range(p)), n_bytes),
                             n_chunks)
    return tuple(chunked.chunk_costs(link))


def chunked_wave_costs(algo: str, n_bytes: float, p: int, link: LinkModel,
                       n_chunks: int) -> tuple[float, ...]:
    """Public accessor for the per-chunk wire times (one entry per chunk,
    rs + ag waves summed) — what :func:`pipeline_time` consumes when a
    caller pipelines several collectives (e.g. a DDP bucket stream) into
    one schedule."""
    if algo == "lumorph2" and p & (p - 1):
        algo = "ring"  # keep the cache key canonical (same §3 fallback)
    if algo not in IR_PRICED:
        raise ValueError(f"no chunked lowering for {algo!r}; have {IR_PRICED}")
    if p <= 1:
        return (0.0,) * n_chunks
    return _chunked_wave_costs(algo, float(n_bytes), p, link, n_chunks)


def chunked_algorithm_cost(algo: str, n_bytes: float, p: int,
                           link: LinkModel, n_chunks: int) -> float:
    """Price one ALLREDUCE lowered as ``n_chunks`` chunked waves, executed
    serially (no overlap): the chunking *overhead* — extra α rounds — shows
    up here, the overlap *win* in :func:`overlapped_step_time`."""
    if algo == "lumorph2" and p & (p - 1):
        algo = "ring"  # keep the cache key canonical (same §3 fallback)
    if algo not in IR_PRICED:
        raise ValueError(f"no chunked lowering for {algo!r}; have {IR_PRICED}")
    if p <= 1:
        return 0.0
    if n_chunks == 1:
        # bit-identical to the monolithic price: one chunk's grouped wave
        # sums would reassociate the float adds by an ulp
        return algorithm_cost(algo, n_bytes, p, link)
    return sum(_chunked_wave_costs(algo, float(n_bytes), p, link, n_chunks))


def overlapped_step_time(algo: str, n_bytes: float, p: int, link: LinkModel,
                         n_chunks: int, compute_s: float) -> float:
    """Makespan of ``compute_s`` seconds of compute double-buffered against
    a chunked ALLREDUCE (see :func:`pipeline_time`).  ``n_chunks == 1``
    prices the unoverlapped baseline: compute + the monolithic collective."""
    if algo == "lumorph2" and p & (p - 1):
        algo = "ring"
    if p <= 1:
        return compute_s
    if n_chunks == 1:
        return compute_s + algorithm_cost(algo, n_bytes, p, link)
    return pipeline_time(_chunked_wave_costs(algo, float(n_bytes), p, link,
                                             n_chunks), compute_s)


def clear_pricing_caches() -> None:
    """Drop every module-level pricing cache: the ``algorithm_cost`` /
    ``Schedule.cost`` LRU here, the chunked wave-cost LRU
    (:func:`chunked_algorithm_cost` / :func:`overlapped_step_time`), and
    the virtual-rank executor's caches in ``repro_torch.core.collectives``
    (when that module was imported): the executable schedules, monolithic
    and chunked, keyed ``(algo, p, n_chunks)``, the compiled monolithic
    programs and the compiled wave programs. This helper is for
    long-lived processes, and is called between configurations so that
    measurements do not carry cache state into each other."""
    import sys

    _ir_cost.cache_clear()
    _chunked_wave_costs.cache_clear()
    collectives = sys.modules.get("repro_torch.core.collectives")
    if collectives is not None:
        collectives.schedule_for_execution.cache_clear()
        collectives._compiled.cache_clear()
        collectives._wave_program.cache_clear()


def algorithm_cost(algo: str, n_bytes: float, p: int, link: LinkModel) -> float:
    """Price one ALLREDUCE.  Delegates to the Schedule IR — the same
    rounds that execute and simulate are the rounds priced here."""
    if algo not in ALGORITHMS:
        raise ValueError(f"unknown collective algorithm {algo!r}; have {sorted(ALGORITHMS)}")
    if algo == "lumorph2" and p & (p - 1):
        # paper §3: non-powers-of-two use Ring on LUMORPH (the rhd builder
        # applies the same fallback; keep the cache key canonical)
        algo = "ring"
    if algo in IR_PRICED:
        return _ir_cost(algo, float(n_bytes), p, link)
    return ALGORITHMS[algo](n_bytes, p, link)


def select_algorithm(n_bytes: float, p: int, link: LinkModel,
                     candidates: tuple[str, ...] = ("ring", "lumorph2", "lumorph4")) -> str:
    """Beyond-paper: cost-model-driven per-buffer algorithm choice.

    The paper fixes one algorithm per job; we let every gradient bucket pick
    the cheapest schedule (small buckets → LUMORPH-4, huge buckets → Ring).
    """
    best, best_cost = None, float("inf")
    for algo in candidates:
        c = algorithm_cost(algo, n_bytes, p, link)
        if c < best_cost:
            best, best_cost = algo, c
    assert best is not None
    return best


def all_reduce_curve(p: int, link: LinkModel, sizes: list[float],
                     algos: tuple[str, ...] = ("ring", "tree", "dnc", "lumorph2", "lumorph4"),
                     ) -> dict[str, list[float]]:
    """Fig 4b: runtime (s) per algorithm across buffer sizes."""
    return {a: [algorithm_cost(a, s, p, link) for s in sizes] for a in algos}
