"""Fast-path schedule pricing: canonical layouts, bounded caching, and
bound-and-prune candidate search.

The port's copy of ``repro.core.pricing``: the ``SchedulePricer`` that the
placement policies price through, with the same cache keys and prices.

The event-driven simulator re-prices Schedule-IR collectives on every
tenant arrival, morph, and failure; at pod scale that planning path —
not the event loop — dominates how many scenarios a sweep can afford.
Three observations make it cheap:

  * **Layouts repeat up to isomorphism.**  Churn traces allocate, free,
    and re-allocate the *same shapes* on different literal chips.  The
    α–β price of a schedule depends only on the layout's geometry — which
    positions share a server, which share a rack — never on literal chip
    ids, so :func:`canonical_layout` relabels every chip tuple onto a
    canonical representative and isomorphic placements share one cache
    entry across tenants and across time.
  * **Pricing needs no Transfer tables.**  Schedules are built
    shape-only (see ``repro_torch.core.scheduler``); a cache miss allocates
    circuit-pair arrays but no per-rank chunk-id lists.
  * **Most candidates lose before they are built.**  Closed-form lower
    bounds from ``cost_model`` (exact for flat algorithms on an
    uncontended fabric) rank the candidate list; any candidate whose
    bound already exceeds the best admissible cost found so far is
    skipped without constructing its IR — at p = 2048 that prunes flat
    Ring's 2(p−1)-round program in O(1).

Bounds are *true* lower bounds of the rack-priced cost (fiber/rail
time-sharing and rail α/reconfig only ever add; see
``tests/test_pricing.py``), so pruning never changes the minimum —
golden traces stay bit-identical with the fast path on.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence

from repro_torch.core import cost_model as cm
from repro_torch.core.fabric import CircuitError, LumorphRack
from repro_torch.core.rack import Pod, group_by_rack
from repro_torch.core.scheduler import build_any_schedule, chunk_schedule


def canonical_layout(chips: Sequence[int], tiles_per_server: int,
                     chips_per_rack: Optional[int] = None) -> tuple[int, ...]:
    """Relabel a chip tuple onto its canonical geometry-equivalent layout.

    Racks, servers, and tiles are renamed in order of first appearance
    (servers stay inside their canonical rack's id range, tiles inside
    their canonical server), so two layouts map to the same tuple iff one
    can be turned into the other by renaming racks/servers/tiles — the
    transformations the α–β price, the TRX dry checks, and hierarchical
    admissibility are all invariant under.  Positions are preserved:
    feed locality-*ordered* chips and the canonical tuple is the ordered
    layout of the representative.
    """
    servers_per_rack = (chips_per_rack // tiles_per_server
                        if chips_per_rack is not None else None)
    rack_rename: dict[int, int] = {}
    rack_fill: list[int] = []  # servers named so far per canonical rack
    server_rename: dict[int, int] = {}
    tile_fill: dict[int, int] = {}
    out = []
    for c in chips:
        srv = c // tiles_per_server
        cs = server_rename.get(srv)
        if cs is None:
            if chips_per_rack is None:
                cs = len(server_rename)
            else:
                cr = rack_rename.setdefault(c // chips_per_rack,
                                            len(rack_rename))
                if cr == len(rack_fill):
                    rack_fill.append(0)
                cs = cr * servers_per_rack + rack_fill[cr]
                rack_fill[cr] += 1
            server_rename[srv] = cs
        t = tile_fill.get(cs, 0)
        tile_fill[cs] = t + 1
        out.append(cs * tiles_per_server + t)
    return tuple(out)


@dataclasses.dataclass
class PricerStats:
    """Counters of one :class:`SchedulePricer` (surfaced by the simulator
    in ``SimMetrics.pricing_summary``)."""

    hits: int = 0  # cache hits (canonical key already priced)
    misses: int = 0  # cache misses
    built: int = 0  # schedules actually constructed (shape-only)
    pruned: int = 0  # candidates skipped by the closed-form lower bound

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class SchedulePricer:
    """Prices collective algorithms on concrete chip layouts, fast.

    One pricer per simulator (or benchmark config): it owns a bounded
    LRU keyed on ``(algo, canonical layout, n_bytes)``, the closed-form
    lower bounds for pruning, and the hit/miss/built/pruned counters.
    ``canonical``/``prune``/``eager`` exist so the scale benchmark can
    toggle each fast path off and measure the pre-optimization baseline.
    """

    def __init__(self, link: cm.LinkModel,
                 rack: "Optional[LumorphRack | Pod]" = None,
                 tiles_per_server: int = 8,
                 chips_per_rack: Optional[int] = None,
                 cache_size: int = 4096,
                 canonical: bool = True, prune: bool = True,
                 eager: bool = False):
        self.link = link
        self.rack = rack
        self.tiles_per_server = tiles_per_server
        self.chips_per_rack = chips_per_rack
        self.cache_size = cache_size
        self.canonical = canonical
        self.prune = prune
        #: benchmark baseline: materialize every built schedule's Transfer
        #: tables, as the pre-lazy pricing path effectively did
        self.eager = eager
        self.stats = PricerStats()
        self._cache: OrderedDict[tuple, float] = OrderedDict()
        rail = rack.rail_link if isinstance(rack, Pod) else None
        #: link whose α/β/reconfig floor every governing link in this
        #: fabric — lower bounds priced on it are valid at either tier
        self._floor = link if rail is None else cm.LinkModel(
            alpha=min(link.alpha, rail.alpha), bw=max(link.bw, rail.bw),
            reconfig=min(link.reconfig, rail.reconfig), name="bound-floor")

    # -- keys ---------------------------------------------------------------
    def _health_suffix(self) -> tuple:
        """Cache-key suffix while the fabric carries permanent faults
        (``rack.health`` truthy — :mod:`repro_torch.core.health`): entries are
        tagged with the health epoch, so every fail/repair/derate
        invalidates them wholesale and prices from one health state never
        serve another.  Empty on a healthy (or fully repaired) fabric —
        zero-fault keys, and therefore prices, are bit-identical to a
        pricer with no health model at all."""
        h = getattr(self.rack, "health", None)
        if h is not None and h:
            return ("#health", h.epoch)
        return ()

    def cache_key_chips(self, chips: Sequence[int]) -> tuple[int, ...]:
        """The representative layout a chip tuple is priced as.  Live
        fabric faults break layout isomorphism (the price depends on
        *which* fibers/chips are hurt), so a faulted fabric prices
        literal chip tuples."""
        if not self.canonical or self._health_suffix():
            return tuple(chips)
        return canonical_layout(chips, self.tiles_per_server,
                                self.chips_per_rack)

    # -- pricing ------------------------------------------------------------
    def price(self, algo: str, chips: Sequence[int], n_bytes: float,
              _key_chips: Optional[tuple[int, ...]] = None) -> float:
        """Price one algorithm (flat or ``hier:*``) on one concrete chip
        set via the Schedule IR: TRX-infeasible schedules are inadmissible
        (``inf``); fiber — and on a pod rail — shortage is charged as β
        time-sharing.  Cached on the canonical layout, so isomorphic
        placements (the common case in churn traces) price once.
        ``_key_chips`` lets :meth:`cheapest` canonicalize once per call
        instead of once per candidate."""
        key = (algo, _key_chips if _key_chips is not None
               else self.cache_key_chips(chips), n_bytes) \
            + self._health_suffix()
        cached = self._cache.get(key)
        if cached is not None:
            self._cache.move_to_end(key)
            self.stats.hits += 1
            return cached
        self.stats.misses += 1
        cost = self._build_and_price(algo, key[1], n_bytes)
        self._cache[key] = cost
        if len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return cost

    def _build_and_price(self, algo: str, chips: tuple[int, ...],
                         n_bytes: float) -> float:
        self.stats.built += 1
        try:
            sched = build_any_schedule(algo, chips, n_bytes,
                                       chips_per_rack=self.chips_per_rack)
        except ValueError:
            if not algo.startswith("hier:"):
                raise  # a flat-builder bug must fail loudly, not price inf
            # hier candidate went inadmissible (e.g. rack shares turned
            # unequal after a re-slice)
            return float("inf")
        if self.eager:
            sched.materialize()
        if self.rack is None:
            return sched.cost(self.link)
        try:
            sched.validate(self.rack, check_fibers=False)
        except CircuitError:
            return float("inf")  # e.g. egress fanout > TRX banks
        return sched.cost(self.link, rack=self.rack)

    def chunk_costs(self, algo: str, chips: Sequence[int], n_bytes: float,
                    n_chunks: int) -> tuple[float, ...]:
        """Per-chunk wire time of ``algo`` chunked ``n_chunks`` ways on this
        concrete layout (rack-priced like :meth:`price`; ``inf`` per chunk
        when the program is inadmissible).  Shape-only — chunking never
        materializes Transfer tables — and cached on the canonical layout
        under a ``("chunks", …)`` key next to the monolithic prices."""
        key = ("chunks", algo, self.cache_key_chips(chips), n_bytes,
               n_chunks) + self._health_suffix()
        cached = self._cache.get(key)
        if cached is not None:
            self._cache.move_to_end(key)
            self.stats.hits += 1
            return cached
        self.stats.misses += 1
        self.stats.built += 1
        try:
            sched = build_any_schedule(algo, key[2], n_bytes,
                                       chips_per_rack=self.chips_per_rack)
        except ValueError:
            if not algo.startswith("hier:"):
                raise
            sched = None
        if sched is None:
            costs: tuple[float, ...] = (float("inf"),) * n_chunks
        else:
            chunked = chunk_schedule(sched, n_chunks)
            if self.rack is not None:
                try:
                    chunked.validate(self.rack, check_fibers=False)
                except CircuitError:
                    chunked = None
            costs = ((float("inf"),) * n_chunks if chunked is None else
                     tuple(chunked.chunk_costs(self.link, self.rack)))
        self._cache[key] = costs
        if len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return costs

    def price_overlapped(self, algo: str, chips: Sequence[int],
                         n_bytes: float, n_chunks: int,
                         compute_s: float = 0.0) -> float:
        """Pipelined step makespan on this layout: the chunked collective
        double-buffered against ``compute_s`` of compute
        (``cost_model.pipeline_time`` over :meth:`chunk_costs`)."""
        if len(tuple(chips)) <= 1:
            return compute_s
        return cm.pipeline_time(
            self.chunk_costs(algo, chips, n_bytes, n_chunks), compute_s)

    # -- bounds + pruning ---------------------------------------------------
    def lower_bound(self, algo: str, chips: Sequence[int],
                    n_bytes: float) -> float:
        """A true lower bound of :meth:`price` that costs O(1) after its
        first evaluation per ``(algo, p)`` — no IR is built.

        Flat algorithms: the closed-form/IR cost on the *floor* link with
        no fabric contention (time-sharing and rail upgrades only ever
        add).  ``hier:<intra>``: the flat intra bound at the per-rack
        width plus the inter ring stage's α/β floor; a 1−1e-9 safety
        factor keeps the bound strictly conservative against float
        reordering, at no practical loss of pruning power.

        Valid under any fabric health state: faults only ever *raise*
        prices (budgets shrink, derates are ≥ 1), so the uncontended
        floor bound stays below the degraded price and pruning remains
        exact — the degraded-pricing property tests pin this.
        """
        p = len(chips)
        if p <= 1:
            return 0.0
        if not algo.startswith("hier:"):
            return cm.algorithm_cost(algo, n_bytes, p, self._floor)
        intra = algo.split(":", 1)[1]
        R = len(group_by_rack(chips, self.chips_per_rack)) \
            if self.chips_per_rack else 1
        m = max(1, p // R)
        bound = cm.algorithm_cost(intra, n_bytes, m, self._floor) if m > 1 else 0.0
        if R > 1:
            bound += 2 * (R - 1) * (self._floor.alpha
                                    + n_bytes / (m * R) * self._floor.beta)
        return bound * (1.0 - 1e-9)

    def cheapest(self, algos: Sequence[str], chips: Sequence[int],
                 n_bytes: float) -> float:
        """The cheapest admissible price among ``algos`` on this layout.

        With pruning on, candidates are visited in lower-bound order and
        any whose bound already meets the best cost found so far is
        skipped without building its IR.  Because every bound is a true
        lower bound, the returned minimum is exactly
        ``min(price(a) for a in algos)``.
        """
        key_chips = self.cache_key_chips(chips)
        if not self.prune:
            return min(self.price(a, chips, n_bytes, _key_chips=key_chips)
                       for a in algos)
        ranked = sorted(
            ((self.lower_bound(a, chips, n_bytes), i, a)
             for i, a in enumerate(algos)))
        best = float("inf")
        for bound, _, algo in ranked:
            if bound >= best:
                self.stats.pruned += 1
                continue
            cost = self.price(algo, chips, n_bytes, _key_chips=key_chips)
            if cost < best:
                best = cost
        return best

    # -- maintenance --------------------------------------------------------
    def __len__(self) -> int:
        return len(self._cache)

    def clear(self) -> None:
        """Drop the cache (counters keep accumulating)."""
        self._cache.clear()

    # -- warm-start ---------------------------------------------------------
    def export_entries(self, limit: Optional[int] = None) -> list[tuple]:
        """The cache's ``(key, cost)`` pairs, most-recently-used first.

        Keys are canonical — ``(algo, canonical layout, n_bytes)`` or the
        ``("chunks", …)`` variant — so entries are valid in any pricer
        built over the same link/rack geometry.  The sweep engine ships
        these across process boundaries to warm sibling workers
        (:mod:`repro_torch.sweep`); they are plain tuples of str/int/float, so
        they pickle cheaply.  Entries priced under live fabric faults
        (``"#health"``-tagged keys) are excluded — health state is local
        to one simulator and never portable across workers."""
        items = [kv for kv in self._cache.items() if "#health" not in kv[0]]
        items.reverse()  # OrderedDict iterates LRU→MRU; exports want MRU first
        if limit is not None:
            items = items[:limit]
        return items

    def seed_entries(self, entries: Sequence[tuple]) -> int:
        """Pre-populate the cache from :meth:`export_entries` output.

        Insert-if-absent (a live entry is never clobbered), counters are
        untouched — a seeded hit still counts as a hit, keeping stats
        comparable between cold and warm runs.  Returns how many entries
        were installed.  Seeding never changes *prices*: a seeded entry
        holds exactly what this pricer would compute for its key, so
        warm-started sweeps stay bit-identical to cold ones."""
        installed = 0
        for key, cost in entries:
            if key in self._cache:
                continue
            self._cache[key] = cost
            installed += 1
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
        return installed
