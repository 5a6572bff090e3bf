"""Fabric health: the mortal parts of a photonic rack/pod.

The port's copy of ``repro.core.health``, line for line (standard library
only), so that a faulted rack or pod prices and recovers as the
reference's does.

The base fabric model (:mod:`repro_torch.core.fabric`, :mod:`repro_torch.core.rack`)
is immortal — fibers, TRX lanes, rails, and the OCS always work.  A
:class:`FabricHealth` instance attached to a ``LumorphRack``/``Pod``
(``rack.health``) makes them mortal:

  * **fibers** — per-server-pair losses shrink that pair's shared budget
    (``fibers_per_server_pair − fibers_lost(pair)``); a pair with demand
    and no healthy fiber left makes the round inadmissible.
  * **TRX lanes** — per-chip bank losses shrink the chip's TX *and* RX
    degree budget; a chip with every bank dead is indistinguishable from
    a dead chip (the simulator escalates it to the chip-failure path).
  * **rails** — per-rack-pair losses, the pod-tier analogue of fibers.
  * **derates** — a chip whose laser drifts or whose link runs a high
    BER still works, but slower: its effective β is multiplied by a
    factor ≥ 1 (FEC retransmits / reduced modulation).  A round pays the
    *worst* derate among its chips — the circuits are simultaneous, so
    the slowest paces the round.
  * **OCS glitches** — transient windows during which circuit
    (re-)establishment fails with some probability; the engine retries
    with exponential backoff (:class:`OCSRetryPolicy`) and escalates a
    hard, retry-exhausted glitch into a permanent failure (rail loss, or
    ``mzi_failed`` for a rack-tier switch).

``epoch`` increments on every *permanent* mutation (fail/repair/derate)
and is folded into the schedule pricer's cache keys, so prices computed
under one health state never leak into another.  Glitches don't touch
the epoch: they delay circuit establishment but never change a price.
A fully repaired fabric is falsy again — pricing then returns to the
canonical-layout fast path and is bit-identical to a fabric that never
failed at all.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional


def _norm_pair(pair: Iterable[int]) -> tuple[int, int]:
    a, b = pair
    if a == b:
        raise ValueError(f"a fabric pair needs two distinct endpoints, got {pair}")
    return (min(a, b), max(a, b))


@dataclasses.dataclass(frozen=True)
class GlitchWindow:
    """A transient OCS fault: during [start, end) each circuit
    (re-)establishment attempt fails with probability ``prob``.
    ``link`` names the rack pair whose OCS glitches (pod tier); ``None``
    means the rack's own MZI mesh."""

    start: float
    end: float
    prob: float
    link: Optional[tuple[int, int]] = None


@dataclasses.dataclass(frozen=True)
class OCSRetryPolicy:
    """Retry/backoff for circuit establishment under an OCS glitch:
    up to ``max_retries`` attempts, the k-th waiting
    ``backoff_s · multiplier^(k−1)`` before it fires.  Exhausting the
    budget escalates the glitch to a permanent failure."""

    max_retries: int = 5
    backoff_s: float = 25e-6  # first retry wait (one rail OCS window)
    multiplier: float = 2.0

    def __post_init__(self):
        if self.max_retries < 1:
            raise ValueError("max_retries must be ≥ 1")
        if self.backoff_s <= 0 or self.multiplier < 1.0:
            raise ValueError("backoff_s must be > 0 and multiplier ≥ 1")

    @property
    def total_backoff_s(self) -> float:
        """Worst-case delay the policy ever charges: every retry fires."""
        return sum(self.backoff_s * self.multiplier ** k
                   for k in range(self.max_retries))

    def expected_retries(self, prob: float) -> float:
        """Expected retry count when each attempt fails w.p. ``prob``
        (truncated at the budget): Σ_{k=1..R} prob^k."""
        q = min(max(prob, 0.0), 1.0)
        return sum(q ** k for k in range(1, self.max_retries + 1))

    def expected_delay(self, prob: float) -> float:
        """Expected establishment delay under failure probability
        ``prob``: the k-th retry happens w.p. prob^k and waits
        ``backoff_s · multiplier^(k−1)``.  Monotone in ``prob`` and
        bounded by :attr:`total_backoff_s` — the property the p99 claim
        in the JAX package's ``benchmarks/sim_chaos.py`` leans on."""
        q = min(max(prob, 0.0), 1.0)
        return sum(q ** k * self.backoff_s * self.multiplier ** (k - 1)
                   for k in range(1, self.max_retries + 1))


class FabricHealth:
    """Mutable health state of one rack/pod fabric (see module docstring).

    Truthiness: ``bool(health)`` is True iff any *permanent* fault is
    live (dead fibers/lanes/rails, a derate, or an escalated OCS) — the
    flag every pricing fast path keys on.  Glitch windows alone keep the
    fabric truthy-False: they never change prices.
    """

    def __init__(self):
        #: bumped on every permanent mutation; pricer cache-key suffix
        self.epoch = 0
        self._dead_fibers: dict[tuple[int, int], int] = {}
        self._dead_lanes: dict[int, int] = {}
        self._dead_rails: dict[tuple[int, int], int] = {}
        self._derate: dict[int, float] = {}
        self._glitches: list[GlitchWindow] = []
        #: escalated rack-tier OCS failure: no new circuit can be
        #: established anywhere until repaired
        self.mzi_failed = False

    def __bool__(self) -> bool:
        return bool(self._dead_fibers or self._dead_lanes or self._dead_rails
                    or self._derate or self.mzi_failed)

    def _bump(self) -> None:
        self.epoch += 1

    # -- permanent faults ----------------------------------------------------
    def fail_fibers(self, pair: Iterable[int], count: int = 1) -> None:
        """``count`` fibers between server ``pair`` go dark."""
        key = _norm_pair(pair)
        self._dead_fibers[key] = self._dead_fibers.get(key, 0) + count
        self._bump()

    def repair_fibers(self, pair: Iterable[int]) -> None:
        """All dead fibers of the pair come back (MTTR repairs the cable)."""
        if self._dead_fibers.pop(_norm_pair(pair), None) is not None:
            self._bump()

    def fail_lanes(self, chip: int, count: int = 1) -> None:
        """``count`` TRX banks on ``chip`` die (TX and RX degree shrink)."""
        self._dead_lanes[chip] = self._dead_lanes.get(chip, 0) + count
        self._bump()

    def repair_lanes(self, chip: int) -> None:
        if self._dead_lanes.pop(chip, None) is not None:
            self._bump()

    def fail_rails(self, pair: Iterable[int], count: int = 1) -> None:
        """``count`` rails between rack ``pair`` go dark (pod tier)."""
        key = _norm_pair(pair)
        self._dead_rails[key] = self._dead_rails.get(key, 0) + count
        self._bump()

    def repair_rails(self, pair: Iterable[int]) -> None:
        if self._dead_rails.pop(_norm_pair(pair), None) is not None:
            self._bump()

    def set_derate(self, chip: int, factor: float) -> None:
        """``chip``'s circuits run ``factor×`` slower (BER/laser drift)."""
        if factor < 1.0:
            raise ValueError(f"derate factor must be ≥ 1, got {factor}")
        if factor == 1.0:
            self.clear_derate(chip)
            return
        self._derate[chip] = factor
        self._bump()

    def clear_derate(self, chip: int) -> None:
        if self._derate.pop(chip, None) is not None:
            self._bump()

    # -- OCS glitches --------------------------------------------------------
    def start_glitch(self, start: float, end: float, prob: float,
                     link: Optional[tuple[int, int]] = None) -> GlitchWindow:
        if end <= start:
            raise ValueError(f"glitch window [{start}, {end}) is empty")
        if not 0.0 < prob <= 1.0:
            raise ValueError(f"glitch probability must be in (0, 1], got {prob}")
        g = GlitchWindow(start, end, prob,
                         None if link is None else _norm_pair(link))
        self._glitches.append(g)
        return g

    def active_glitch(self, t: float) -> Optional[GlitchWindow]:
        """The strongest glitch window covering ``t`` (None when clear)."""
        best: Optional[GlitchWindow] = None
        for g in self._glitches:
            if g.start <= t < g.end and (best is None or g.prob > best.prob):
                best = g
        return best

    def escalate_ocs(self, link: Optional[tuple[int, int]],
                     rail_budget: int = 0) -> None:
        """A retry-exhausted hard glitch becomes a permanent failure: the
        rack pair's rails all die (``link`` given), or the rack-tier
        switch itself fails (``mzi_failed``).  The glitch windows on that
        switch are retired — the fault is no longer transient."""
        if link is None:
            self.mzi_failed = True
        else:
            key = _norm_pair(link)
            self._dead_rails[key] = self._dead_rails.get(key, 0) \
                + max(rail_budget, 1)
        self._glitches = [g for g in self._glitches
                          if g.link != (None if link is None
                                        else _norm_pair(link))]
        self._bump()

    def repair_ocs(self, link: Optional[tuple[int, int]] = None) -> None:
        """Undo an OCS fault: clear the escalated state and retire any
        remaining glitch windows on that switch."""
        changed = False
        if link is None:
            if self.mzi_failed:
                self.mzi_failed = False
                changed = True
        elif self._dead_rails.pop(_norm_pair(link), None) is not None:
            changed = True
        key = None if link is None else _norm_pair(link)
        kept = [g for g in self._glitches if g.link != key]
        if len(kept) != len(self._glitches):
            self._glitches = kept
        if changed:
            self._bump()

    # -- queries -------------------------------------------------------------
    def fibers_lost(self, pair: Iterable[int]) -> int:
        return self._dead_fibers.get(_norm_pair(pair), 0)

    def lanes_lost(self, chip: int) -> int:
        return self._dead_lanes.get(chip, 0)

    def rails_lost(self, pair: Iterable[int]) -> int:
        return self._dead_rails.get(_norm_pair(pair), 0)

    def derate_of(self, chip: int) -> float:
        return self._derate.get(chip, 1.0)

    def worst_derate(self, chips: Iterable[int]) -> float:
        """The β multiplier a round over ``chips`` pays: its circuits run
        simultaneously, so the slowest (most derated) chip paces all."""
        if not self._derate:
            return 1.0
        d = self._derate
        worst = 1.0
        for c in chips:
            f = d.get(c)
            if f is not None and f > worst:
                worst = f
        return worst

    def unusable_chips(self, banks_per_tile: int) -> list[int]:
        """Chips whose every TRX bank is dead — no circuit can touch them,
        so they are operationally dead chips."""
        return sorted(c for c, n in self._dead_lanes.items()
                      if n >= banks_per_tile)

    def degraded_overlap(self, t0: float, t1: float) -> float:
        """Seconds of ``[t0, t1)`` the fabric spends degraded: all of it
        while any permanent fault is live, else the union of glitch
        windows clipped to the interval (exact — the availability
        integral has no sampling error)."""
        if t1 <= t0:
            return 0.0
        if self:
            return t1 - t0
        spans = sorted((max(g.start, t0), min(g.end, t1))
                       for g in self._glitches
                       if g.end > t0 and g.start < t1)
        out = 0.0
        cur: Optional[list[float]] = None
        for s, e in spans:
            if cur is None:
                cur = [s, e]
            elif s <= cur[1]:
                cur[1] = max(cur[1], e)
            else:
                out += cur[1] - cur[0]
                cur = [s, e]
        if cur is not None:
            out += cur[1] - cur[0]
        return out
