"""Rack- and pod-level topology over the LIGHTPATH wafer model.

The port's copy of ``repro.core.rack``, ``Pod`` included, with the
optional ``health`` state of :mod:`repro_torch.core.health`.

The LUMORPH rack itself lives in ``repro_torch.core.fabric``; this module adds
the tier above it: a :class:`Pod` of ``n_racks`` racks joined by
**inter-rack photonic rails** ("Photonic Rails" / Opus-style fabrics).
Rails are the pod analogue of the rack's inter-server fibers — a shared
per-rack-pair budget of circuits with their own link parameters
(:data:`repro_torch.core.cost_model.POD_RAIL_LINK`: lower bandwidth, higher α,
and a slower rack-tier OCS reconfiguration window than the on-wafer MZI
mesh).

Chips are numbered pod-globally: chip ``g`` lives in rack
``g // chips_per_rack``; within its rack the existing server/tile
addressing applies unchanged, so ``g // tiles_per_server`` is still a
pod-globally unique server id.  A circuit between two racks consumes one
rail from that rack pair's pool (and a TX/RX bank on each endpoint tile);
circuits inside a rack never touch rails.

The :class:`Pod` quacks like a :class:`~repro_torch.core.fabric.LumorphRack`
where the Schedule IR needs it to (``tiles_per_server``,
``fibers_per_server_pair``, ``validate_round``, ``feasible_round``), so
``Schedule.validate``/``Schedule.cost`` and the simulator work on either
tier transparently; pricing additionally charges rail time-sharing when
it sees a pod (see ``Schedule.cost``).
"""

from __future__ import annotations

from typing import Iterable, Optional

from repro_torch.core.cost_model import (LinkModel, MZI_RECONFIG_DELAY,
                                   POD_RAIL_LINK)
from repro_torch.core.fabric import (Circuit, CircuitError, LightpathFabric,  # noqa: F401
                               LumorphRack, peak_multiplicity, peak_pair_multiplicity,
                               round_pairs_array, validate_endpoint_limits,
                               validate_shared_budget)


def default_rack(n_chips: int = 256, tiles_per_server: int = 8,
                 trx_banks_per_tile: int = 4,
                 fibers_per_server_pair: int = 8) -> LumorphRack:
    """The paper's evaluation rack: 256 GPUs = 32 servers × 8 tiles."""
    assert n_chips % tiles_per_server == 0
    return LumorphRack(
        n_servers=n_chips // tiles_per_server,
        tiles_per_server=tiles_per_server,
        trx_banks_per_tile=trx_banks_per_tile,
        fibers_per_server_pair=fibers_per_server_pair,
    )


class Pod:
    """``n_racks`` LUMORPH racks joined by inter-rack photonic rails.

    ``rails_per_rack_pair`` is the circuit budget between any two racks;
    like the rack's fiber budget it is a *time-shareable* resource — the
    scheduler prices excess demand as β time-sharing rather than
    rejecting the round (``check_fibers=False`` on :meth:`validate_round`
    skips the hard budget check the same way it does for fibers).
    """

    def __init__(self, n_racks: int = 2, chips_per_rack: int = 256,
                 tiles_per_server: int = 8, trx_banks_per_tile: int = 4,
                 fibers_per_server_pair: int = 8,
                 rails_per_rack_pair: Optional[int] = None,
                 rail_link: LinkModel = POD_RAIL_LINK):
        if n_racks < 1:
            raise ValueError(f"a pod needs ≥ 1 rack, got {n_racks}")
        if chips_per_rack % tiles_per_server:
            raise ValueError(
                f"chips_per_rack {chips_per_rack} not a multiple of "
                f"tiles_per_server {tiles_per_server}")
        if rails_per_rack_pair is None:
            # default: one rail per 4 chips — an all-chip crossing round
            # (flat RHD's first halving at pod scale) time-shares 4×, while
            # the hierarchical inter stage fits after modest serialization
            rails_per_rack_pair = max(1, chips_per_rack // 4)
        self.n_racks = n_racks
        self.chips_per_rack = chips_per_rack
        self.tiles_per_server = tiles_per_server
        self.fibers_per_server_pair = fibers_per_server_pair
        self.rails_per_rack_pair = rails_per_rack_pair
        self.rail_link = rail_link
        #: optional FabricHealth (repro_torch.core.health); chips/pairs are
        #: keyed pod-globally.  None (or fault-free) keeps the vectorized
        #: immortal-fabric checks, bit-identical to the pre-health model.
        self.health = None
        self.racks = [
            LumorphRack(n_servers=chips_per_rack // tiles_per_server,
                        tiles_per_server=tiles_per_server,
                        trx_banks_per_tile=trx_banks_per_tile,
                        fibers_per_server_pair=fibers_per_server_pair)
            for _ in range(n_racks)]
        self._rails_in_use: dict[tuple[int, int], int] = {}
        self._circuits: dict[int, Circuit] = {}
        #: pod circuit id → the rack-local Circuit backing an intra-rack
        #: circuit (cross-rack circuits hold their endpoints directly)
        self._inner: dict[int, Circuit] = {}
        self._next_circuit_id = 0
        self.reconfig_events = 0
        self.reconfig_time = 0.0

    # -- addressing ----------------------------------------------------------
    @property
    def n_chips(self) -> int:
        return self.n_racks * self.chips_per_rack

    def rack_of(self, chip: int) -> int:
        return chip // self.chips_per_rack

    def server_of(self, chip: int) -> int:
        """Pod-globally unique server id (racks hold disjoint ranges)."""
        return chip // self.tiles_per_server

    def tile_of(self, chip: int) -> int:
        return chip % self.tiles_per_server

    def _local(self, chip: int) -> int:
        """Chip id inside its own rack's numbering."""
        return chip % self.chips_per_rack

    # -- circuits ------------------------------------------------------------
    def establish(self, src: int, dst: int) -> Circuit:
        """Build a directed circuit; cross-rack circuits consume one rail."""
        if src == dst:
            raise CircuitError("loopback circuits are not needed (intra-chip)")
        s_rack, d_rack = self.rack_of(src), self.rack_of(dst)
        if s_rack == d_rack:
            inner = self.racks[s_rack].establish(self._local(src), self._local(dst))
            c = Circuit(src=src, dst=dst, wavelength=inner.wavelength,
                        circuit_id=self._next_circuit_id,
                        via_fiber=inner.via_fiber)
            self._inner[c.circuit_id] = inner
        else:
            key = (min(s_rack, d_rack), max(s_rack, d_rack))
            used = self._rails_in_use.get(key, 0)
            if used >= self.rails_per_rack_pair:
                raise CircuitError(f"no free rail between racks {key}")
            src_fab = self.racks[s_rack].servers[
                self.racks[s_rack].server_of(self._local(src))]
            dst_fab = self.racks[d_rack].servers[
                self.racks[d_rack].server_of(self._local(dst))]
            wl = src_fab.alloc_endpoint(self.tile_of(src), None)
            try:
                dst_fab.alloc_rx_only(self.tile_of(dst))
            except CircuitError:
                src_fab.release_endpoint(self.tile_of(src), None, wl)
                raise
            self._rails_in_use[key] = used + 1
            c = Circuit(src=src, dst=dst, wavelength=wl,
                        circuit_id=self._next_circuit_id, via_rail=used)
        self._next_circuit_id += 1
        self._circuits[c.circuit_id] = c
        return c

    def teardown(self, circuit: Circuit) -> None:
        if circuit.circuit_id not in self._circuits:
            raise CircuitError(f"circuit {circuit.circuit_id} is not live")
        del self._circuits[circuit.circuit_id]
        s_rack, d_rack = self.rack_of(circuit.src), self.rack_of(circuit.dst)
        if s_rack == d_rack:
            self.racks[s_rack].teardown(self._inner.pop(circuit.circuit_id))
        else:
            src_fab = self.racks[s_rack].servers[
                self.racks[s_rack].server_of(self._local(circuit.src))]
            dst_fab = self.racks[d_rack].servers[
                self.racks[d_rack].server_of(self._local(circuit.dst))]
            src_fab.release_endpoint(self.tile_of(circuit.src), None,
                                     circuit.wavelength)
            dst_fab.release_endpoint(None, self.tile_of(circuit.dst), None)
            key = (min(s_rack, d_rack), max(s_rack, d_rack))
            self._rails_in_use[key] -= 1

    def reconfigure(self, new_pairs: Iterable[tuple[int, int]]) -> list[Circuit]:
        """Atomically replace all live circuits.  One window: MZIs inside
        every rack are reprogrammed in parallel; if any new circuit crosses
        racks the slower rack-tier OCS window governs the swap."""
        for c in list(self._circuits.values()):
            self.teardown(c)
        new = [self.establish(s, d) for s, d in new_pairs]
        self.reconfig_events += 1
        crossing = any(c.via_rail is not None for c in new)
        self.reconfig_time += (self.rail_link.reconfig if crossing
                               else MZI_RECONFIG_DELAY)
        return new

    def reconfig_window(self, chips, base: float) -> float:
        """The window to (re-)establish a circuit set over ``chips``: the
        slower rack-tier OCS window when they span racks (their circuits
        then include rails), else ``base``.  The one place the
        spanning-window rule lives — the simulator's arrival/recovery
        windows and the morph re-establish price both call this."""
        if len(group_by_rack(chips, self.chips_per_rack)) > 1:
            return max(base, self.rail_link.reconfig)
        return base

    def live_circuits(self) -> list[Circuit]:
        return list(self._circuits.values())

    # -- dry checks ----------------------------------------------------------
    def validate_round(self, pairs,
                       check_fibers: bool = True) -> None:
        """Pod-tier dry check of one round of simultaneous transfers.

        Per-chip TRX/wavelength limits always hold; with ``check_fibers``
        the shared-medium budgets are enforced too — intra-rack
        server-pair fibers *and* rack-pair rails.  ``pairs`` is an
        ``(n, 2)`` array or a ``[(src, dst), ...]`` list.
        ``check_fibers=False`` skips both budgets, for callers that price
        shortage as β time-sharing (``Schedule.cost`` with a pod) instead
        of infeasibility.  Like the rack's check, the healthy path is
        vectorized; violations fall back to per-pair accounting for the
        exact diagnosis.
        """
        arr = round_pairs_array(pairs)
        fab = self.racks[0].servers[0]
        banks = fab.trx_banks_per_tile
        wavelengths = fab.wavelengths_per_tile
        if self.health is not None and self.health:
            self._validate_round_degraded(arr, banks, wavelengths,
                                          check_fibers)
            return
        ok = (peak_multiplicity(arr[:, 0]) <= min(banks, wavelengths)
              and peak_multiplicity(arr[:, 1]) <= banks)
        if ok and check_fibers:
            rk = arr // self.chips_per_rack
            crossing = rk[:, 0] != rk[:, 1]
            rails_arr = rk[crossing]
            srv = arr[~crossing] // self.tiles_per_server
            srv = srv[srv[:, 0] != srv[:, 1]]
            ok = (peak_pair_multiplicity(srv[:, 0], srv[:, 1])
                  <= self.fibers_per_server_pair
                  and peak_pair_multiplicity(rails_arr[:, 0], rails_arr[:, 1])
                  <= self.rails_per_rack_pair)
        if ok:
            return
        tx: dict[int, int] = {}
        rx: dict[int, int] = {}
        fibers: dict[tuple[int, int], int] = {}
        rails: dict[tuple[int, int], int] = {}
        for s, d in arr.tolist():
            tx[s] = tx.get(s, 0) + 1
            rx[d] = rx.get(d, 0) + 1
            s_rack, d_rack = self.rack_of(s), self.rack_of(d)
            if s_rack != d_rack:
                key = (min(s_rack, d_rack), max(s_rack, d_rack))
                rails[key] = rails.get(key, 0) + 1
            else:
                s_srv, d_srv = self.server_of(s), self.server_of(d)
                if s_srv != d_srv:
                    skey = (min(s_srv, d_srv), max(s_srv, d_srv))
                    fibers[skey] = fibers.get(skey, 0) + 1
        validate_endpoint_limits(tx, rx, banks, wavelengths)
        if check_fibers:
            validate_shared_budget(fibers, self.fibers_per_server_pair,
                                   "servers", "fibers")
            validate_shared_budget(rails, self.rails_per_rack_pair,
                                   "racks", "rails")

    def _validate_round_degraded(self, arr, banks: int, wavelengths: int,
                                 check_fibers: bool) -> None:
        """Pod-tier dry check against a faulted fabric: per-chip TRX
        budgets shrink by dead lanes, per-server-pair fiber and
        per-rack-pair rail budgets by dark fibers/rails (the pod
        analogue of ``LumorphRack._validate_round_degraded``)."""
        h = self.health
        tx: dict[int, int] = {}
        rx: dict[int, int] = {}
        fibers: dict[tuple[int, int], int] = {}
        rails: dict[tuple[int, int], int] = {}
        for s, d in arr.tolist():
            tx[s] = tx.get(s, 0) + 1
            rx[d] = rx.get(d, 0) + 1
            s_rack, d_rack = self.rack_of(s), self.rack_of(d)
            if s_rack != d_rack:
                key = (min(s_rack, d_rack), max(s_rack, d_rack))
                rails[key] = rails.get(key, 0) + 1
            else:
                s_srv, d_srv = self.server_of(s), self.server_of(d)
                if s_srv != d_srv:
                    skey = (min(s_srv, d_srv), max(s_srv, d_srv))
                    fibers[skey] = fibers.get(skey, 0) + 1
        for chip, n in tx.items():
            healthy = banks - h.lanes_lost(chip)
            if n > healthy:
                raise CircuitError(
                    f"chip {chip} needs {n} TX circuits > {healthy} healthy "
                    f"TRX banks")
            if n > wavelengths:
                raise CircuitError(
                    f"chip {chip} needs {n} wavelengths > {wavelengths}")
        for chip, n in rx.items():
            healthy = banks - h.lanes_lost(chip)
            if n > healthy:
                raise CircuitError(
                    f"chip {chip} needs {n} RX circuits > {healthy} healthy "
                    f"TRX banks")
        if check_fibers:
            for key, n in fibers.items():
                budget = self.fibers_per_server_pair - h.fibers_lost(key)
                if n > budget:
                    raise CircuitError(
                        f"servers {key} need {n} fibers > {budget} healthy")
            for key, n in rails.items():
                budget = self.rails_per_rack_pair - h.rails_lost(key)
                if n > budget:
                    raise CircuitError(
                        f"racks {key} need {n} rails > {budget} healthy")

    def feasible_round(self, pairs,
                       check_fibers: bool = True) -> bool:
        try:
            self.validate_round(pairs, check_fibers=check_fibers)
        except CircuitError:
            return False
        return True


def group_by_rack(chips, chips_per_rack: int) -> dict[int, list[int]]:
    """Group chips by rack id, preserving each rack's chip order.

    The one rack-grouping primitive shared by schedule composition
    (``hierarchical_schedule``), admissibility (``candidate_algos``),
    locality ordering, allocation, and morph planning — the equal-share
    and rack-ordering rules those sites encode all read the same groups,
    so allocation cannot silently desynchronize from schedule
    admissibility.
    """
    groups: dict[int, list[int]] = {}
    for c in chips:
        groups.setdefault(c // chips_per_rack, []).append(c)
    return groups


def default_pod(n_racks: int = 2, chips_per_rack: int = 256,
                tiles_per_server: int = 8, trx_banks_per_tile: int = 4,
                fibers_per_server_pair: int = 8,
                rails_per_rack_pair: Optional[int] = None) -> Pod:
    """The pod the multi-rack benchmarks evaluate: N paper racks on rails."""
    return Pod(n_racks=n_racks, chips_per_rack=chips_per_rack,
               tiles_per_server=tiles_per_server,
               trx_banks_per_tile=trx_banks_per_tile,
               fibers_per_server_pair=fibers_per_server_pair,
               rails_per_rack_pair=rails_per_rack_pair)
