"""LIGHTPATH: a server-scale switchable photonic fabric (paper §2).

The port's copy of ``repro.core.fabric`` (numpy and plain Python), line for
line, so that circuits, ``CircuitError`` s and fiber checks are the JAX
package's; it keeps the reference's behaviour, faults included.

Software model of the hardware prototype:

  * a LIGHTPATH wafer carries up to 32 **tiles**; a compute chip (GPU/TPU)
    is 3D-stacked on each tile;
  * every tile has a number of **TRX banks** (transmitter = MRR modulators,
    receiver = demux + Ge photodetectors + SerDes) — each bank terminates
    one optical circuit at a time;
  * a tile drives up to 16 **wavelength-multiplexed lasers**; a circuit
    occupies one wavelength on the waveguide path it traverses;
  * **MZI 1×3 switches** program the waveguide network; reprogramming takes
    3.7 µs (measured).  Establishing a circuit between any two tiles =
    configuring MZIs so a pair of bus waveguides connects TRX(A) → TRX(B).

The model enforces the resource limits (TRX banks per tile, wavelengths per
waveguide segment) and accounts reconfigurations so the scheduler/cost-model
can price collectives.  Waveguide routing uses the dense tile-to-tile
waveguide mesh the paper describes ("thousands of waveguides between
tiles"), so any free TRX pair can be connected — the fabric is
*non-blocking at the TRX level*; contention only arises at TRX banks.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

from repro_torch.core.cost_model import MZI_RECONFIG_DELAY

#: Paper §2 hardware limits.
MAX_TILES_PER_WAFER = 32
WAVELENGTHS_PER_TILE = 16


@dataclasses.dataclass(frozen=True)
class Circuit:
    """A live optical circuit between two tiles (directed: src transmits)."""

    src: int  # global chip id
    dst: int
    wavelength: int
    circuit_id: int
    via_fiber: Optional[int] = None  # fiber index when crossing servers
    via_rail: Optional[int] = None  # rail index when crossing racks (pod tier)


class CircuitError(RuntimeError):
    """Raised when a circuit cannot be established (resource exhausted)."""


class LightpathFabric:
    """One LIGHTPATH wafer: ``n_tiles`` tiles inside a single server."""

    def __init__(self, n_tiles: int = 8, trx_banks_per_tile: int = 4,
                 wavelengths_per_tile: int = WAVELENGTHS_PER_TILE):
        if n_tiles > MAX_TILES_PER_WAFER:
            raise ValueError(
                f"a LIGHTPATH wafer has ≤ {MAX_TILES_PER_WAFER} tiles, got {n_tiles}")
        self.n_tiles = n_tiles
        self.trx_banks_per_tile = trx_banks_per_tile
        self.wavelengths_per_tile = wavelengths_per_tile
        # per-tile occupancy
        self._tx_in_use = [0] * n_tiles
        self._rx_in_use = [0] * n_tiles
        self._lambda_in_use: list[set[int]] = [set() for _ in range(n_tiles)]

    # -- resource accounting -------------------------------------------------
    def tx_free(self, tile: int) -> int:
        return self.trx_banks_per_tile - self._tx_in_use[tile]

    def rx_free(self, tile: int) -> int:
        return self.trx_banks_per_tile - self._rx_in_use[tile]

    def alloc_endpoint(self, src_tile: int, dst_tile: Optional[int]) -> int:
        """Reserve a TX bank on ``src_tile`` (and RX on ``dst_tile`` if local).

        Returns the wavelength assigned to the new circuit.  ``dst_tile`` is
        None when the circuit exits the server over a fiber (RX is on the
        remote wafer).
        """
        if self.tx_free(src_tile) <= 0:
            raise CircuitError(f"tile {src_tile}: no free TX bank")
        if dst_tile is not None and self.rx_free(dst_tile) <= 0:
            raise CircuitError(f"tile {dst_tile}: no free RX bank")
        free_lambda = set(range(self.wavelengths_per_tile)) - self._lambda_in_use[src_tile]
        if not free_lambda:
            raise CircuitError(f"tile {src_tile}: all {self.wavelengths_per_tile} wavelengths lit")
        wl = min(free_lambda)
        self._tx_in_use[src_tile] += 1
        self._lambda_in_use[src_tile].add(wl)
        if dst_tile is not None:
            self._rx_in_use[dst_tile] += 1
        return wl

    def alloc_rx_only(self, dst_tile: int) -> None:
        """Reserve an RX bank for a circuit arriving over a fiber."""
        if self.rx_free(dst_tile) <= 0:
            raise CircuitError(f"tile {dst_tile}: no free RX bank")
        self._rx_in_use[dst_tile] += 1

    def release_endpoint(self, src_tile: Optional[int], dst_tile: Optional[int],
                         wavelength: Optional[int]) -> None:
        if src_tile is not None:
            self._tx_in_use[src_tile] -= 1
            if wavelength is not None:
                self._lambda_in_use[src_tile].discard(wavelength)
        if dst_tile is not None:
            self._rx_in_use[dst_tile] -= 1

    def reset(self) -> None:
        self._tx_in_use = [0] * self.n_tiles
        self._rx_in_use = [0] * self.n_tiles
        self._lambda_in_use = [set() for _ in range(self.n_tiles)]


def validate_endpoint_limits(tx: dict[int, int], rx: dict[int, int],
                             banks: int, wavelengths: int) -> None:
    """Per-chip degree limits of one round: TX/RX count ≤ TRX banks,
    TX count ≤ wavelength budget.  Shared by the rack- and pod-tier dry
    checks so a tightened rule applies to both."""
    for chip, n in tx.items():
        if n > banks:
            raise CircuitError(f"chip {chip} needs {n} TX circuits > {banks} TRX banks")
        if n > wavelengths:
            raise CircuitError(f"chip {chip} needs {n} wavelengths > {wavelengths}")
    for chip, n in rx.items():
        if n > banks:
            raise CircuitError(f"chip {chip} needs {n} RX circuits > {banks} TRX banks")


def validate_shared_budget(per_pair: dict[tuple[int, int], int], budget: int,
                           noun: str, medium: str) -> None:
    """Shared-medium budget of one round (fibers per server pair, rails
    per rack pair): peak demand on any pair must fit the pool."""
    for key, n in per_pair.items():
        if n > budget:
            raise CircuitError(f"{noun} {key} need {n} {medium} > {budget}")


def round_pairs_array(pairs) -> np.ndarray:
    """Normalize one round's circuit list to an ``(n, 2)`` int array —
    the dry checks accept the Schedule IR's array-backed rounds and plain
    ``[(src, dst), ...]`` lists interchangeably."""
    if isinstance(pairs, np.ndarray):
        return pairs.reshape(-1, 2)
    return np.asarray(list(pairs), dtype=np.int64).reshape(-1, 2)


def peak_multiplicity(ids: np.ndarray) -> int:
    """Peak multiplicity of any value in ``ids`` (0 when empty)."""
    if ids.size == 0:
        return 0
    return int(np.bincount(np.unique(ids, return_inverse=True)[1]).max())


def peak_pair_multiplicity(a: np.ndarray, b: np.ndarray) -> int:
    """Peak multiplicity of any unordered ``(a, b)`` pair — the one
    demand-counting primitive shared by the rack/pod dry checks and the
    scheduler's fiber/rail pricing, so the two can never disagree on a
    round's shared-medium demand."""
    if a.size == 0:
        return 0
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    return peak_multiplicity(lo * (int(hi.max()) + 1) + hi)


class LumorphRack:
    """LUMORPH: ``n_servers`` LIGHTPATH servers cascaded with direct fibers.

    Chips are numbered globally: chip ``g`` lives on server ``g // tiles``
    tile ``g % tiles``.  Inter-server circuits consume one fiber from the
    rack-level fiber pool (paper: "given enough fibers between servers,
    LUMORPH provides arbitrary sized circuit-switched allocations").
    """

    def __init__(self, n_servers: int = 32, tiles_per_server: int = 8,
                 trx_banks_per_tile: int = 4, fibers_per_server_pair: int = 8):
        self.n_servers = n_servers
        self.tiles_per_server = tiles_per_server
        self.servers = [LightpathFabric(tiles_per_server, trx_banks_per_tile)
                        for _ in range(n_servers)]
        self.fibers_per_server_pair = fibers_per_server_pair
        #: optional FabricHealth (repro_torch.core.health): dead fibers/lanes,
        #: derates.  None (or a fault-free instance) keeps every check on
        #: the vectorized immortal-fabric path, bit-identical to before
        #: the health model existed.
        self.health = None
        self._fibers_in_use: dict[tuple[int, int], int] = {}
        self._circuits: dict[int, Circuit] = {}
        self._next_circuit_id = 0
        #: total reconfiguration events (each batch of changes = one MZI
        #: reprogramming window of MZI_RECONFIG_DELAY)
        self.reconfig_events = 0
        self.reconfig_time = 0.0

    # -- addressing ----------------------------------------------------------
    @property
    def n_chips(self) -> int:
        return self.n_servers * self.tiles_per_server

    def server_of(self, chip: int) -> int:
        return chip // self.tiles_per_server

    def tile_of(self, chip: int) -> int:
        return chip % self.tiles_per_server

    # -- circuits ------------------------------------------------------------
    def establish(self, src: int, dst: int) -> Circuit:
        """Program MZIs to build a directed circuit src → dst."""
        if src == dst:
            raise CircuitError("loopback circuits are not needed (intra-chip)")
        s_srv, d_srv = self.server_of(src), self.server_of(dst)
        s_tile, d_tile = self.tile_of(src), self.tile_of(dst)
        fiber = None
        if s_srv == d_srv:
            wl = self.servers[s_srv].alloc_endpoint(s_tile, d_tile)
        else:
            key = (min(s_srv, d_srv), max(s_srv, d_srv))
            used = self._fibers_in_use.get(key, 0)
            if used >= self.fibers_per_server_pair:
                raise CircuitError(f"no free fiber between servers {key}")
            wl = self.servers[s_srv].alloc_endpoint(s_tile, None)
            try:
                self.servers[d_srv].alloc_rx_only(d_tile)
            except CircuitError:
                self.servers[s_srv].release_endpoint(s_tile, None, wl)
                raise
            self._fibers_in_use[key] = used + 1
            fiber = used
        c = Circuit(src=src, dst=dst, wavelength=wl,
                    circuit_id=self._next_circuit_id, via_fiber=fiber)
        self._next_circuit_id += 1
        self._circuits[c.circuit_id] = c
        return c

    def teardown(self, circuit: Circuit) -> None:
        if circuit.circuit_id not in self._circuits:
            raise CircuitError(f"circuit {circuit.circuit_id} is not live")
        del self._circuits[circuit.circuit_id]
        s_srv, d_srv = self.server_of(circuit.src), self.server_of(circuit.dst)
        s_tile, d_tile = self.tile_of(circuit.src), self.tile_of(circuit.dst)
        if s_srv == d_srv:
            self.servers[s_srv].release_endpoint(s_tile, d_tile, circuit.wavelength)
        else:
            self.servers[s_srv].release_endpoint(s_tile, None, circuit.wavelength)
            self.servers[d_srv].release_endpoint(None, d_tile, None)
            key = (min(s_srv, d_srv), max(s_srv, d_srv))
            self._fibers_in_use[key] -= 1

    def reconfigure(self, new_pairs: Iterable[tuple[int, int]]) -> list[Circuit]:
        """Atomically replace all live circuits with ``new_pairs``.

        One reconfiguration window: all MZIs are reprogrammed together, so
        the whole swap costs a single MZI_RECONFIG_DELAY (paper §2: switches
        are programmed in parallel).  Returns the new circuits.
        """
        for c in list(self._circuits.values()):
            self.teardown(c)
        new = [self.establish(s, d) for s, d in new_pairs]
        self.reconfig_events += 1
        self.reconfig_time += MZI_RECONFIG_DELAY
        return new

    def live_circuits(self) -> list[Circuit]:
        return list(self._circuits.values())

    def validate_round(self, pairs,
                       check_fibers: bool = True) -> None:
        """Check a round of simultaneous transfers is realizable (dry check).

        Degree limits: per-chip TX/RX count ≤ TRX banks; wavelength budget;
        fiber budget per server pair.  Raises CircuitError with a diagnosis.
        ``pairs`` is an ``(n, 2)`` array or a ``[(src, dst), ...]`` list.
        ``check_fibers=False`` skips the fiber budget, for callers that
        model fiber shortage as time-sharing (serialized sub-rounds priced
        by ``Schedule.cost(link, rack=...)``) rather than infeasibility.

        The healthy path is fully vectorized; only a detected violation
        falls back to per-pair accounting to produce the exact diagnosis.
        With live fabric faults (``self.health`` truthy) the per-pair
        path always runs, against each chip's/pair's *effective* budget.
        """
        arr = round_pairs_array(pairs)
        banks = self.servers[0].trx_banks_per_tile
        wavelengths = self.servers[0].wavelengths_per_tile
        if self.health is not None and self.health:
            self._validate_round_degraded(arr, banks, wavelengths,
                                          check_fibers)
            return
        ok = (peak_multiplicity(arr[:, 0]) <= min(banks, wavelengths)
              and peak_multiplicity(arr[:, 1]) <= banks)
        srv = arr // self.tiles_per_server
        inter = srv[srv[:, 0] != srv[:, 1]]
        if ok and check_fibers:
            ok = (peak_pair_multiplicity(inter[:, 0], inter[:, 1])
                  <= self.fibers_per_server_pair)
        if ok:
            return
        # violation: rebuild the per-chip/per-pair tallies in pair order so
        # the diagnosis names the same offender the scalar path always did
        tx: dict[int, int] = {}
        rx: dict[int, int] = {}
        fibers: dict[tuple[int, int], int] = {}
        for s, d in arr.tolist():
            tx[s] = tx.get(s, 0) + 1
            rx[d] = rx.get(d, 0) + 1
            s_srv, d_srv = self.server_of(s), self.server_of(d)
            if s_srv != d_srv:
                key = (min(s_srv, d_srv), max(s_srv, d_srv))
                fibers[key] = fibers.get(key, 0) + 1
        validate_endpoint_limits(tx, rx, banks, wavelengths)
        if check_fibers:
            validate_shared_budget(fibers, self.fibers_per_server_pair,
                                   "servers", "fibers")

    def _validate_round_degraded(self, arr: np.ndarray, banks: int,
                                 wavelengths: int,
                                 check_fibers: bool) -> None:
        """Per-pair dry check against a faulted fabric: each chip's TX/RX
        budget shrinks by its dead TRX lanes, each server pair's fiber
        budget by its dark fibers.  A chip with no healthy lane — or,
        with ``check_fibers``, a pair with no healthy fiber — fails any
        round that touches it."""
        h = self.health
        tx: dict[int, int] = {}
        rx: dict[int, int] = {}
        fibers: dict[tuple[int, int], int] = {}
        for s, d in arr.tolist():
            tx[s] = tx.get(s, 0) + 1
            rx[d] = rx.get(d, 0) + 1
            s_srv, d_srv = self.server_of(s), self.server_of(d)
            if s_srv != d_srv:
                key = (min(s_srv, d_srv), max(s_srv, d_srv))
                fibers[key] = fibers.get(key, 0) + 1
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

    def feasible_round(self, pairs: list[tuple[int, int]],
                       check_fibers: bool = True) -> bool:
        """Boolean form of :meth:`validate_round` for planners that probe
        many candidate rounds (e.g. ``repro_torch.morph`` state-move batching)."""
        try:
            self.validate_round(pairs, check_fibers=check_fibers)
        except CircuitError:
            return False
        return True
