"""Multi-tenant compute allocation on a rack (paper §3, Fig 2a).

The port's copy of ``repro.core.allocator``.

Compares three allocation disciplines over the same physical rack:

  * **LUMORPH** — any free subset of chips can serve any tenant, because the
    photonic fabric establishes direct circuits between arbitrary chips.
    Placement is a pure packing heuristic (densest-server-first) to conserve
    inter-server fibers; it can never *reject* a request that fits in the
    free count.  This is the paper's fragmentation-free property.
  * **Torus slices** (TPUv4-style) — chips form a 3D torus; a tenant gets an
    axis-aligned sub-box.  Requests that are not expressible as a free
    sub-box are rejected even when enough chips are free → fragmentation.
  * **SiPAC blocks** — chips are statically grouped into BCube-style groups
    of size r^ℓ; tenants get aligned power-of-r subgroups.

The elastic runtime (``repro_torch.runtime``) re-allocates a tenant through the
same interface after chip failures: with LUMORPH, surviving free chips are
always usable, so recovery never strands capacity.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

from repro_torch.core.policy import FabricGeometry, make_policy, pack_dense
from repro_torch.core.rack import group_by_rack


@dataclasses.dataclass
class Allocation:
    tenant: str
    chips: tuple[int, ...]
    requested: int

    @property
    def overallocated(self) -> int:
        return len(self.chips) - self.requested


class AllocationError(RuntimeError):
    pass


class BaseAllocator:
    """Common free-set bookkeeping."""

    def __init__(self, n_chips: int):
        self.n_chips = n_chips
        self.free: set[int] = set(range(n_chips))
        self.allocations: dict[str, Allocation] = {}
        self.retired: set[int] = set()  # chips failed out of the pool

    # -- interface -----------------------------------------------------------
    def allocate(self, tenant: str, k: int) -> Allocation:
        raise NotImplementedError

    def _check_request(self, tenant: str, k: int) -> None:
        """Shared admission validation (every ``allocate`` calls this):
        nonsense widths are a caller bug → ``ValueError``; capacity
        shortfalls are a legitimate reject → ``AllocationError``."""
        if k <= 0:
            raise ValueError("k must be positive")
        if k > len(self.free):
            raise AllocationError(
                f"{tenant}: want {k}, only {len(self.free)} chips free")

    def release(self, tenant: str) -> None:
        a = self.allocations.pop(tenant, None)
        if a is None:
            raise AllocationError(f"unknown tenant {tenant!r}: nothing to release")
        self.free.update(a.chips)

    def reassign(self, tenant: str, new_chips: Sequence[int]) -> Allocation:
        """Morph hook: atomically swap a tenant's chip set for ``new_chips``.

        ``new_chips`` may only draw on the tenant's current chips and the
        free pool; chips it no longer uses return to the free pool, so
        rack-wide chip accounting is invariant under a reassignment.
        Compaction plans are 1:1 remaps; a partial failure bypass may
        shrink the slice by the dead chips it could not replace (the
        caller retires those from the pool).
        """
        a = self.allocations.get(tenant)
        if a is None:
            raise AllocationError(f"unknown tenant {tenant!r}: nothing to reassign")
        new = set(new_chips)
        old = set(a.chips)
        if not new:
            raise AllocationError(f"{tenant}: reassignment must keep ≥ 1 chip")
        if len(new) != len(new_chips):
            raise AllocationError(f"{tenant}: duplicate chips in reassignment")
        entering = new - old
        if not entering <= self.free:
            taken = sorted(entering - self.free)
            raise AllocationError(f"{tenant}: chips {taken} are not free")
        self.free -= entering
        self.free |= old - new
        replacement = Allocation(tenant, tuple(sorted(new)), a.requested)
        self.allocations[tenant] = replacement
        return replacement

    def fail_chips(self, chips: Sequence[int]) -> list[str]:
        """Mark chips dead; return tenants that lost capacity."""
        dead = set(chips)
        self.free -= dead
        self.retired.update(c for c in dead if 0 <= c < self.n_chips)
        hit = []
        for t, a in list(self.allocations.items()):
            if dead & set(a.chips):
                hit.append(t)
                # surviving chips return to the free pool; tenant must re-allocate
                self.free.update(set(a.chips) - dead)
                del self.allocations[t]
        return hit

    @property
    def live_chips(self) -> int:
        """Chips still in service (never-failed): the utilization base."""
        return self.n_chips - len(self.retired)

    @property
    def utilization(self) -> float:
        used = sum(len(a.chips) for a in self.allocations.values())
        return used / self.live_chips if self.live_chips else 0.0

    def _commit(self, tenant: str, chips: Sequence[int], requested: int) -> Allocation:
        chips = tuple(sorted(chips))
        assert set(chips) <= self.free, "allocator bug: chips not free"
        self.free -= set(chips)
        a = Allocation(tenant, chips, requested)
        self.allocations[tenant] = a
        return a


class LumorphAllocator(BaseAllocator):
    """Fragmentation-free: any ``k`` free chips form a valid slice.

    *Which* free chips a tenant gets is the :class:`PlacementPolicy`'s
    call (``repro_torch.core.policy``); the default ``packing`` policy is the
    legacy densest-server-first heuristic, bit-identically.
    """

    def __init__(self, n_chips: int, tiles_per_server: int = 8,
                 policy=None):
        super().__init__(n_chips)
        self.tiles_per_server = tiles_per_server
        self.policy = make_policy(policy)

    @property
    def geometry(self) -> FabricGeometry:
        return FabricGeometry(tiles_per_server=self.tiles_per_server)

    def _pack(self, candidates: Sequence[int], k: int) -> list[int]:
        """Densest-server-first packing (kept as a shim for callers; the
        heuristic itself lives in ``repro_torch.core.policy.pack_dense``)."""
        return pack_dense(candidates, k, self.tiles_per_server)

    def whatif(self, k: int, coll_bytes=None):
        """What-if admission for a ``k``-chip tenant against the current
        free pool — priced, not committed (``repro_torch.core.policy``)."""
        return self.policy.whatif(self.free, k, self.geometry, coll_bytes)

    def allocate(self, tenant: str, k: int) -> Allocation:
        self._check_request(tenant, k)
        chips = self.policy.place(self.free, k, self.geometry)
        assert chips is not None, "fragmentation-free fabric rejected a fit"
        return self._commit(tenant, chips, k)


class PodAllocator(LumorphAllocator):
    """Pod-aware fragmentation-free allocation: rack-first placement.

    A tenant that fits in one rack never crosses a rail: among racks with
    enough free chips, the *best-fit* rack (fewest free chips ≥ k) takes
    it, preserving the larger holes for future pod-scale tenants.  A
    tenant wider than any single rack's free set spans the minimal number
    of racks; when its size divides evenly across them, each spanned rack
    gets an equal share — the shard-alignment condition under which the
    hierarchical collective (``scheduler.compose_hierarchical``) is
    admissible, so spanning tenants pay the rail tier as one inter-rack
    stage instead of rail-bottlenecked flat rounds.  Within every rack
    the densest-server-first packing applies unchanged.

    ``span_racks=False`` confines every tenant to a single rack — the
    isolated-racks baseline the pod benchmarks compare against.
    """

    def __init__(self, n_chips: int, chips_per_rack: int,
                 tiles_per_server: int = 8, span_racks: bool = True,
                 policy=None):
        super().__init__(n_chips, tiles_per_server, policy=policy)
        if n_chips % chips_per_rack:
            raise ValueError(
                f"n_chips {n_chips} not a multiple of chips_per_rack {chips_per_rack}")
        self.chips_per_rack = chips_per_rack
        self.span_racks = span_racks

    @property
    def geometry(self) -> FabricGeometry:
        return FabricGeometry(tiles_per_server=self.tiles_per_server,
                              chips_per_rack=self.chips_per_rack,
                              span_racks=self.span_racks)

    def allocate(self, tenant: str, k: int) -> Allocation:
        self._check_request(tenant, k)
        chips = self.policy.place(self.free, k, self.geometry)
        if chips is None:  # rack-confined pod: no single-rack fit
            raise AllocationError(
                f"{tenant}: want {k}, no single rack has that many free "
                f"(rack-confined pod)")
        return self._commit(tenant, chips, k)


class TorusAllocator(BaseAllocator):
    """TPUv4-style: tenants get axis-aligned sub-boxes of a 3D torus."""

    def __init__(self, dims: tuple[int, int, int]):
        super().__init__(dims[0] * dims[1] * dims[2])
        self.dims = dims

    def _chip(self, x: int, y: int, z: int) -> int:
        X, Y, Z = self.dims
        return (x % X) * Y * Z + (y % Y) * Z + (z % Z)

    def _boxes(self, k: int):
        """Box shapes with volume ≥ k (smallest volume first, pow-2 dims)."""
        X, Y, Z = self.dims
        pows = lambda n: [d for d in (1, 2, 4, 8, 16, 32) if d <= n]
        shapes = {(a, b, c) for a in pows(X) for b in pows(Y) for c in pows(Z)
                  if a * b * c >= k}
        return sorted(shapes, key=lambda s: (s[0] * s[1] * s[2], s))

    def allocate(self, tenant: str, k: int) -> Allocation:
        self._check_request(tenant, k)
        X, Y, Z = self.dims
        for (a, b, c) in self._boxes(k):
            for ox, oy, oz in itertools.product(range(X), range(Y), range(Z)):
                # aligned placements only (slice origins on multiples of shape)
                if ox % a or oy % b or oz % c:
                    continue
                chips = [self._chip(ox + i, oy + j, oz + l)
                         for i in range(a) for j in range(b) for l in range(c)]
                if set(chips) <= self.free:
                    return self._commit(tenant, chips, k)
        raise AllocationError(
            f"{tenant}: no free {k}-chip torus slice (fragmentation: "
            f"{len(self.free)} chips free)")


class SipacAllocator(BaseAllocator):
    """SiPAC(r,ℓ)-style: rack pre-partitioned into BCube groups of r^ℓ chips;
    tenants get aligned power-of-r subgroups."""

    def __init__(self, n_chips: int, r: int = 2, ell: int = 3):
        super().__init__(n_chips)
        self.r, self.ell = r, ell
        self.group = r ** ell
        if n_chips % self.group:
            raise ValueError(f"n_chips {n_chips} not a multiple of group {self.group}")

    def allocate(self, tenant: str, k: int) -> Allocation:
        self._check_request(tenant, k)
        # round up to the nearest power of r, capped at the group size
        size = 1
        while size < min(k, self.group):
            size *= self.r
        if k > self.group:
            # multi-group tenants take whole groups
            n_groups = math.ceil(k / self.group)
            got = []
            for g in range(self.n_chips // self.group):
                chips = range(g * self.group, (g + 1) * self.group)
                if set(chips) <= self.free:
                    got.append(list(chips))
                if len(got) == n_groups:
                    return self._commit(tenant, [c for grp in got for c in grp], k)
            raise AllocationError(f"{tenant}: need {n_groups} whole groups")
        for g in range(self.n_chips // self.group):
            base = g * self.group
            for off in range(0, self.group, size):
                chips = range(base + off, base + off + size)
                if set(chips) <= self.free:
                    return self._commit(tenant, list(chips), k)
        raise AllocationError(
            f"{tenant}: no aligned {size}-chip subgroup free (fragmentation)")


def make_allocator(kind: str, n_chips: int, **kw) -> BaseAllocator:
    if kind == "lumorph":
        return LumorphAllocator(n_chips, **kw)
    if kind == "pod":
        return PodAllocator(n_chips, **kw)
    if kind == "torus":
        dims = kw.pop("dims", None)
        if dims is None:
            # factor n_chips into 3 near-equal pow-2-friendly dims
            dims = _default_dims(n_chips)
        return TorusAllocator(dims)
    if kind == "sipac":
        return SipacAllocator(n_chips, **kw)
    raise ValueError(f"unknown allocator kind {kind!r}")


def _default_dims(n: int) -> tuple[int, int, int]:
    best = None
    for a in range(1, n + 1):
        if n % a:
            continue
        for b in range(a, n // a + 1):
            if (n // a) % b:
                continue
            c = n // a // b
            if c < b:
                continue
            cand = (a, b, c)
            score = c - a  # prefer near-cubic
            if best is None or score < best[0]:
                best = (score, cand)
    assert best is not None
    return best[1]
