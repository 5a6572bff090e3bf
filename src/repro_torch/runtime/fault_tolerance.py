"""Fault tolerance & elasticity: failure simulation, restart policy,
straggler mitigation — built around the LUMORPH allocator.

The port's copy of ``repro.runtime.fault_tolerance``, line for line,
the morph failure bypass and ``straggler_to_degrade`` included.

The paper's fragmentation-free property is exactly what makes recovery
cheap: when chips die, *any* surviving free chips can rebuild the slice
(torus/SiPAC racks must find an aligned block and usually cannot).
``ElasticTrainer`` demonstrates the full loop:

  fail chips → allocator re-allocates from survivors → data-parallel width
  shrinks to the largest power-of-two ≤ new slice (keeping LUMORPH-2/4
  optimal) → restore latest checkpoint onto the shrunk mesh → continue.

With ``allow_bypass=True`` the restart is preceded by a cheaper attempt:
a :mod:`repro_torch.morph` **failure bypass** swaps a free chip into the slice
and replays the lost shard from a surviving peer — full width survives
and no checkpoint restore is needed; the shrink path remains the
fallback when the rack has no spare chip.

Straggler mitigation operates at two levels.  At the training-step
level we model the standard backup-step rule (re-dispatch when a shard
exceeds ``straggler_factor ×`` median step time,
:meth:`StragglerPolicy.mitigated_step_time`).  At the circuit level a
persistently slow chip is a *degraded link* — the same thing as a
BER-derated transceiver from the fabric's point of view — so
:func:`straggler_to_degrade` converts detected stragglers into
``kind="degrade"`` fault events the rack simulator applies through its
:class:`~repro_torch.core.health.FabricHealth` state: every collective that
chip joins is re-priced with the derate (the slowest circuit paces the
round), and spare wavelengths absorb part of the slowdown
(:meth:`StragglerPolicy.mitigated_derate`).  Repair events model the
chip recovering (thermal throttle lifting, laser re-locking).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.allocator import AllocationError, LumorphAllocator
from repro_torch.core.cost_model import LUMORPH_LINK, LinkModel, algorithm_cost


@dataclasses.dataclass
class FailureEvent:
    step: int
    chips: tuple[int, ...]


@dataclasses.dataclass
class RecoveryRecord:
    step: int
    failed: tuple[int, ...]
    old_slice: tuple[int, ...]
    new_slice: Optional[tuple[int, ...]]
    new_dp: int
    recovered: bool
    reason: str = ""


def largest_pow2_leq(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n > 0 else 0


def reallocate_after_failure(allocator, tenant: str, requested: int):
    """Shrinking re-allocation policy shared by ElasticJob and the rack
    simulator: try the full request, then fall back through powers of two
    (keeping LUMORPH-2/4 on their optimal path).  Returns the new
    ``Allocation`` or ``None`` when the rack is exhausted."""
    want = requested
    while want >= 1:
        try:
            return allocator.allocate(tenant, want)
        except AllocationError:
            want = largest_pow2_leq(want - 1) if want > 1 else 0
    return None


def bypass_failure(allocator, tenant: str, dead: Sequence[int],
                   tiles_per_server: Optional[int] = None,
                   state_bytes: float = float(4 << 20)):
    """Morph-based alternative to the elastic restart: swap free chips in
    for ``tenant``'s dead ones and replay the lost shards from surviving
    peers (`repro_torch.morph.plan_bypass`), keeping the slice at full width.

    Must run *before* the allocator is told about the failure (the plan
    needs the victim's allocation intact).  Returns the new ``Allocation``
    or ``None`` when no bypass is feasible — callers then fall back to
    ``fail_chips`` + :func:`reallocate_after_failure`."""
    from repro_torch.morph import apply_plan, plan_bypass  # deferred: keep the
    # runtime importable without pulling the whole morph planner in
    a = allocator.allocations.get(tenant)
    if a is None:
        return None
    if tiles_per_server is None:
        # follow the allocator's server geometry (LUMORPH default: 8)
        tiles_per_server = getattr(allocator, "tiles_per_server", 8)
    free = set(allocator.free) - set(dead)
    plan = plan_bypass(tenant, a.chips, dead, free, tiles_per_server,
                       state_bytes)
    if plan is None:
        return None
    dead_outside = allocator.n_chips - len(allocator.free) - sum(
        len(x.chips) for x in allocator.allocations.values())
    return apply_plan(allocator, plan, dead_chips=dead_outside)


class ElasticJob:
    """One tenant's training job on a LUMORPH rack, with failure recovery."""

    def __init__(self, allocator: LumorphAllocator, tenant: str, n_chips: int):
        self.allocator = allocator
        self.tenant = tenant
        self.requested = n_chips
        alloc = allocator.allocate(tenant, n_chips)
        self.chips = alloc.chips
        self.history: list[RecoveryRecord] = []

    @property
    def dp_width(self) -> int:
        """Power-of-two DP width (keeps LUMORPH-2/4 on their optimal path)."""
        return largest_pow2_leq(len(self.chips))

    def on_failure(self, step: int, failed_chips: Sequence[int],
                   allow_bypass: bool = False) -> RecoveryRecord:
        """Handle chip failures: re-allocate from survivors, shrinking if the
        rack can't supply a full replacement.  With ``allow_bypass``, first
        try a live morph that swaps spare chips in at full width."""
        dead = set(failed_chips) & set(self.chips)
        if not dead:
            rec = RecoveryRecord(step, tuple(failed_chips), self.chips,
                                 self.chips, self.dp_width, True, "unaffected")
            self.history.append(rec)
            return rec
        old = self.chips
        if allow_bypass:
            alloc = bypass_failure(self.allocator, self.tenant, sorted(dead))
            if alloc is not None:
                self.chips = alloc.chips
                rec = RecoveryRecord(step, tuple(sorted(dead)), old, self.chips,
                                     self.dp_width, True, "bypassed")
                self.history.append(rec)
                return rec
        self.allocator.fail_chips(list(dead))  # releases survivors to the pool
        alloc = reallocate_after_failure(self.allocator, self.tenant, self.requested)
        if alloc is not None:
            self.chips = alloc.chips
            got = len(alloc.chips)
            rec = RecoveryRecord(step, tuple(dead), old, self.chips,
                                 self.dp_width, True,
                                 "full" if got >= self.requested else f"shrunk to {got}")
            self.history.append(rec)
            return rec
        rec = RecoveryRecord(step, tuple(dead), old, None, 0, False, "rack exhausted")
        self.history.append(rec)
        return rec


@dataclasses.dataclass
class StragglerPolicy:
    straggler_factor: float = 2.0  # backup-step threshold × median
    spare_wavelengths: int = 2     # per tile, reserved for re-routing

    def detect(self, shard_times: np.ndarray) -> np.ndarray:
        med = np.median(shard_times)
        return shard_times > self.straggler_factor * med

    def mitigated_step_time(self, shard_times: np.ndarray) -> float:
        """Step time with backup re-dispatch: stragglers' work is re-issued
        to the fastest shards at the threshold point."""
        med = float(np.median(shard_times))
        cap = self.straggler_factor * med
        slow = shard_times > cap
        if not slow.any():
            return float(shard_times.max())
        # re-dispatched work finishes one median step after the threshold
        return float(max(shard_times[~slow].max(), cap + med))

    def mitigated_derate(self, raw_factor: float) -> float:
        """The β derate a straggler's circuits carry *after* re-routing
        part of its traffic through the tile's spare wavelengths: the
        slowdown above 1 is spread over the original lane plus the
        spares, so a chip running ``raw_factor×`` slow degrades its
        rounds by only ``1 + (raw_factor − 1)/(1 + spare_wavelengths)``.
        Always ≥ 1 and ≤ ``raw_factor``."""
        if raw_factor <= 1.0:
            return 1.0
        return 1.0 + (raw_factor - 1.0) / (1.0 + self.spare_wavelengths)


def straggler_to_degrade(time: float, chip_ids: Sequence[int],
                         shard_times: np.ndarray,
                         policy: Optional[StragglerPolicy] = None):
    """Convert one step's straggler detection into fabric ``degrade``
    fault events the rack simulator replays through its health state
    (one :class:`~repro_torch.sim.workload.FailureSpec` per slow chip, derated
    by :meth:`StragglerPolicy.mitigated_derate`).  ``chip_ids[i]`` owns
    ``shard_times[i]``.  Returns ``[]`` when no shard crosses the
    backup-step threshold."""
    from repro_torch.sim.workload import FailureSpec  # deferred: runtime must
    # stay importable without the simulator package
    policy = policy or StragglerPolicy()
    shard_times = np.asarray(shard_times, dtype=float)
    med = float(np.median(shard_times))
    if med <= 0:
        return []
    out = []
    slow_mask = policy.detect(shard_times)
    for i, chip in enumerate(chip_ids):
        if not slow_mask[i]:
            continue
        factor = policy.mitigated_derate(float(shard_times[i]) / med)
        if factor > 1.0:
            out.append(FailureSpec(time, (int(chip),), kind="degrade",
                                   derate=factor))
    return out


def simulate_failures(n_steps: int, n_chips: int, mtbf_steps: float,
                      seed: int = 0) -> list[FailureEvent]:
    """Poisson chip failures: each step each chip dies w.p. 1/mtbf."""
    rng = np.random.RandomState(seed)
    events = []
    for step in range(n_steps):
        dead = np.nonzero(rng.random(n_chips) < 1.0 / mtbf_steps)[0]
        if dead.size:
            events.append(FailureEvent(step, tuple(int(d) for d in dead)))
    return events


def recovery_cost_model(n_params: int, dp: int, link: LinkModel = LUMORPH_LINK,
                        ckpt_read_bw: float = 2e9) -> dict:
    """Seconds to recover: checkpoint read + parameter broadcast.

    Broadcast of restored params to the (new) dp group is one all-gather-
    class transfer — priced with the same α–β machinery as training
    collectives."""
    bytes_params = 4 * n_params
    read_s = bytes_params / ckpt_read_bw
    bcast_s = algorithm_cost("lumorph2", bytes_params, max(dp, 2), link)
    return {"read_s": read_s, "broadcast_s": bcast_s, "total_s": read_s + bcast_s}
