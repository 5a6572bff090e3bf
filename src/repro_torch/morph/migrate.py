"""Morph execution: commit a validated plan against the allocator/rack.

The port's copy of ``repro.morph.migrate``, line for line.

Separating *planning* (`repro_torch.morph.plan`) from *migration* keeps the
invariant layer in one place: every commit re-validates the plan, snapshots
the allocator's chip accounting, applies the reassignment through the
allocator's morph hook, and proves conservation afterwards — a morph is
the first operation in the repo that changes an allocation after
admission, so it gets the paranoid treatment the event engine gives its
own loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.allocator import Allocation, AllocationError, BaseAllocator
from repro_torch.core.cost_model import LinkModel
from repro_torch.core.fabric import LumorphRack
from repro_torch.morph.plan import BYPASS, MorphCost, MorphError, MorphPlan


@dataclasses.dataclass(frozen=True)
class MorphReport:
    """What one committed morph did and what it cost."""

    plan: MorphPlan
    cost: MorphCost
    allocation: Allocation


def check_conservation(allocator: BaseAllocator,
                       extra_chips: int = 0) -> None:
    """Assert allocator-level chip accounting: every chip is allocated to
    exactly one tenant or free (``extra_chips`` covers chips the caller
    knows are dead and tracked outside the allocator)."""
    allocated: set[int] = set()
    total = 0
    for a in allocator.allocations.values():
        s = set(a.chips)
        if s & allocated:
            raise MorphError(f"chips {sorted(s & allocated)} allocated twice")
        allocated |= s
        total += len(s)
    if allocated & allocator.free:
        raise MorphError(
            f"chips {sorted(allocated & allocator.free)} both allocated and free")
    seen = total + len(allocator.free) + extra_chips
    if seen != allocator.n_chips:
        raise MorphError(
            f"conservation violated: {total} allocated + {len(allocator.free)} "
            f"free + {extra_chips} dead != {allocator.n_chips}")


def apply_plan(allocator: BaseAllocator, plan: MorphPlan,
               rack: Optional[LumorphRack] = None,
               dead_chips: int = 0) -> Allocation:
    """Commit ``plan``: validate, reassign the tenant's chips, and prove
    chip conservation before and after.

    For a bypass plan the retired (dead) chips are *removed from the free
    pool* here — they left the slice but must never be handed out again;
    the caller's dead-set bookkeeping is reflected via ``dead_chips``
    (chips already dead before this plan).
    """
    plan.validate(rack)
    current = allocator.allocations.get(plan.tenant)
    if current is None:
        raise MorphError(f"{plan.tenant}: no live allocation to morph")
    if tuple(sorted(current.chips)) != plan.old_chips:
        raise MorphError(
            f"{plan.tenant}: plan is stale — allocation holds "
            f"{current.chips}, plan expected {plan.old_chips}")
    check_conservation(allocator, extra_chips=dead_chips)
    try:
        alloc = allocator.reassign(plan.tenant, plan.new_chips)
    except AllocationError as e:
        raise MorphError(f"{plan.tenant}: cannot commit morph: {e}") from e
    retired = 0
    if plan.kind == BYPASS:
        retired_chips = set(plan.old_chips) - set(plan.new_chips)
        allocator.free -= retired_chips  # dead chips never return to the pool
        retired = len(retired_chips)
    check_conservation(allocator, extra_chips=dead_chips + retired)
    return alloc


def execute(allocator: BaseAllocator, plan: MorphPlan, link: LinkModel,
            rack: Optional[LumorphRack] = None,
            dead_chips: int = 0) -> MorphReport:
    """Price and commit in one call (the standalone-user entry point; the
    rack simulator prices through its own cached pipeline first)."""
    cost = plan.cost(link, rack=rack)
    alloc = apply_plan(allocator, plan, rack=rack, dead_chips=dead_chips)
    return MorphReport(plan=plan, cost=cost, allocation=alloc)
