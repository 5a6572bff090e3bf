"""`repro_torch.morph` — online slice morphing for the LUMORPH rack.

The port's copy of ``repro.morph``, with the same exports.

The allocator makes admission fragmentation-free; this package keeps the
rack fragmentation-free *over time*: it plans, prices, validates, and
commits live slice transformations (photonic defragmentation, locality
compaction, failure bypass) under running tenants, exploiting the
fabric's 3.7 µs MZI reprogramming and Schedule-IR state transfers.

  * :mod:`repro_torch.morph.plan` — plan construction + the morph invariants
    (chip conservation, disjoint state moves, TRX feasibility of every
    wave, state never lost).
  * :mod:`repro_torch.morph.migrate` — committing a plan against an allocator
    with conservation proofs before and after.
  * :mod:`repro_torch.morph.policy` — when to morph: strict-gain + amortization
    tests for compaction, feasibility for failure bypass.
"""

from repro_torch.morph.migrate import (MorphReport, apply_plan, check_conservation,
                                 execute)
from repro_torch.morph.plan import (BYPASS, COMPACTION, SCALE_DOWN, SCALE_UP,
                              MorphCost, MorphError, MorphPlan, pack_layout,
                              plan_bypass, plan_compaction, plan_scale_down,
                              plan_scale_up)
from repro_torch.core.policy import (FutureMorphObjective, LocalityObjective,
                               MorphObjective)
from repro_torch.morph.policy import MorphConfig, MorphPolicy, PricedMorph

__all__ = [
    "BYPASS", "COMPACTION", "SCALE_DOWN", "SCALE_UP", "MorphCost",
    "MorphError", "MorphPlan", "pack_layout", "plan_bypass",
    "plan_compaction", "plan_scale_down", "plan_scale_up",
    "MorphReport", "apply_plan", "check_conservation", "execute",
    "MorphConfig", "MorphObjective", "LocalityObjective",
    "FutureMorphObjective", "MorphPolicy", "PricedMorph",
]
