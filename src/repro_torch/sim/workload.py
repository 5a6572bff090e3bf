"""A tenant's per-step collective mix, as the sharding policy derives it.

The port's copy of ``CollectiveProfile`` from ``repro.sim.workload``: its
fields and its validation, and nothing else of the rack simulator, which
is not on the port's path. ``sharding.policy.collective_profile`` builds
one per model config.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CollectiveProfile:
    """A tenant's per-step collective mix, derived from its model config.

      * ``tp`` — model-parallel degree folded inside the slice.
      * ``buckets`` — per-DP-rank gradient bucket sizes in bytes (already
        divided by the TP sharding; DDP-style size-targeted cuts).
      * ``algos`` — per-bucket algorithm hint from the α–β model at a
        reference width.
      * ``cadence`` — steps between gradient reductions (accumulation).
      * ``tp_bytes`` / ``tp_collectives`` — the per-step activation
        ALLREDUCE stream inside each TP group (Megatron: 2 forward + 2
        backward per TP-sharded block); none where the mixers replicate.
      * ``compute_scale`` — relative per-step compute weight.
    """

    model: str = ""
    tp: int = 1
    buckets: tuple[float, ...] = ()
    algos: tuple[str, ...] = ()
    cadence: int = 1
    tp_bytes: float = 0.0
    tp_collectives: int = 0
    compute_scale: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "buckets", tuple(float(b) for b in self.buckets))
        object.__setattr__(self, "algos", tuple(self.algos))
        if self.tp < 1 or self.cadence < 1:
            raise ValueError(f"profile {self.model!r}: tp and cadence must be ≥ 1")
        if any(b <= 0 for b in self.buckets):
            raise ValueError(f"profile {self.model!r}: bucket sizes must be > 0")
