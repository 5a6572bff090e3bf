"""SLO-driven autoscaling policy for serving tenants.

The port's copy of ``repro.serve.autoscale``, line for line.

The autoscaler is *reactive*: after each load window it reads the
tenant's measured :class:`~repro_torch.serve.tenant.WindowStats` and decides
the replica count for the next window.  The engine executes decisions
as priced, invariant-checked morph plans
(:func:`repro_torch.morph.plan.plan_scale_up` /
:func:`~repro_torch.morph.plan.plan_scale_down`): scale-up admission runs the
what-if pricing through the shared
:class:`~repro_torch.core.pricing.SchedulePricer` (never grow into a layout
the fabric cannot serve), scale-down drains in-flight KV state to the
surviving replicas and returns the chips to the pool.

The policy itself is deliberately simple and, crucially, *lean*: it
targets ``headroom`` utilization (default 0.9) where an a-priori static
provisioner must leave slack for traffic it cannot foresee — that
asymmetry, plus shrinking to the floor in traffic troughs, is where the
chip-hour savings in the JAX package's ``benchmarks/sim_serve.py`` come from.

Guard rails:

  * scale up only when more replicas can actually help — high
    utilization, or SLO misses at non-trivial load (a TPOT violation at
    ρ≈0 means the *model* is too slow for the SLO at this TP degree;
    growing the pool would burn chips without fixing it);
  * scale down whenever *smoothed* load says the slice is oversized,
    but only after ``down_windows`` consecutive such windows
    (hysteresis — a single quiet window must not flap the slice) and
    never while utilization is *rising* (a diurnal ramp looks calm
    right up to the window where it isn't); deep calm (a burst that
    ended, a trough arriving) sheds immediately;
  * never below two replicas (one prefill + one decode: the
    disaggregation floor) and at most ``max_step_up`` replicas per
    decision (one morph's worth of state replay).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.serve.tenant import WindowStats


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Knobs for the reactive serving autoscaler."""

    #: grow whenever the window's SLO attainment fell below this
    target_attainment: float = 0.98
    #: grow whenever utilization exceeded this (pre-emptive: queues build
    #: fast above it even before attainment visibly dips)
    rho_high: float = 0.85
    #: below half of this, a window is *deep* calm and sheds immediately
    rho_low: float = 0.65
    #: consecutive calm windows required before shrinking
    down_windows: int = 2
    #: utilization the resize aims at (lean by design — see module doc)
    headroom: float = 0.9
    #: utilization a *shrink* aims at — deliberately cooler than
    #: ``headroom``: a shed sized right up to the growth trigger bounces
    #: straight back on the first noisy window
    shrink_headroom: float = 0.75
    #: max replicas added per decision
    max_step_up: int = 4
    #: smallest slice: one prefill + one decode replica
    min_replicas: int = 2


class Autoscaler:
    """Pure decision function + per-call hysteresis threading (the engine
    keeps each tenant's calm-window counter, so one Autoscaler instance
    serves every tenant deterministically)."""

    def __init__(self, config: AutoscaleConfig | None = None):
        self.config = config or AutoscaleConfig()

    def decide(self, n_replicas: int, stats: WindowStats,
               calm_windows: int,
               prev_rho: float | None = None) -> tuple[int, int]:
        """→ ``(desired_replicas, updated_calm_counter)`` for the next
        window, given the window that just finished on ``n_replicas``
        (and, when known, the utilization of the window before it)."""
        cfg = self.config
        # size against *full* capacity: the measured ρ is inflated by the
        # window's morph/reconfig loss, and reacting to that transient is
        # how an autoscaler panics over its own scaling activity
        rho = max(stats.rho_prefill, stats.rho_decode) * stats.capacity_frac
        if not math.isfinite(rho):
            rho = 2.0  # a missing pool is unbounded overload
        # two-window smoothing: ±20 % token-length jitter plus the
        # prefill/decode split quantization make single-window ρ swing
        # ~40 % at constant offered load, and a tracker that believes
        # every swing ratchets up to the *noise ceiling* instead of the
        # mean.  Overload and SLO misses below bypass the smoothing —
        # a caught-behind window is never noise
        rho_s = rho if prev_rho is None else (rho + prev_rho) / 2.0
        misses = stats.slo_frac < cfg.target_attainment
        if rho >= 1.0 or (misses and rho > 0.5):
            need = max(n_replicas + 1,
                       math.ceil(n_replicas * rho / cfg.headroom))
            return min(need, n_replicas + cfg.max_step_up), 0
        # additive trend on the smoothed level: a ramp raises level *and*
        # slope, a noise spike only the level — projecting ρ_s + Δ/2
        # follows the former one window ahead and shrugs off the latter
        # (a multiplicative trend on raw ρ does the opposite: it turns a
        # single jittery window into a 1.5× panic buy)
        delta = max(0.0, rho - prev_rho) if prev_rho is not None else 0.0
        proj = rho_s + delta / 2.0
        if proj > cfg.rho_high:
            need = max(n_replicas + 1,
                       math.ceil(n_replicas * proj / cfg.headroom))
            return min(need, n_replicas + cfg.max_step_up), 0

        # shed whenever the smoothed load says the slice is oversized —
        # gating on an absolute "calm" threshold instead leaves a dead
        # zone (too warm to shed, too cool to matter) where a diurnal
        # crest parks 25 % excess capacity for hours
        want = max(cfg.min_replicas,
                   math.ceil(n_replicas * rho_s / cfg.shrink_headroom),
                   # shed at most half per step — one scale-up undoes an
                   # over-shrink, but a cliff-edge shed risks a
                   # caught-behind window first
                   -(-n_replicas // 2))
        if want >= n_replicas:
            return n_replicas, 0
        if rho_s < cfg.rho_low / 2:
            # deep calm is not noise — it is a burst that ended or a
            # trough arriving; hysteresis here only buys idle windows
            return want, 0
        # a calm window on a rising ramp is not calm: shrinking here is
        # how an autoscaler walks into the very peak it exists to absorb
        rising = (prev_rho is not None
                  and rho > prev_rho + 0.05 and rho > prev_rho * 1.2)
        if rising:
            return n_replicas, 0
        calm_windows += 1
        # on a small slice a ±1-replica shed is a ≥ 25 % capacity swing
        # that flaps straight back, so require the move to be either
        # coarse-worthy or fine-grained relative to the slice
        if calm_windows >= cfg.down_windows and \
                (n_replicas - want >= 2 or n_replicas >= 6):
            return want, 0
        return n_replicas, calm_windows
