"""Analytic prefill/decode serving model for one tenant's slice.

The port's copy of ``repro.serve.tenant``, line for line. Its roofline
constants are the reference's (a v5e-class chip), kept so that the
simulated latencies equal the reference's; they are model inputs, not
the H100's.

A serving tenant's chips split into TP-group *replicas* of
``profile.tp`` chips each, partitioned into a **prefill** pool (prompt
processing — compute-bound roofline) and a **decode** pool (token
generation — weight/KV HBM-read bound), the disaggregated-serving
split.  Per-request latency derives from the same primitives the
training simulator prices with:

  * prefill compute at the v5e bf16 roofline, plus the config's TP
    activation-collective stream priced on the replica's *actual chips*
    through the shared :class:`~repro_torch.core.pricing.SchedulePricer`;
  * decode steps at the HBM roofline (per-rank weight read + the
    batch's KV read) plus the TP stream at decode-sized payloads;
  * the prefill→decode **KV-cache handoff** as a Schedule-IR
    ``transfer_schedule`` over the photonic fabric (one wave of
    rank-matched pairs) — affine in bytes for a fixed layout, so the
    engine prices two points per layout and interpolates per request.

Windows aggregate millions of requests, so attainment is computed
analytically: each prefill replica is an M/M/1 queue fed ``λ/R_pf``
(exponential waiting-time tail ``P(W > t) = ρ·e^{-(1-ρ)t/t_pf}``),
decode admission is a utilization bound, and offered load beyond
capacity is counted as SLO-missed.  All latency/throughput numbers are
deterministic functions of the window summary — no per-request events.

Pricing callables are injected (the engine passes closures over its
pricer), so this module stays importable without a rack.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

from repro_torch.sim.workload import CollectiveProfile, LoadWindow, ServeSpec

#: v5e-class roofline constants, the JAX package's (``repro.launch.roofline``),
#: kept so the simulated latencies equal the reference's; the port's own
#: roofline (``repro_torch.launch.roofline``) holds the H100's
PEAK_FLOPS = 197e12  # bf16 FLOP/s per chip
HBM_BW = 819e9  # bytes/s per chip
#: sustained model-FLOPS utilization prefill compute is derated by
MFU = 0.5
#: token count the profile's ``tp_bytes`` activation payload is quoted at
PROFILE_TOKENS = 4096.0

#: price one TP ALLREDUCE of ``n_bytes`` over the replica's chips → seconds
TpPrice = Callable[[float], float]


def granularity(prof: Optional[CollectiveProfile]) -> int:
    """Replica granularity: the TP degree (1 when no profile is given)."""
    return max(1, prof.tp) if prof is not None else 1


@dataclasses.dataclass(frozen=True)
class SlicePrices:
    """Layout-dependent prices, computed once per (re-)slice and reused
    for every window until the chips change."""

    tp_prefill_s: float  # one TP ALLREDUCE at the profile's reference tokens
    tp_decode_s: float  # one TP ALLREDUCE at the decode micro-batch payload
    kv_base_s: float  # KV handoff: affine intercept (α + windows)
    kv_per_byte_s: float  # KV handoff: affine slope (β with time-sharing)

    def kv_time(self, total_bytes: float) -> float:
        """Seconds to hand one request's KV cache (``total_bytes`` across
        all TP ranks) from its prefill replica to its decode replica."""
        if total_bytes <= 0:
            return 0.0
        return self.kv_base_s + self.kv_per_byte_s * total_bytes


@dataclasses.dataclass(frozen=True)
class WindowStats:
    """What one load window did to one tenant (the engine feeds these to
    :meth:`~repro_torch.sim.metrics.SimMetrics.on_serve_window`)."""

    requests: int
    served_frac: float  # fraction of offered requests within capacity
    slo_frac: float  # fraction of offered requests meeting both SLOs
    ttft_p50_s: float
    ttft_p99_s: float
    tpot_s: float  # deterministic decode step time (== TPOT)
    rho_prefill: float
    rho_decode: float
    queue_depth: float  # mean requests waiting for prefill
    kv_bytes: float  # KV handoff bytes shipped this window
    kv_s: float  # handoff seconds summed over served requests
    #: fraction of the window the slice was actually serving (1 − morph /
    #: reconfig loss): ρ·capacity_frac is utilization against *full*
    #: capacity — the load signal a sizing policy should react to
    capacity_frac: float = 1.0
    #: requests still queued when the window closed (the fluid backlog the
    #: next window inherits — overload is carried, not dropped)
    queue_carry: float = 0.0

    @property
    def slo_ok(self) -> float:
        return self.slo_frac * self.requests


# ---------------------------------------------------------------------------
# Per-request primitives
# ---------------------------------------------------------------------------

def prefill_time(spec: ServeSpec, prof: Optional[CollectiveProfile],
                 prompt: float, prices: SlicePrices) -> float:
    """Wall time for one prompt on one prefill replica: compute roofline
    over the replica's ``tp`` chips + the TP activation stream, whose
    collective *count* scales with the prompt (payloads stay at the
    profile's reference size so pricing hits one cache entry per layout)."""
    g = granularity(prof)
    t = prompt * spec.flops_per_token / (g * PEAK_FLOPS * MFU)
    if prof is not None and prof.tp > 1 and prof.tp_collectives:
        t += (prompt / PROFILE_TOKENS) * prof.tp_collectives * prices.tp_prefill_s
    return t


def decode_step_time(spec: ServeSpec, prof: Optional[CollectiveProfile],
                     context: float, prices: SlicePrices) -> float:
    """One decode step of a ``decode_batch`` on one replica: per-rank
    weight read + the batch's KV read (KV is TP-sharded with the heads)
    + the TP stream at decode-sized payloads.  This *is* the TPOT."""
    g = granularity(prof)
    t = spec.weight_bytes / HBM_BW
    t += spec.decode_batch * context * spec.kv_bytes_per_token / (g * HBM_BW)
    if prof is not None and prof.tp > 1 and prof.tp_collectives:
        t += prof.tp_collectives * prices.tp_decode_s
    return t


def request_times(spec: ServeSpec, prof: Optional[CollectiveProfile],
                  prompt: float, output: float,
                  prices: SlicePrices) -> tuple[float, float, float]:
    """``(t_prefill, t_decode_step, t_kv_handoff)`` for the given mean
    prompt/output lengths; the decode step sees the mean context
    ``prompt + output/2`` (the cache grows as the answer streams out)."""
    t_pf = prefill_time(spec, prof, prompt, prices)
    t_step = decode_step_time(spec, prof, prompt + output / 2.0, prices)
    t_kv = prices.kv_time(prompt * spec.kv_bytes_per_token)
    return t_pf, t_step, t_kv


def mean_lengths(spec: ServeSpec) -> tuple[float, float]:
    """Request-weighted mean prompt/output lengths over all windows (the
    structural numbers sizing and the prefill/decode split key on)."""
    total = sum(w.requests for w in spec.windows)
    if not total:
        w = spec.windows[0]
        return w.prompt_tokens, w.output_tokens
    p = sum(w.requests * w.prompt_tokens for w in spec.windows) / total
    o = sum(w.requests * w.output_tokens for w in spec.windows) / total
    return p, o


def split_slice(spec: ServeSpec, prof: Optional[CollectiveProfile],
                n_replicas: int, prices: SlicePrices) -> tuple[int, int]:
    """Partition ``n_replicas`` into (prefill, decode) pools proportional
    to the per-request busy time each phase costs, clamped so both pools
    keep at least one replica.  Keyed on the spec's mean lengths, so the
    split is stable across windows (re-splitting would move KV state)."""
    if n_replicas < 2:
        raise ValueError("disaggregated serving needs ≥ 2 replicas")
    prompt, output = mean_lengths(spec)
    t_pf, t_step, _ = request_times(spec, prof, prompt, output, prices)
    dec_busy = output * t_step / spec.decode_batch  # per-request decode time
    share = t_pf / (t_pf + dec_busy) if t_pf + dec_busy > 0 else 0.5
    n_pf = min(n_replicas - 1, max(1, round(n_replicas * share)))
    return n_pf, n_replicas - n_pf


# ---------------------------------------------------------------------------
# Window model
# ---------------------------------------------------------------------------

#: utilization cap for the *stochastic* M/M/1 tail: above this, the
#: steady-state queue is too large to actually form within one load
#: window — the deterministic fluid backlog (which the window model
#: tracks explicitly, with carryover) takes over as the miss mechanism
_RHO_STOCH_CAP = 0.97


def window_stats(spec: ServeSpec, prof: Optional[CollectiveProfile],
                 w: LoadWindow, n_pf: int, n_dec: int, prices: SlicePrices,
                 lost_s: float = 0.0, q0: float = 0.0) -> WindowStats:
    """Serve one window's offered load from ``n_pf`` prefill and
    ``n_dec`` decode replicas.  ``lost_s`` is capacity time the slice
    spent not serving (morph pauses, reconfiguration) — it shrinks the
    window's effective capacity, so an autoscaler pays for its own
    scaling activity in the very attainment metric it optimizes.

    Queueing is a fluid/stochastic hybrid.  The deterministic backlog
    ``Q(t) = max(0, q0 + (λ−μ)t)`` enters the window as ``q0`` (carried
    from the previous window — overload delays requests, it does not
    drop them) and its endpoint is returned as ``queue_carry``.  A
    request arriving at ``t`` meets the TTFT SLO while ``Q(t)`` stays
    under ``Q* = slack·μ``; on top of that fluid gate, the M/M/1 tail
    (ρ capped at ``_RHO_STOCH_CAP`` — the steady-state queue above that
    cannot form within one window) models stochastic misses.  One
    marginally-overloaded window from an empty queue therefore loses
    only the requests behind the backlog it actually built, while
    *sustained* overload compounds through the carryover to zero."""
    t_pf, t_step, t_kv = request_times(spec, prof, w.prompt_tokens,
                                       w.output_tokens, prices)
    eff = max(w.duration - max(lost_s, 0.0), 1e-9) / w.duration
    lam = w.rate
    rho_pf = (lam * t_pf / (n_pf * eff)) if n_pf else float("inf")
    rho_dec = ((lam * w.output_tokens * t_step
                / (n_dec * spec.decode_batch * eff)) if n_dec else float("inf"))
    rho = max(rho_pf, rho_dec)
    dur = w.duration

    # fluid prefill backlog: arrivals λ against pool service rate μ
    mu = n_pf * eff / t_pf if n_pf and t_pf > 0 else 0.0
    q0 = max(0.0, q0)
    if mu <= 0:
        carry = q0 + lam * dur
    else:
        carry = max(0.0, q0 + (lam - mu) * dur)
    # requests served *this window*: pool capacity net of the inherited
    # backlog, also bounded by the decode roofline
    if lam * dur > 0:
        pf_served = min(1.0, max(0.0, mu * dur - q0) / (lam * dur))
    else:
        pf_served = 1.0
    dec_served = min(1.0, 1.0 / rho_dec) if rho_dec > 0 else 1.0
    served = min(pf_served, dec_served)

    # M/M/1 waiting time at each prefill replica (arrivals split evenly)
    r = min(rho_pf, 0.999)

    def wait_q(q: float) -> float:
        if r <= 0 or r <= 1.0 - q:
            return 0.0
        return t_pf / (1.0 - r) * math.log(r / (1.0 - q))

    def fluid_wait(p: float) -> float:
        """Fluid wait at the p-th arrival quantile: Q is monotone in t,
        so the quantile sits at t = p·dur (growing) or (1−p)·dur."""
        if mu <= 0:
            return dur
        t_at = p * dur if lam >= mu else (1.0 - p) * dur
        return max(0.0, q0 + (lam - mu) * t_at) / mu

    cap = dur  # a wait can't exceed the window it was offered in
    ttft_p50 = min(cap, wait_q(0.50) + fluid_wait(0.50) + t_pf + t_kv)
    ttft_p99 = min(cap, wait_q(0.99) + fluid_wait(0.99) + t_pf + t_kv)
    slack = spec.slo_ttft_s - t_pf - t_kv
    if slack < 0 or mu <= 0:
        ttft_ok = 0.0  # base latency alone violates the SLO
    else:
        # fraction of the window the fluid backlog fits the slack
        q_star = slack * mu
        if lam > mu:
            frac = min(1.0, max(0.0, (q_star - q0) / ((lam - mu) * dur)))
        elif q0 <= q_star:
            frac = 1.0
        elif lam < mu:
            frac = 1.0 - min(1.0, (q0 - q_star) / ((mu - lam) * dur))
        else:
            frac = 0.0
        rs = min(rho_pf, _RHO_STOCH_CAP)
        stoch = 1.0 - rs * math.exp(-(1.0 - rs) * slack / t_pf)
        ttft_ok = frac * stoch
    tpot_ok = 1.0 if t_step <= spec.slo_tpot_s else 0.0
    # carried requests are not dropped, they are late — the backlog gate
    # above already counts them, so attainment does not re-multiply by
    # the served fraction (that would punish each miss twice); decode
    # saturation still gates everything
    slo_frac = min(1.0, dec_served) * ttft_ok * tpot_ok
    queue = (n_pf * r * r / (1.0 - r) if n_pf else 0.0) \
        + (q0 + carry) / 2.0
    n_served = served * w.requests
    kv_bytes = n_served * w.prompt_tokens * spec.kv_bytes_per_token
    return WindowStats(
        requests=w.requests, served_frac=served, slo_frac=slo_frac,
        ttft_p50_s=ttft_p50, ttft_p99_s=ttft_p99, tpot_s=t_step,
        rho_prefill=rho_pf, rho_decode=rho_dec, queue_depth=queue,
        kv_bytes=kv_bytes, kv_s=n_served * t_kv, capacity_frac=eff,
        queue_carry=carry)


def required_replicas(spec: ServeSpec, prof: Optional[CollectiveProfile],
                      prices: SlicePrices, *, rate: float,
                      prompt: Optional[float] = None,
                      output: Optional[float] = None,
                      rho_target: float = 0.7) -> int:
    """Replicas needed to serve ``rate`` requests/s at utilization
    ``rho_target`` (prefill and decode pools sized independently) — the
    sizing primitive shared by the static-provisioning baselines and the
    autoscaler's resize target."""
    if prompt is None or output is None:
        mp, mo = mean_lengths(spec)
        prompt = mp if prompt is None else prompt
        output = mo if output is None else output
    t_pf, t_step, _ = request_times(spec, prof, prompt, output, prices)
    n_pf = max(1, math.ceil(rate * t_pf / rho_target))
    n_dec = max(1, math.ceil(rate * output * t_step
                             / (spec.decode_batch * rho_target)))
    return n_pf + n_dec
