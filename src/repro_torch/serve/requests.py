"""Request-scale serving workload generators.

The port's copy of ``repro.serve.requests``, line for line; the
config-accurate spec reads the port's ``sharding.policy.collective_profile``.

Production inference traffic arrives as *millions of requests*; the
event engine stays tractable because generators aggregate them into
per-window :class:`~repro_torch.sim.workload.LoadWindow` summaries (arrival
count + mean prompt/output lengths) that the analytic queueing model in
:mod:`repro_torch.serve.tenant` consumes.  Two arrival processes:

  * **diurnal** — a day-shaped sinusoid between base and peak rate
    (trough at t=0), per-window Poisson counts, the workload an
    autoscaler should track smoothly;
  * **bursty** — the same diurnal carrier with a Markov-modulated flash
    crowd riding it: burst windows multiply the carrier by
    ``burst_mult`` (mean burst length ``mean_burst_windows``), the
    workload that punishes slow reaction and static mean-provisioning
    alike.

Spec derivation has two fidelity tiers:

  * :func:`serving_spec` reads a real :class:`~repro_torch.configs.base.ModelConfig`
    (exact active-param FLOPs, per-rank weight bytes, per-block KV
    layout including MLA compression and SSM constant state);
  * :func:`serving_spec_from_profile` reconstructs the same numbers from
    a :class:`~repro_torch.sim.workload.CollectiveProfile` alone — approximate
    (documented inline), but importable in sweep worker processes that
    must not touch ``configs/`` or torch.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.sim.workload import (CollectiveProfile, JobSpec, LoadWindow,
                                ServeSpec, Trace)

#: dtype bytes for weights and KV (bf16 serving)
_DTYPE = 2.0

#: token count CollectiveProfile.tp_bytes is quoted at (keep in sync with
#: repro_torch.sharding.policy.PROFILE_TOKENS_PER_STEP without importing it —
#: sweep workers must not pull the torch-facing sharding stack)
PROFILE_REF_TOKENS = 4096.0


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------

def _jittered(rng, mean: float) -> float:
    """Per-window mean length: ±20 % uniform jitter around the mix mean."""
    return round(mean * float(rng.uniform(0.8, 1.2)), 1)


def diurnal_windows(*, horizon_s: float, window_s: float, base_rate: float,
                    peak_rate: float, prompt_tokens: float,
                    output_tokens: float, seed: int = 0, phase: float = 0.0,
                    day_s: Optional[float] = None) -> tuple[LoadWindow, ...]:
    """Day-shaped offered load: the rate sweeps ``base → peak → base``
    sinusoidally over ``day_s`` (default: the whole horizon is one day),
    shifted by ``phase`` radians so co-hosted tenants can peak at
    different times; window request counts are Poisson draws."""
    rng = np.random.RandomState(seed)
    day = day_s if day_s is not None else horizon_s
    out: list[LoadWindow] = []
    t = 0.0
    while t < horizon_s - 1e-9:
        dur = min(window_s, horizon_s - t)
        x = (1.0 - math.cos(2.0 * math.pi * ((t + dur / 2) / day) + phase)) / 2
        rate = base_rate + (peak_rate - base_rate) * x
        out.append(LoadWindow(
            start=t, duration=dur, requests=int(rng.poisson(rate * dur)),
            prompt_tokens=_jittered(rng, prompt_tokens),
            output_tokens=_jittered(rng, output_tokens)))
        t += dur
    return tuple(out)


def bursty_windows(*, horizon_s: float, window_s: float, base_rate: float,
                   peak_rate: Optional[float] = None, burst_mult: float = 2.0,
                   prompt_tokens: float, output_tokens: float, seed: int = 0,
                   phase: float = 0.0, day_s: Optional[float] = None,
                   p_burst: float = 1.0 / 24.0,
                   mean_burst_windows: float = 8.0) -> tuple[LoadWindow, ...]:
    """Flash crowds riding the daily cycle: the carrier rate follows the
    same diurnal sweep as :func:`diurnal_windows` (flat at ``base_rate``
    when ``peak_rate`` is omitted), and a Markov burst state multiplies
    it by ``burst_mult`` — calm windows enter a burst with probability
    ``p_burst``, bursts end with probability ``1/mean_burst_windows``
    per window, so a typical burst spans several windows, long enough
    for a reactive autoscaler to catch most of it.  Each burst builds
    through one window at the midpoint multiplier first: flash crowds
    ramp over minutes, they do not step instantaneously."""
    rng = np.random.RandomState(seed)
    peak = peak_rate if peak_rate is not None else base_rate
    day = day_s if day_s is not None else horizon_s
    out: list[LoadWindow] = []
    state = "calm"
    t = 0.0
    while t < horizon_s - 1e-9:
        dur = min(window_s, horizon_s - t)
        if state == "burst":
            if float(rng.uniform()) < 1.0 / mean_burst_windows:
                state = "calm"
        elif state == "ramp":
            state = "burst"
        elif float(rng.uniform()) < p_burst:
            state = "ramp"
        x = (1.0 - math.cos(2.0 * math.pi * ((t + dur / 2) / day) + phase)) / 2
        carrier = base_rate + (peak - base_rate) * x
        mult = {"calm": 1.0, "burst": burst_mult,
                "ramp": (1.0 + burst_mult) / 2.0}[state]
        rate = carrier * mult
        out.append(LoadWindow(
            start=t, duration=dur, requests=int(rng.poisson(rate * dur)),
            prompt_tokens=_jittered(rng, prompt_tokens),
            output_tokens=_jittered(rng, output_tokens)))
        t += dur
    return tuple(out)


# ---------------------------------------------------------------------------
# Spec derivation
# ---------------------------------------------------------------------------

def _kv_bytes_per_token(cfg) -> float:
    """Per-token KV payload across all layers, by block kind: dense/MoE
    attention caches 2·n_kv·head_dim, MLA caches the compressed latent
    (kv_lora_rank + rope dim), SSM/xLSTM blocks keep constant state (no
    per-token growth)."""
    head_dim = cfg.head_dim or (cfg.d_model // max(1, cfg.n_heads))
    kv = 0.0
    for kind in cfg.block_pattern:
        if kind.startswith("mla"):
            kv += (cfg.mla_kv_lora_rank + cfg.mla_qk_rope_dim) * _DTYPE
        elif kind in ("dense", "moe"):
            kv += 2.0 * max(1, cfg.n_kv_heads) * head_dim * _DTYPE
        # mamba2 / mlstm / slstm: constant recurrent state, no KV growth
    return kv


def serving_spec(cfg, windows: Sequence[LoadWindow], *,
                 tp: Optional[int] = None, slo_ttft_s: float = 0.5,
                 slo_tpot_s: float = 0.05,
                 decode_batch: int = 16) -> tuple[ServeSpec, CollectiveProfile]:
    """Config-accurate serving spec + the matching collective profile.

    ``flops_per_token`` is the standard ``2 · N_active`` estimate,
    ``weight_bytes`` the profile's per-rank parameter payload (what one
    decode step streams from HBM), and the KV layout follows the block
    pattern.  Returns the profile too because a serving ``JobSpec``
    carries both (the profile supplies TP degree + activation stream)."""
    from repro_torch.sharding.policy import collective_profile
    prof = collective_profile(cfg, tp=tp)
    spec = ServeSpec(
        windows=tuple(windows), slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s,
        flops_per_token=2.0 * cfg.active_param_count(),
        weight_bytes=float(sum(prof.buckets)),
        kv_bytes_per_token=_kv_bytes_per_token(cfg),
        decode_batch=decode_batch)
    return spec, prof


def serving_spec_from_profile(prof: CollectiveProfile,
                              windows: Sequence[LoadWindow], *,
                              slo_ttft_s: float = 0.5,
                              slo_tpot_s: float = 0.05,
                              decode_batch: int = 16) -> ServeSpec:
    """Profile-only serving spec for sweep workers (no configs/torch).

    Approximations, each invertible from how the profile was derived:
    active params from ``compute_scale = clamp(√(active/1e9))``;
    per-rank weight bytes = the gradient bucket sum (same payload at
    bf16); ``d_model`` from ``tp_bytes = 4096·d_model·2``; layer count
    from the TP stream (4 collectives per TP-sharded block); KV per
    token at a GQA-typical 4× compression of ``d_model``."""
    active = (prof.compute_scale ** 2) * 1e9
    d_model = prof.tp_bytes / (PROFILE_REF_TOKENS * _DTYPE) \
        if prof.tp_bytes else 2048.0
    n_layers = max(4, prof.tp_collectives // 4) if prof.tp_collectives else 16
    return ServeSpec(
        windows=tuple(windows), slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s,
        flops_per_token=2.0 * active,
        weight_bytes=float(sum(prof.buckets)),
        kv_bytes_per_token=2.0 * n_layers * (d_model / 4.0) * _DTYPE,
        decode_batch=decode_batch)


# ---------------------------------------------------------------------------
# Trace assembly
# ---------------------------------------------------------------------------

def serve_trace(n_tenants: int, profiles: Sequence[CollectiveProfile], *,
                pattern: str = "diurnal", horizon_s: float = 3600.0,
                window_s: float = 60.0, base_rate: float = 2.0,
                peak_rate: float = 8.0, prompt_tokens: float = 1024.0,
                output_tokens: float = 256.0, seed: int = 0,
                chips: Optional[Sequence[int]] = None,
                slo_ttft_s: float = 0.5, slo_tpot_s: float = 0.05,
                decode_batch: int = 16, p_burst: float = 1.0 / 24.0,
                mean_burst_windows: float = 8.0, burst_mult: float = 2.0,
                train_jobs: int = 0,
                train_steps: int = 40, train_chips: int = 8,
                train_arrival_rate: float = 1.0 / 300.0) -> Trace:
    """A mixed serving(+training) trace: ``n_tenants`` serving tenants
    cycling through ``profiles``, phase-offset so their peaks stagger,
    plus an optional Poisson training backdrop (the multi-tenancy story:
    morph-driven autoscalers share the rack with training jobs).

    ``chips`` fixes each tenant's initial slice (static provisioning);
    the default is the minimal two replicas (one prefill + one decode),
    the natural floor an autoscaler grows from.  Derives specs from
    profiles only, so sweep workers can build these traces."""
    if not profiles:
        raise ValueError("serve_trace needs at least one profile")
    if pattern not in ("diurnal", "bursty"):
        raise ValueError(f"unknown pattern {pattern!r}: diurnal|bursty")
    jobs: list[JobSpec] = []
    for i in range(n_tenants):
        prof = profiles[i % len(profiles)]
        wseed = (seed * 7919 + i) % (2 ** 32)
        if pattern == "diurnal":
            wins = diurnal_windows(
                horizon_s=horizon_s, window_s=window_s, base_rate=base_rate,
                peak_rate=peak_rate, prompt_tokens=prompt_tokens,
                output_tokens=output_tokens, seed=wseed,
                phase=2.0 * math.pi * i / max(1, n_tenants))
        else:
            wins = bursty_windows(
                horizon_s=horizon_s, window_s=window_s, base_rate=base_rate,
                peak_rate=peak_rate, burst_mult=burst_mult,
                prompt_tokens=prompt_tokens, output_tokens=output_tokens,
                seed=wseed, phase=2.0 * math.pi * i / max(1, n_tenants),
                p_burst=p_burst, mean_burst_windows=mean_burst_windows)
        spec = serving_spec_from_profile(
            prof, wins, slo_ttft_s=slo_ttft_s, slo_tpot_s=slo_tpot_s,
            decode_batch=decode_batch)
        g = max(1, prof.tp)
        k = int(chips[i]) if chips is not None else 2 * g
        jobs.append(JobSpec(tenant=f"serve{i}", arrival=0.0, chips=k,
                            steps=0, compute_s=0.0, coll_bytes=0.0,
                            profile=prof, serve=spec))
    rng = np.random.RandomState((seed + 104729) % (2 ** 32))
    t = 0.0
    for i in range(train_jobs):
        t += float(rng.exponential(1.0 / train_arrival_rate))
        prof = profiles[int(rng.randint(len(profiles)))]
        jobs.append(JobSpec(tenant=f"train{i}", arrival=round(t, 6),
                            chips=train_chips, steps=train_steps,
                            compute_s=float(prof.compute_scale),
                            coll_bytes=prof.grad_bytes, profile=prof))
    return Trace(tuple(jobs))
