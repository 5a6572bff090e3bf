"""Workloads and traces for the rack simulator.

The port's copy of ``repro.sim.workload``, line for line: the specs,
the JSONL trace format and every generator draw from
``np.random.RandomState`` in the reference's order, so that one seed
gives one trace in both packages, byte for byte.

A *trace* is the full, allocator-independent description of what happens
to a rack: which tenants arrive when, how big a slice each wants, how
long each trains, and which chips fail at what times.  The same trace is
replayed against every allocator discipline so metrics are directly
comparable (same arrivals, same failures — only the fabric differs).

Traces serialize to JSONL (one event per line) so experiments are
reproducible and sharable; synthetic generators cover the paper's Fig 2a
request mix, Poisson arrival processes, and heavy-tailed tenant sizes
(real cluster traces are dominated by small jobs with a fat tail of
near-rack-scale ones).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, Optional, Sequence

import numpy as np

#: Fig 2a request mix: deliberately awkward sizes (3, 5, 6, 12) that
#: fragment torus/SiPAC racks, alongside friendly powers of two.
FIG2A_SIZES = (1, 2, 3, 4, 5, 6, 8, 12, 16)


@dataclasses.dataclass(frozen=True)
class CollectiveProfile:
    """A tenant's per-step collective mix, derived from its model config.

    The generic trace format prices every tenant as one ALLREDUCE of
    ``coll_bytes`` over all its chips.  A profile replaces that with the
    collective structure the tenant's *actual* architecture produces
    (:func:`repro_torch.sharding.policy.collective_profile` derives one per
    ``configs/`` model):

      * ``tp`` — model-parallel degree folded inside the slice.  The
        slice's chips split into ``tp``-chip TP groups (contiguous in
        locality order, so TP stays on-server) and ``width // tp``-wide
        data-parallel rings (one per TP rank, strided across groups).
      * ``buckets`` — per-DP-rank gradient bucket sizes in bytes (already
        divided by the TP sharding; DDP-style size-targeted cuts).  Each
        bucket is priced independently, so small buckets land in the
        α-dominated regime where log-round algorithms win and large ones
        in the β-dominated Ring regime — the per-bucket algorithm *mix*
        emerges exactly as in ``optim.grad_comm``.
      * ``algos`` — per-bucket algorithm hint from the α–β model at a
        reference width (diagnostic; the simulator still picks the
        cheapest admissible schedule on the tenant's real layout).
      * ``cadence`` — steps between gradient reductions (accumulation);
        bucket cost is amortized ``1/cadence`` per step.
      * ``tp_bytes`` / ``tp_collectives`` — the per-step activation
        ALLREDUCE stream inside each TP group (Megatron: 2 forward + 2
        backward per TP-sharded block).  Architectures whose mixers
        replicate (SSM/xLSTM) have none — heterogeneity the generic
        format cannot express.
      * ``compute_scale`` — relative per-step compute weight (generators
        multiply their base ``compute_s`` by it).
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

    @property
    def grad_bytes(self) -> float:
        """Total per-DP-rank gradient payload per reduction."""
        return float(sum(self.buckets))

    @property
    def step_bytes(self) -> float:
        """Mean bytes a rank ships per step (cadence-amortized gradients
        plus the TP activation stream) — the generic-trace equivalent."""
        return self.grad_bytes / self.cadence + self.tp_collectives * self.tp_bytes

    @classmethod
    def from_json(cls, rec: dict) -> "CollectiveProfile":
        return cls(model=rec.get("model", ""), tp=int(rec.get("tp", 1)),
                   buckets=tuple(rec.get("buckets", ())),
                   algos=tuple(rec.get("algos", ())),
                   cadence=int(rec.get("cadence", 1)),
                   tp_bytes=float(rec.get("tp_bytes", 0.0)),
                   tp_collectives=int(rec.get("tp_collectives", 0)),
                   compute_scale=float(rec.get("compute_scale", 1.0)))


@dataclasses.dataclass(frozen=True)
class LoadWindow:
    """Aggregated serving traffic over one time window.

    Request-scale traffic (millions of arrivals) is summarized per
    window — arrival count plus the mean prompt/output token mix — so
    the event engine processes one event per window instead of one per
    request while the analytic queueing model in
    :mod:`repro_torch.serve.tenant` still sees the full offered load.
    """

    start: float  # s, relative to the tenant's arrival
    duration: float  # s
    requests: int  # arrivals in the window (may be millions)
    prompt_tokens: float  # mean prompt length
    output_tokens: float  # mean generated length

    @property
    def rate(self) -> float:
        """Offered request rate (req/s) over the window."""
        return self.requests / self.duration if self.duration > 0 else 0.0

    @classmethod
    def from_json(cls, rec: dict) -> "LoadWindow":
        return cls(start=float(rec["start"]), duration=float(rec["duration"]),
                   requests=int(rec["requests"]),
                   prompt_tokens=float(rec["prompt_tokens"]),
                   output_tokens=float(rec["output_tokens"]))


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """A serving tenant: offered load per window, SLO targets, and the
    roofline constants its model needs to turn a slice of chips into
    TTFT/TPOT numbers (see :mod:`repro_torch.serve.tenant`).

    The tenant's chips split into TP-group *replicas* (``profile.tp``
    chips each), partitioned into **prefill** and **decode** slices —
    prompt processing is compute-bound, token generation weight-read
    bound, and the KV cache handoff between the two rides the photonic
    fabric as a Schedule-IR transfer.
    """

    windows: tuple[LoadWindow, ...]
    slo_ttft_s: float = 0.5  # per-request time-to-first-token target
    slo_tpot_s: float = 0.05  # per-token decode-latency target
    flops_per_token: float = 2e9  # 2 · active params (prefill roofline)
    weight_bytes: float = 1e9  # per-TP-rank weight bytes (decode roofline)
    kv_bytes_per_token: float = 1e5  # KV payload per token (handoff transfer)
    decode_batch: int = 16  # concurrent decode streams per replica

    def __post_init__(self):
        object.__setattr__(self, "windows", tuple(self.windows))
        if not self.windows:
            raise ValueError("ServeSpec needs at least one LoadWindow")
        if self.slo_ttft_s <= 0 or self.slo_tpot_s <= 0:
            raise ValueError("SLO targets must be positive")
        if self.decode_batch < 1:
            raise ValueError("decode_batch must be ≥ 1")

    @property
    def horizon_s(self) -> float:
        """Total serving lifetime (windows are contiguous)."""
        last = self.windows[-1]
        return last.start + last.duration

    @property
    def total_requests(self) -> int:
        return sum(w.requests for w in self.windows)

    @classmethod
    def from_json(cls, rec: dict) -> "ServeSpec":
        return cls(
            windows=tuple(LoadWindow.from_json(w) for w in rec["windows"]),
            slo_ttft_s=float(rec.get("slo_ttft_s", 0.5)),
            slo_tpot_s=float(rec.get("slo_tpot_s", 0.05)),
            flops_per_token=float(rec.get("flops_per_token", 2e9)),
            weight_bytes=float(rec.get("weight_bytes", 1e9)),
            kv_bytes_per_token=float(rec.get("kv_bytes_per_token", 1e5)),
            decode_batch=int(rec.get("decode_batch", 16)))


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One tenant's job: arrive, train ``steps`` steps, depart.

    Every step is a compute phase of ``compute_s`` seconds followed by a
    gradient ALLREDUCE of ``coll_bytes`` bytes priced by the discipline's
    cost model, so a job's nominal duration is
    ``steps * (compute_s + collective_time)``.

    ``profile`` (optional, serialized only when present so the classic
    JSONL stays byte-identical) replaces the single generic ALLREDUCE
    with the tenant's model-derived :class:`CollectiveProfile` — bucketed
    DP gradients over ``width // tp`` rings plus the TP activation stream.

    ``serve`` (optional, serialized only when present) turns the tenant
    into a *serving* tenant: instead of training steps it serves the
    request traffic in ``serve.windows`` from prefill/decode slices and
    departs after the last window; ``steps``/``compute_s``/``coll_bytes``
    are ignored, ``chips`` is the initial slice size (the autoscaler may
    grow or shrink it live).  ``profile`` supplies the TP degree and the
    activation-collective stream.
    """

    tenant: str
    arrival: float  # s, absolute simulation time
    chips: int  # requested slice size
    steps: int  # training steps before departure
    compute_s: float = 1.0  # compute time per step
    coll_bytes: float = float(4 << 20)  # ALLREDUCE bytes per step
    profile: Optional[CollectiveProfile] = None
    serve: Optional[ServeSpec] = None


#: Fault kinds a FailureSpec may carry.  ``chip`` is the classic
#: whole-chip kill; the fabric kinds hit the photonic plumbing
#: instead — see ``repro_torch.core.health`` — and ``repair`` undoes an
#: earlier fault (``target`` names which kind).
FAULT_KINDS = ("chip", "link_fail", "trx_fail", "rail_fail", "degrade",
               "ocs_glitch", "repair")


@dataclasses.dataclass(frozen=True)
class FailureSpec:
    """One fault event at ``time``.

    ``kind`` selects what breaks (:data:`FAULT_KINDS`):

      * ``chip`` — ``chips`` die permanently (the classic event; all
        other fields are ignored and never serialized).
      * ``link_fail`` — ``count`` fibers between server pair ``link``
        go dark.
      * ``trx_fail`` — ``count`` TRX lanes on each of ``chips`` die
        (a chip losing its last lane is operationally dead).
      * ``rail_fail`` — ``count`` rails between rack pair ``link``
        go dark (pod mode).
      * ``degrade`` — ``chips``' circuits run ``derate×`` slower
        (BER climb / laser drift).
      * ``ocs_glitch`` — for ``duration`` seconds, circuit
        establishment through the OCS (rack pair ``link``, or the
        rack's own mesh when ``link`` is None) fails with probability
        ``prob`` per attempt.
      * ``repair`` — undo the earlier ``target``-kind fault on the same
        ``chips``/``link`` (MTTR-driven; generators schedule one per
        permanent fault).
    """

    time: float
    chips: tuple[int, ...] = ()
    kind: str = "chip"
    link: Optional[tuple[int, int]] = None
    count: int = 1
    derate: float = 1.0
    duration: float = 0.0
    prob: float = 1.0
    target: str = ""

    def __post_init__(self):
        object.__setattr__(self, "chips", tuple(self.chips))
        if self.link is not None:
            object.__setattr__(self, "link", tuple(self.link))
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"have {FAULT_KINDS}")
        if self.kind == "repair" and self.target not in FAULT_KINDS:
            raise ValueError(f"repair target must name a fault kind, "
                             f"got {self.target!r}")


@dataclasses.dataclass(frozen=True)
class Trace:
    jobs: tuple[JobSpec, ...]
    failures: tuple[FailureSpec, ...] = ()

    @property
    def n_events(self) -> int:
        """External events only (arrivals + failures); the engine generates
        many more internal phase/departure events per job."""
        return len(self.jobs) + len(self.failures)

    # -- JSONL (one event per line, replayable) ------------------------------
    def to_jsonl(self) -> str:
        lines = []
        for j in self.jobs:
            rec = dataclasses.asdict(j)
            if j.profile is None:
                # profile-free jobs serialize exactly as before the profile
                # extension — old goldens and readers stay byte-identical
                del rec["profile"]
            if j.serve is None:
                # same contract for the serving extension: training-only
                # traces keep their pre-serve byte-identical form
                del rec["serve"]
            lines.append(json.dumps({"type": "job", **rec}))
        for f in self.failures:
            rec = {"type": "failure", "time": f.time, "chips": list(f.chips)}
            if f.kind != "chip":
                # fabric faults carry only their non-default fields, so
                # pre-chaos chip-failure traces stay byte-identical (same
                # contract as the profile/serve keys above)
                rec["kind"] = f.kind
                if f.link is not None:
                    rec["link"] = list(f.link)
                if f.count != 1:
                    rec["count"] = f.count
                if f.derate != 1.0:
                    rec["derate"] = f.derate
                if f.duration != 0.0:
                    rec["duration"] = f.duration
                if f.prob != 1.0:
                    rec["prob"] = f.prob
                if f.target:
                    rec["target"] = f.target
            lines.append(json.dumps(rec))
        return "\n".join(lines) + "\n"

    @classmethod
    def from_jsonl(cls, text: str) -> "Trace":
        jobs: list[JobSpec] = []
        failures: list[FailureSpec] = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.pop("type")
            if kind == "job":
                prof = rec.pop("profile", None)
                if prof is not None:
                    prof = CollectiveProfile.from_json(prof)
                serve = rec.pop("serve", None)
                if serve is not None:
                    serve = ServeSpec.from_json(serve)
                jobs.append(JobSpec(profile=prof, serve=serve, **rec))
            elif kind == "failure":
                link = rec.get("link")
                failures.append(FailureSpec(
                    rec["time"], tuple(rec["chips"]),
                    kind=rec.get("kind", "chip"),
                    link=None if link is None else tuple(link),
                    count=int(rec.get("count", 1)),
                    derate=float(rec.get("derate", 1.0)),
                    duration=float(rec.get("duration", 0.0)),
                    prob=float(rec.get("prob", 1.0)),
                    target=rec.get("target", "")))
            else:
                raise ValueError(f"unknown trace event type {kind!r}")
        return cls(tuple(jobs), tuple(failures))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            return cls.from_jsonl(f.read())


# ---------------------------------------------------------------------------
# Size distributions
# ---------------------------------------------------------------------------

def fig2a_size_sampler(rng: np.random.RandomState) -> int:
    return int(rng.choice(FIG2A_SIZES))


def heavy_tailed_size_sampler(rng: np.random.RandomState, n_chips: int = 64,
                              sigma: float = 1.2) -> int:
    """Lognormal tenant sizes: mostly 1–4 chips, occasional near-rack jobs."""
    k = int(np.ceil(rng.lognormal(mean=0.7, sigma=sigma)))
    return int(min(max(k, 1), n_chips))


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def poisson_trace(n_jobs: int, *, arrival_rate: float = 0.5,
                  mean_steps: float = 20.0, compute_s: float = 1.0,
                  coll_bytes: float = float(64 << 20),
                  size_sampler: Callable[[np.random.RandomState], int] | None = None,
                  failure_rate: float = 0.0, n_chips: int = 64,
                  seed: int = 0) -> Trace:
    """Poisson arrivals at ``arrival_rate`` jobs/s, geometric-ish step counts,
    optional Poisson chip failures at ``failure_rate`` failures/s."""
    rng = np.random.RandomState(seed)
    sampler = size_sampler or (lambda r: heavy_tailed_size_sampler(r, n_chips))
    t = 0.0
    jobs = []
    for i in range(n_jobs):
        t += rng.exponential(1.0 / arrival_rate)
        steps = int(rng.exponential(mean_steps)) + 1
        jobs.append(JobSpec(tenant=f"t{i}", arrival=round(t, 6),
                            chips=sampler(rng), steps=steps,
                            compute_s=compute_s, coll_bytes=coll_bytes))
    failures = []
    if failure_rate > 0:
        horizon = t
        ft = 0.0
        while True:
            ft += rng.exponential(1.0 / failure_rate)
            if ft >= horizon:
                break
            chip = int(rng.randint(n_chips))
            failures.append(FailureSpec(time=round(ft, 6), chips=(chip,)))
    return Trace(tuple(jobs), tuple(failures))


def fig2a_trace(n_events: int = 2000, *, mean_lifetime: float = 60.0,
                compute_s: float = 6.0, coll_bytes: float = float(4 << 20),
                failure_rate: float = 0.0, n_chips: int = 64,
                seed: int = 0) -> Trace:
    """The paper's Fig 2a churn: one arrival per unit time, sizes from the
    mixed request distribution, exponential lifetimes (mean 60 time units).

    ``compute_s`` sets the step granularity: a tenant's lifetime is carved
    into ``lifetime / compute_s`` compute→collective phases.
    ``failure_rate`` adds Poisson single-chip failures (failures/s) over
    the arrival horizon — the morph benchmarks stress departures *and*
    failures on the same Fig 2a mix.  Jobs are drawn before failures, so a
    given seed's arrival sequence is identical at any failure rate.
    """
    rng = np.random.RandomState(seed)
    jobs = []
    for t in range(n_events):
        k = fig2a_size_sampler(rng)
        lifetime = float(int(rng.exponential(mean_lifetime)) + 1)
        steps = max(1, int(round(lifetime / compute_s)))
        jobs.append(JobSpec(tenant=f"t{t}", arrival=float(t), chips=k,
                            steps=steps, compute_s=compute_s,
                            coll_bytes=coll_bytes))
    failures = []
    if failure_rate > 0:
        ft = 0.0
        while True:
            ft += rng.exponential(1.0 / failure_rate)
            if ft >= float(n_events):
                break
            chip = int(rng.randint(n_chips))
            failures.append(FailureSpec(time=round(ft, 6), chips=(chip,)))
    return Trace(tuple(jobs), tuple(failures))


def pod_churn_trace(n_events: int = 200, *, n_chips: int = 128,
                    chips_per_rack: int = 64, mean_lifetime: float = 60.0,
                    arrival_every: float = 4.0, compute_s: float = 6.0,
                    coll_bytes: float = float(4 << 20),
                    failure_rate: float = 0.0, seed: int = 0) -> Trace:
    """Fig 2a-style churn scaled to a pod: the request mix spans sub-rack
    fractions up to **multi-rack** tenants (1.5× and 2× ``chips_per_rack``),
    so rack-first placement, rail pricing, and hierarchical collectives
    are all exercised by one trace.  Small tenants dominate (heavy-tailed
    cluster reality); pod-scale ones are rare but present.  Like
    :func:`fig2a_trace`, jobs are drawn before failures so a seed's
    arrival sequence is identical at any failure rate.
    """
    rng = np.random.RandomState(seed)
    fractions = (1 / 32, 1 / 16, 3 / 32, 1 / 8, 3 / 16, 1 / 4,
                 3 / 8, 1 / 2, 3 / 4, 1.0, 3 / 2, 2.0)
    sizes = tuple(min(n_chips, max(1, int(round(f * chips_per_rack))))
                  for f in fractions)
    weights = np.array([4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 1, 1], dtype=float)
    weights /= weights.sum()
    jobs = []
    for t in range(n_events):
        k = int(sizes[rng.choice(len(sizes), p=weights)])
        lifetime = float(int(rng.exponential(mean_lifetime)) + 1)
        steps = max(1, int(round(lifetime / compute_s)))
        jobs.append(JobSpec(tenant=f"t{t}", arrival=float(t) * arrival_every,
                            chips=k, steps=steps, compute_s=compute_s,
                            coll_bytes=coll_bytes))
    failures = []
    if failure_rate > 0:
        horizon = float(n_events) * arrival_every
        ft = 0.0
        while True:
            ft += rng.exponential(1.0 / failure_rate)
            if ft >= horizon:
                break
            chip = int(rng.randint(n_chips))
            failures.append(FailureSpec(time=round(ft, 6), chips=(chip,)))
    return Trace(tuple(jobs), tuple(failures))


def zoo_trace(n_jobs: int, profiles: Sequence[CollectiveProfile], *,
              arrival_rate: float = 0.5, mean_steps: float = 20.0,
              compute_s: float = 1.0, n_chips: int = 64,
              failure_rate: float = 0.0, seed: int = 0) -> Trace:
    """Heterogeneous multi-model churn: every tenant samples a model from
    the ``profiles`` zoo, requests a ``tp × dp`` slice (its profile's TP
    degree times a power-of-two data-parallel width), and prices its
    steps from its *own* collective mix — bucketed DP gradients plus the
    TP activation stream — instead of one generic ALLREDUCE.

    ``coll_bytes`` is set to the profile's per-reduction gradient payload,
    so :func:`strip_profiles` yields the exact generic-trace counterpart
    (same arrivals, sizes, lifetimes; only the pricing model differs).
    The generator is deterministic in ``seed`` and, like the other
    generators, draws jobs before failures.
    """
    if not profiles:
        raise ValueError("zoo_trace needs at least one CollectiveProfile")
    rng = np.random.RandomState(seed)
    t = 0.0
    jobs = []
    for i in range(n_jobs):
        t += rng.exponential(1.0 / arrival_rate)
        prof = profiles[int(rng.randint(len(profiles)))]
        max_dp = max(1, n_chips // prof.tp)
        dp = 1 << int(rng.randint(0, int(math.log2(max_dp)) + 1))
        chips = min(n_chips, prof.tp * dp)
        steps = int(rng.exponential(mean_steps)) + 1
        jobs.append(JobSpec(tenant=f"t{i}", arrival=round(t, 6), chips=chips,
                            steps=steps,
                            compute_s=round(compute_s * prof.compute_scale, 6),
                            coll_bytes=prof.grad_bytes, profile=prof))
    failures = []
    if failure_rate > 0:
        horizon = t
        ft = 0.0
        while True:
            ft += rng.exponential(1.0 / failure_rate)
            if ft >= horizon:
                break
            chip = int(rng.randint(n_chips))
            failures.append(FailureSpec(time=round(ft, 6), chips=(chip,)))
    return Trace(tuple(jobs), tuple(failures))


def strip_profiles(trace: Trace) -> Trace:
    """The generic-ALLREDUCE counterpart of a profiled trace: identical
    arrivals, sizes, lifetimes, and failures, but every tenant priced as
    one ``coll_bytes`` ALLREDUCE over all its chips — the baseline the
    ``claim_profiles_matter`` sweep comparison replays."""
    return Trace(tuple(dataclasses.replace(j, profile=None)
                       for j in trace.jobs), trace.failures)


def failure_injection_trace(*, n_chips: int = 64, seed: int = 0) -> Trace:
    """A small deterministic scenario for testing recovery: a rack fills up,
    then a burst of failures forces re-allocation from survivors."""
    rng = np.random.RandomState(seed)
    jobs = [JobSpec(tenant=f"t{i}", arrival=float(i), chips=8, steps=40,
                    compute_s=1.0) for i in range(6)]
    dead = tuple(int(c) for c in rng.choice(n_chips, size=6, replace=False))
    failures = [FailureSpec(time=10.0, chips=dead[:3]),
                FailureSpec(time=20.0, chips=dead[3:])]
    return Trace(tuple(jobs), tuple(failures))


# ---------------------------------------------------------------------------
# Fabric chaos
# ---------------------------------------------------------------------------

def chaos_trace(n_events: int = 60, *, n_chips: int = 64,
                tiles_per_server: int = 8, mean_lifetime: float = 60.0,
                compute_s: float = 6.0, coll_bytes: float = float(4 << 20),
                link_fail_rate: float = 0.02, trx_fail_rate: float = 0.01,
                degrade_rate: float = 0.01, max_fibers_cut: int = 4,
                max_lanes_cut: int = 2, derate: float = 2.0,
                mttr: float = 40.0, seed: int = 0) -> Trace:
    """Fig 2a churn plus fabric chaos: Poisson fiber-bundle cuts between
    random server pairs, TRX-lane deaths on random chips, and BER-style
    ``derate``× circuit slowdowns, each followed by a ``repair`` event an
    exponential(``mttr``) later.  Jobs are drawn before faults, so the
    degraded-mode run and its :func:`fail_stop_trace` counterpart see a
    byte-identical tenant sequence for any seed."""
    rng = np.random.RandomState(seed)
    jobs = []
    for t in range(n_events):
        k = fig2a_size_sampler(rng)
        lifetime = float(int(rng.exponential(mean_lifetime)) + 1)
        steps = max(1, int(round(lifetime / compute_s)))
        jobs.append(JobSpec(tenant=f"t{t}", arrival=float(t), chips=k,
                            steps=steps, compute_s=compute_s,
                            coll_bytes=coll_bytes))
    horizon = float(n_events)
    n_servers = max(2, n_chips // tiles_per_server)
    failures: list[FailureSpec] = []

    def with_repair(fail: FailureSpec) -> None:
        failures.append(fail)
        rt = round(fail.time + rng.exponential(mttr), 6)
        failures.append(FailureSpec(rt, fail.chips, kind="repair",
                                    link=fail.link, target=fail.kind))

    def rand_pair(n: int) -> tuple[int, int]:
        a = int(rng.randint(n))
        b = int(rng.randint(n - 1))
        if b >= a:
            b += 1
        return (min(a, b), max(a, b))

    ft = 0.0
    while link_fail_rate > 0:
        ft += rng.exponential(1.0 / link_fail_rate)
        if ft >= horizon:
            break
        with_repair(FailureSpec(round(ft, 6), (), kind="link_fail",
                                link=rand_pair(n_servers),
                                count=int(rng.randint(max_fibers_cut)) + 1))
    ft = 0.0
    while trx_fail_rate > 0:
        ft += rng.exponential(1.0 / trx_fail_rate)
        if ft >= horizon:
            break
        chip = int(rng.randint(n_chips))
        with_repair(FailureSpec(round(ft, 6), (chip,), kind="trx_fail",
                                count=int(rng.randint(max_lanes_cut)) + 1))
    ft = 0.0
    while degrade_rate > 0:
        ft += rng.exponential(1.0 / degrade_rate)
        if ft >= horizon:
            break
        chip = int(rng.randint(n_chips))
        with_repair(FailureSpec(round(ft, 6), (chip,), kind="degrade",
                                derate=derate))
    failures.sort(key=lambda f: f.time)
    return Trace(tuple(jobs), tuple(failures))


def glitch_storm_trace(n_events: int = 40, *, n_chips: int = 64,
                       mean_lifetime: float = 60.0, compute_s: float = 6.0,
                       coll_bytes: float = float(4 << 20),
                       glitch_every: float = 8.0,
                       glitch_duration: float = 4.0,
                       glitch_prob: float = 0.5, seed: int = 0) -> Trace:
    """Fig 2a churn under a storm of *transient* OCS faults: every
    ``glitch_every`` time units circuit establishment fails with
    per-attempt probability ``glitch_prob`` for ``glitch_duration``
    seconds.  No permanent faults, so the p99 establishment-latency claim
    isolates the retry/backoff path."""
    rng = np.random.RandomState(seed)
    jobs = []
    for t in range(n_events):
        k = fig2a_size_sampler(rng)
        lifetime = float(int(rng.exponential(mean_lifetime)) + 1)
        steps = max(1, int(round(lifetime / compute_s)))
        jobs.append(JobSpec(tenant=f"t{t}", arrival=float(t), chips=k,
                            steps=steps, compute_s=compute_s,
                            coll_bytes=coll_bytes))
    failures = []
    t = 1.0
    while t < float(n_events):
        failures.append(FailureSpec(round(t, 6), (), kind="ocs_glitch",
                                    duration=glitch_duration,
                                    prob=glitch_prob))
        t += glitch_every
    return Trace(tuple(jobs), tuple(failures))


def fail_stop_trace(trace: Trace, *, tiles_per_server: int = 8,
                    chips_per_rack: Optional[int] = None) -> Trace:
    """The fail-stop counterpart of a fabric-fault trace: every fabric
    fault is recast as permanently killing all chips that touch the broken
    element — both servers of a dark fiber bundle, both racks of a dark
    rail pair, the TRX-hit or derated chips themselves.  Repairs and
    transient glitches are dropped (fail-stop hardware never comes back).
    Replaying this on the same engine is the baseline the degraded-mode
    goodput claim compares against."""
    failures = []
    for f in trace.failures:
        if f.kind == "chip":
            failures.append(f)
            continue
        if f.kind in ("repair", "ocs_glitch"):
            continue
        if f.kind == "link_fail":
            assert f.link is not None
            chips = [c for s in f.link
                     for c in range(s * tiles_per_server,
                                    (s + 1) * tiles_per_server)]
        elif f.kind == "rail_fail":
            assert f.link is not None and chips_per_rack is not None
            chips = [c for r in f.link
                     for c in range(r * chips_per_rack,
                                    (r + 1) * chips_per_rack)]
        else:  # trx_fail, degrade
            chips = list(f.chips)
        failures.append(FailureSpec(f.time, tuple(chips)))
    return Trace(trace.jobs, tuple(failures))
