"""From a ``torch.profiler`` stretch to what the per-layer readers read.

A :class:`Trace` holds the device operations (kernels, copies, sets) with
their times, the program's and the harness's ``record_function`` spans on
the host and, where the profiler gives them, on the device, the host's
operations (to say what the host was doing while the device sat idle), the
number of steps or calls the stretch holds, and the cell's constants
(FLOPs a unit, the card's peak, the flash kernel's least time).

Busy time is the union of the device operations' intervals, so work on two
streams at once (NCCL's beside compute) counts once.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

# device work by kind: the first kind whose words a kernel's name holds (the
# classes of chip_smoke.py's phase 6, frozen here, with the flash kernel first)
KERNEL_KINDS = [("flash", ("flash_fwd",)),
                ("gemm", ("gemm", "xmma", "cutlass", "cublas", "sm90_", "nvjet")),
                ("nccl", ("nccl",)),
                ("index", ("index", "scatter", "gather")),
                ("reduce", ("reduce",)),
                ("copy", ("Memcpy", "Memset", "copy")),
                ("elementwise", ("elementwise",))]


def kind_of(name: str) -> str:
    return next((k for k, words in KERNEL_KINDS if any(w in name for w in words)), "other")


Interval = tuple[float, float]  # seconds on the profiler's clock


def union(intervals: Iterable[Interval]) -> list[Interval]:
    """The intervals merged where they overlap or touch, in order."""
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def covered(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the intervals cover, each instant once."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union(intervals))


@dataclasses.dataclass
class Trace:
    ops: list[tuple[str, float, float]]  # device operations: name, start, end
    spans_host: dict[str, list[Interval]]  # record_function spans on the host
    spans_device: dict[str, list[Interval]]  # the same spans on the device timeline
    host_ops: list[tuple[str, float, float]]  # the host's operations, main thread
    start: float  # the stretch on the profiler's clock
    end: float
    units: int  # steps or calls in the stretch
    info: dict  # the cell's constants

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return covered(((a, b) for _, a, b in self.ops), self.start, self.end)

    def kind_s(self, kind: str) -> tuple[float, int]:
        """Seconds and launches of the device operations of one kind."""
        hits = [(a, b) for n, a, b in self.ops if kind_of(n) == kind]
        return sum(b - a for a, b in hits), len(hits)

    def span_busy_s(self, name: str) -> Optional[float]:
        """Device seconds of the operations that start inside the span's device
        ranges (each instant once), or None where the span has none."""
        ranges = self.spans_device.get(name)
        if not ranges:
            return None
        return sum(covered(((a, b) for _, a, b in self.ops if lo <= a <= hi), lo, hi)
                   for lo, hi in ranges)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps summed
        by what the host was doing when each began."""
        by_name: dict[str, float] = {}
        for n, a, b in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        busy = union(((max(a, self.start), min(b, self.end)) for _, a, b in self.ops
                      if b > self.start and a < self.end))
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(lo, hi) for lo, hi in zip(edges[::2], edges[1::2]) if hi > lo]
        by_host: dict[str, float] = {}
        for (lo, hi), label in zip(gaps, self.host_doing([lo for lo, _ in gaps])):
            by_host[label] = by_host.get(label, 0.0) + (hi - lo)

        def best(d):
            return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(by_name), "idle_gaps": best(by_host)}

    def host_doing(self, times: list[float]) -> list[str]:
        """For each of the ascending ``times``, the outermost span and the
        innermost operation the host was in (one sweep: a thread's operations
        nest)."""
        ops = sorted(self.host_ops, key=lambda x: (x[1], -x[2]))
        stack: list[tuple[str, float, float]] = []
        out, i = [], 0
        for t in times:
            while i < len(ops) and ops[i][1] <= t:
                while stack and stack[-1][2] <= ops[i][1]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            if not stack:
                out.append("host: between operations")
            else:
                outer, inner = stack[0][0], stack[-1][0]
                out.append(outer if len(stack) == 1 else f"{outer} > {inner}")
        return out


STRETCH = "bench/stretch"  # the harness's span around the traced units, synchronised at both ends


def from_profiler(prof, units: int, info: dict,
                  span_prefixes: tuple[str, ...] = ("train/", "prefill/", "bench/")) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile``: the events
    inside its ``bench/stretch`` span, on the profiler's clock in seconds.
    Ranges named under ``span_prefixes`` (the program's train and prefill
    spans, the harness's own) are spans; every other device event is an
    operation."""
    from torch.autograd import DeviceType
    events = prof.events()
    stretch = next(e for e in events
                   if e.name == STRETCH and e.device_type == DeviceType.CPU)
    start, end = stretch.time_range.start / 1e6, stretch.time_range.end / 1e6
    ops, host_ops = [], []
    spans_host: dict[str, list[Interval]] = {}
    spans_device: dict[str, list[Interval]] = {}
    for e in events:
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if b < start or a > end:
            continue
        marked = e.name.startswith(span_prefixes)
        if e.device_type == DeviceType.CUDA:
            (spans_device.setdefault(e.name, []).append((a, b)) if marked
             else ops.append((e.name, a, b)))
        elif e.device_type == DeviceType.CPU:
            if marked:
                spans_host.setdefault(e.name, []).append((a, b))
            if e.thread == stretch.thread and e.name != STRETCH:
                host_ops.append((e.name, a, b))
    return Trace(ops=ops, spans_host=spans_host, spans_device=spans_device,
                 host_ops=host_ops, start=start, end=end, units=units, info=info)
