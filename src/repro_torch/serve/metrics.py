"""Serving metric names + aggregation helpers.

The port's copy of ``repro.serve.metrics``. The port's launcher
(:mod:`repro_torch.launch.serve`) reports under the same names as the
JAX launcher and the simulator.

The simulator (:meth:`repro_torch.sim.metrics.SimMetrics.serve_summary`) and
the real launcher (:mod:`repro_torch.launch.serve`) both report latency through
the constants below, so a result JSON from either side can be compared
key-for-key — the cross-check the serving subsystem is built around.

This module deliberately imports nothing from the rest of the repo: it
is the neutral vocabulary both sides share.
"""

from __future__ import annotations

from typing import Sequence

#: per-request latency metric names (seconds, as reported by launch/serve)
TTFT_S = "ttft_s"  # time to first token: prefill wall time
TPOT_S = "tpot_s"  # time per output token: steady-state decode step

#: aggregate names (as reported by the simulator's serve_summary)
TTFT_P50_S = "ttft_p50_s"
TTFT_P99_S = "ttft_p99_s"
TPOT_P50_S = "tpot_p50_s"
TPOT_P99_S = "tpot_p99_s"
SLO_ATTAINMENT = "slo_attainment"
GOODPUT_PER_CHIP_S = "goodput_per_chip_s"  # SLO-met requests per chip-second


def weighted_quantile(pairs: Sequence[tuple[float, float]], q: float) -> float:
    """Quantile ``q`` of a weighted sample: ``pairs`` is ``(weight, value)``
    (for serving, per-window request counts weighting per-window latency).
    Returns 0.0 for an empty or zero-weight sample."""
    if not pairs:
        return 0.0
    total = sum(w for w, _ in pairs)
    if total <= 0:
        return 0.0
    cut = q * total
    acc = 0.0
    for w, v in sorted(pairs, key=lambda p: p[1]):
        acc += w
        if acc >= cut:
            return v
    return max(v for _, v in pairs)
