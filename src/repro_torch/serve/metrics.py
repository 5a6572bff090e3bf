"""Serving metric names, the port's copy of ``repro.serve.metrics``'s keys.

The JAX launcher, the simulator and the port's launcher report latency under
these names, so their result JSONs compare key for key.
"""

from __future__ import annotations

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
