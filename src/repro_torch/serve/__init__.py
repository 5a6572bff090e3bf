"""`repro_torch.serve` — production inference serving on the photonic rack.

The port's copy of ``repro.serve``, with the same exports.

The "millions of users" half of the north star: request-scale traffic
served by multi-tenant slices of the same fabric the training simulator
prices, with the morph subsystem acting as an *autoscaler* rather than
a defragmenter.

  * :mod:`repro_torch.serve.requests` — diurnal/bursty arrival generators that
    aggregate millions of requests into per-window load summaries, and
    serving-spec derivation from model configs or collective profiles.
  * :mod:`repro_torch.serve.tenant` — the analytic prefill/decode
    disaggregated-slice model: TTFT/TPOT from roofline compute + the
    tenant's TP collective stream priced on its actual chips, KV-cache
    handoff as Schedule-IR transfers, M/M/1 attainment per window.
  * :mod:`repro_torch.serve.autoscale` — the reactive SLO-driven policy whose
    decisions the engine executes as priced, invariant-checked morph
    plans (scale-up / scale-down).
  * :mod:`repro_torch.serve.metrics` — the metric vocabulary
    (TTFT/TPOT/attainment/goodput names) shared with the real launcher
    ``repro_torch.launch.serve`` so both sides are cross-checkable.
"""

from repro_torch.serve.autoscale import AutoscaleConfig, Autoscaler
from repro_torch.serve.requests import (bursty_windows, diurnal_windows,
                                  serve_trace, serving_spec,
                                  serving_spec_from_profile)
from repro_torch.serve.tenant import (SlicePrices, WindowStats, granularity,
                                mean_lengths, required_replicas, split_slice,
                                window_stats)

__all__ = [
    "AutoscaleConfig", "Autoscaler",
    "bursty_windows", "diurnal_windows", "serve_trace", "serving_spec",
    "serving_spec_from_profile",
    "SlicePrices", "WindowStats", "granularity", "mean_lengths",
    "required_replicas", "split_slice", "window_stats",
]
