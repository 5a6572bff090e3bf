"""The routed experts' least time a call (``expert_bound_s``: their FLOPs at the
bf16 peak against their weights and rows moved once, from the configuration's
model parts) over the device time a call of the program's ``prefill/moe.experts``
spans (the three grouped products and the SwiGLU between them), %. None where
the card's peaks are unknown or the spans are missing."""


def read(trace):
    bound = trace.info.get("expert_bound_s")
    s = trace.span_busy_s("prefill/moe.experts")
    return 100.0 * bound / (s / trace.units) if bound and s else None
