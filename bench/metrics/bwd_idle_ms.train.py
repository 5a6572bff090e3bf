"""Time a step in which the device sat idle while the host was in the
backward (inside the ``train/backward`` span's host ranges), ms."""

from bench.trace import covered


def read(trace):
    spans = trace.spans_host.get("train/backward")
    if not spans:
        return None
    busy = [(a, b) for _, a, b in trace.ops]
    return 1e3 * sum((hi - lo) - covered(busy, lo, hi) for lo, hi in spans) / trace.units
