"""Host time to issue one training step (the harness's ``bench/step`` span), ms."""


def read(trace):
    spans = trace.spans_host.get("bench/step")
    return 1e3 * sum(b - a for a, b in spans) / len(spans) if spans else None
