"""Host time a step in the forward (the program's ``train/forward`` span), ms."""


def read(trace):
    spans = trace.spans_host.get("train/forward")
    return 1e3 * sum(b - a for a, b in spans) / trace.units if spans else None
