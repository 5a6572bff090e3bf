"""Host time to issue one prefill call (the harness's ``bench/issue`` span), ms."""


def read(trace):
    spans = trace.spans_host.get("bench/issue")
    return 1e3 * sum(b - a for a, b in spans) / len(spans) if spans else None
