"""Device time of the step's ``train/forward_backward`` span, ms a step."""


def read(trace):
    s = trace.span_busy_s("train/forward_backward")
    return None if s is None else 1e3 * s / trace.units
