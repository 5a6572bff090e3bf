"""Device time of the step's ``train/adamw`` span, ms a step."""


def read(trace):
    s = trace.span_busy_s("train/adamw")
    return None if s is None else 1e3 * s / trace.units
