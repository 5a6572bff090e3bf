"""Device time of the flash kernel, ms a call."""


def read(trace):
    s, n = trace.kind_s("flash")
    return 1e3 * s / trace.units if n else None
