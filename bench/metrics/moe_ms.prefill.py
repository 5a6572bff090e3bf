"""Device time a call of the dropless MoE layers (the program's ``prefill/moe.route``,
``moe.dispatch``, ``moe.experts``, ``moe.combine`` and ``moe.shared`` spans), ms."""

STAGES = ("route", "dispatch", "experts", "combine", "shared")


def read(trace):
    found = [trace.span_busy_s(f"prefill/moe.{s}") for s in STAGES]
    if all(s is None for s in found):
        return None
    return 1e3 * sum(s for s in found if s is not None) / trace.units
