"""Device time a step of the embedding (``train/embed``: the lookup, its cast
and its scale) and its backward, the recomputation left out, ms."""

from bench import module_time


def read(trace):
    return module_time.ms_per_step(trace, "embed")
