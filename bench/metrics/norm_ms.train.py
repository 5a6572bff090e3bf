"""Device time a step of the blocks' norms and the final norm (``train/norm``)
and their backward, the recomputation left out, ms."""

from bench import module_time


def read(trace):
    return module_time.ms_per_step(trace, "norm")
