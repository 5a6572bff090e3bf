"""Device time a step of the blocks' attention (``train/attention``) and its
backward, the recomputation left out, ms."""

from bench import module_time


def read(trace):
    return module_time.ms_per_step(trace, "attention")
