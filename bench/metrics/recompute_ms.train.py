"""Device time a step of the blocks' recomputation in the backward
(``train/recompute``), ms."""

from bench import module_time


def read(trace):
    return module_time.ms_per_step(trace, module_time.RECOMPUTE)
