"""The step's ``train/grad_comm`` span on the device timeline, first operation
to last, ms a step: the collective's time, waits on peers included."""


def read(trace):
    ranges = trace.spans_device.get("train/grad_comm")
    return 1e3 * sum(b - a for a, b in ranges) / trace.units if ranges else None
