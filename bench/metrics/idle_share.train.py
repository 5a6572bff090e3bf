"""Share of the traced stretch in which no operation ran on the device, %."""


def read(trace):
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s) if trace.ops else None
