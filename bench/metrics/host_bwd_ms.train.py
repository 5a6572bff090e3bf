"""Host time a step in the backward (the program's ``train/backward`` span:
the main thread's wait in ``torch.autograd.grad`` while the autograd engine
launches the backward from its own thread), ms."""


def read(trace):
    spans = trace.spans_host.get("train/backward")
    return 1e3 * sum(b - a for a, b in spans) / trace.units if spans else None
