"""The flash kernel's least time at the cell's shape (``bench/flops.py``:
FLOPs of the live pairs at the bf16 peak against q, k, v and o moved once)
over its mean measured time a launch, %. None where the card's peaks are
unknown."""


def read(trace):
    s, n = trace.kind_s("flash")
    bound = trace.info.get("flash_bound_s")
    return 100.0 * bound / (s / n) if n and bound else None
