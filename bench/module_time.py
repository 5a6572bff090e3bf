"""Device time of the model's modules in a traced train step, read from the
program's module spans (``repro_torch.spans``).

On the device a span's range runs from the first to the last kernel launched
with it as its thread's innermost span, so the ranges of ``train/<module>``,
``train/<module>.bwd`` and ``train/recompute`` each hold their own kernels
(the program marks the modules inside a recomputation on the host only). A
recomputation runs inside a module's ``.bwd`` span, and its range may lie
inside that span's range. Each device operation is counted once: in
``recompute`` where it starts inside a ``train/recompute`` range, else in the
module whose range it starts in (the narrowest, where two hold it), else in
none (the residual adds, the gradients summed between modules, the layers'
gradients stacked at the end).
"""

from __future__ import annotations

from typing import Optional

from bench.trace import Trace, covered

MODULES = ("embed", "norm", "attention", "ffn", "unembed", "loss")
RECOMPUTE = "recompute"


def split_s(trace: Trace) -> dict[str, float]:
    """Device seconds of each module and of ``recompute`` over the stretch."""
    ranges = [(lo, hi, RECOMPUTE) for lo, hi in trace.spans_device.get("train/recompute", [])]
    for m in MODULES:
        for name in (f"train/{m}", f"train/{m}.bwd"):
            ranges += [(lo, hi, m) for lo, hi in trace.spans_device.get(name, [])]
    # one sweep: at an instant, ranges open before an operation starts there and
    # close after it
    events = [(lo, 0, i) for i, (lo, _, _) in enumerate(ranges)]
    events += [(hi, 2, i) for i, (_, hi, _) in enumerate(ranges)]
    events += [(a, 1, j) for j, (_, a, _) in enumerate(trace.ops)]
    active: set[int] = set()
    hits: dict[str, list] = {k: [] for k in (*MODULES, RECOMPUTE)}
    for _, what, i in sorted(events):
        if what == 0:
            active.add(i)
        elif what == 2:
            active.discard(i)
        elif active:
            held = [ranges[k] for k in active]
            rec = [r for r in held if r[2] == RECOMPUTE]
            label = (rec[0] if rec else min(held, key=lambda r: r[1] - r[0]))[2]
            _, a, b = trace.ops[i]
            hits[label].append((a, b))
    return {k: covered(v, trace.start, trace.end) for k, v in hits.items()}


def ms_per_step(trace: Trace, label: str) -> Optional[float]:
    """A module's (or ``recompute``'s) device time a step, ms; None where the
    trace has none of its spans on the device."""
    names = [f"train/{label}"] + ([] if label == RECOMPUTE else [f"train/{label}.bwd"])
    if not any(trace.spans_device.get(n) for n in names):
        return None
    return 1e3 * split_s(trace)[label] / trace.units
