"""Rack simulation walkthrough: one multi-tenant trace, three fabrics.

The twin of ``examples/simulate_rack.py`` on the port's modules, line for line: it
prints what the JAX example prints. Host code; it takes no device.

Generates a Poisson trace with heavy-tailed tenant sizes and a chip
failure burst, saves it as replayable JSONL, then replays the *same*
trace against LUMORPH, torus, and SiPAC disciplines and prints a
side-by-side comparison plus each evicted/shrunk tenant's story.

Run:  PYTHONPATH=src python examples/torch_simulate_rack.py
"""

import tempfile

from repro_torch.sim import Trace, compare, poisson_trace

N_CHIPS = 64


def main():
    trace = poisson_trace(80, arrival_rate=0.4, mean_steps=12.0,
                          compute_s=1.0, coll_bytes=float(1 << 20),
                          failure_rate=0.01, n_chips=N_CHIPS, seed=7)

    # traces are replayable artifacts: save, reload, verify round-trip
    with tempfile.NamedTemporaryFile("w", suffix=".jsonl", delete=False) as f:
        path = f.name
    trace.save(path)
    assert Trace.load(path) == trace
    print(f"trace: {len(trace.jobs)} tenants, {len(trace.failures)} failure "
          f"events (saved to {path})\n")

    cols = ("acceptance_rate", "fragmentation_rejects", "mean_utilization",
            "mean_collective_us", "mean_jct_s", "recoveries", "evicted")
    results = compare(trace, n_chips=N_CHIPS)
    print(f"{'metric':24s} " + " ".join(f"{k:>12s}" for k in results))
    for c in cols:
        vals = " ".join(f"{results[k].summary()[c]:>12}" for k in results)
        print(f"{c:24s} {vals}")

    print("\nfailure stories (LUMORPH):")
    hit = [r for r in results["lumorph"].tenants.values()
           if r.evicted or r.shrunk_to or r.reconfig_windows > 1]
    for rec in hit:
        if rec.evicted:
            fate = "evicted (rack exhausted)"
        elif rec.shrunk_to:
            fate = f"shrunk {rec.requested}→{rec.shrunk_to} chips"
        else:
            fate = f"re-sliced at full width ({rec.requested} chips)"
        print(f"  {rec.tenant}: lost chips → {fate}; {rec.steps_done} steps "
              f"done, {rec.reconfig_windows} MZI windows")
    if not hit:
        print("  (no tenant lost chips in this trace)")


if __name__ == "__main__":
    main()
