"""Online slice morphing walkthrough: defragment a live rack.

The twin of ``examples/morph_rack.py`` on the port's modules, line for line: it
prints what the JAX example prints. Host code; it takes no device.

Three acts, all on a 64-chip LUMORPH rack with scarce inter-server
fibers (2 per server pair, so placement is priced):

  1. **plan** — fragment a rack by hand, then ask `repro_torch.morph` for a
     compaction plan and print its moves, its Schedule-IR price, and the
     collective cost before/after.
  2. **bypass** — kill chips under a nearly-full rack and compare the
     elastic shrink-to-pow2 restart with a live failure bypass.
  3. **simulate** — replay one churn trace (Fig 2a mix + departures +
     failures) with and without morphing and print the side-by-side.

Run:  PYTHONPATH=src python examples/torch_morph_rack.py
"""

from repro_torch.core import cost_model as cm
from repro_torch.core.allocator import LumorphAllocator
from repro_torch.core.fabric import LumorphRack
from repro_torch.morph import MorphConfig, MorphPolicy, execute
from repro_torch.sim import RackSimulator
from repro_torch.sim.workload import fig2a_trace

TILES = 8
LINK = cm.LUMORPH_LINK


def act1_compaction():
    print("=== act 1: compaction plan ===")
    # a 2-server rack where two half-server tenants force the third
    # across the seam (no single server has 8 chips free)
    rack = LumorphRack(n_servers=2, tiles_per_server=TILES,
                       fibers_per_server_pair=1)
    alloc = LumorphAllocator(16, tiles_per_server=TILES)
    alloc.allocate("a", 4)
    alloc.allocate("b", 4)
    frag = alloc.allocate("frag", 8)
    alloc.release("a")  # departure scatters the free pool
    policy = MorphPolicy(MorphConfig(), rack=rack, link=LINK,
                         algos=("ring", "lumorph2", "lumorph4"),
                         tiles_per_server=TILES)
    print(f"  frag holds {frag.chips} "
          f"(servers {sorted({c // TILES for c in frag.chips})})")
    pm = policy.propose_compaction("frag", frag.chips, 8, float(4 << 20),
                                   remaining_steps=500,
                                   free=sorted(alloc.free))
    if pm is None:
        print("  policy: no profitable compaction")
        return
    p = pm.plan
    print(f"  moves: {list(p.moves)}  (state replayed as Schedule-IR Transfers)")
    print(f"  morph cost: {pm.cost.total_s * 1e6:.2f} µs "
          f"({pm.cost.reconfig_windows} MZI windows, "
          f"{pm.cost.bytes_moved / 1e6:.1f} MB moved)")
    print(f"  per-step ALLREDUCE: {pm.old_step_s * 1e6:.2f} µs → "
          f"{pm.new_step_s * 1e6:.2f} µs "
          f"(pays off after {pm.cost.total_s / pm.step_gain_s:.0f} steps)")
    execute(alloc, p, LINK, rack=rack)
    got = alloc.allocations["frag"].chips
    print(f"  committed: frag now on {got} "
          f"(servers {sorted({c // TILES for c in got})})\n")


def act2_bypass():
    print("=== act 2: failure bypass vs elastic shrink ===")
    from repro_torch.runtime.fault_tolerance import ElasticJob

    for allow_bypass in (False, True):
        alloc = LumorphAllocator(64, tiles_per_server=TILES)
        job = ElasticJob(alloc, "victim", 12)
        alloc.allocate("filler", 48)  # free pool: 4 chips
        dead = list(job.chips[:5])  # burst: more dead than spares
        rec = job.on_failure(step=10, failed_chips=dead,
                             allow_bypass=allow_bypass)
        mode = "bypass " if allow_bypass else "elastic"
        print(f"  {mode}: {rec.reason:12s} width 12 → {len(job.chips)}")
    print()


def act3_simulate():
    print("=== act 3: churn with and without morphing ===")
    trace = fig2a_trace(400, failure_rate=0.03, n_chips=64, seed=0)
    runs = {}
    for name, morph in (("static", None), ("morph", True)):
        runs[name] = RackSimulator("lumorph", trace, n_chips=64,
                                   fibers_per_server_pair=2,
                                   morph=morph).run().summary()
    keys = ("acceptance_rate", "mean_collective_us", "mean_locality",
            "compactions", "bypasses", "morph_s", "recoveries", "evicted")
    print(f"  {'metric':22s} {'static':>12s} {'morph':>12s}")
    for k in keys:
        print(f"  {k:22s} {runs['static'][k]:>12} {runs['morph'][k]:>12}")


if __name__ == "__main__":
    act1_compaction()
    act2_bypass()
    act3_simulate()
