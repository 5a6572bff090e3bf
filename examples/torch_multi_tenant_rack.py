"""Multi-tenant rack walkthrough (paper Fig 2): tenants of awkward sizes
share one 64-chip LUMORPH rack; each gets the *optimal* collective for its
size (recursive doubling/halving or quartering for powers of two, Ring
otherwise), with validated circuit schedules; a torus rack fragments on
the same trace.

The twin of ``examples/multi_tenant_rack.py`` on the port's modules, line
for line: it prints what the JAX example prints. Host code; it takes no device.

Run:  PYTHONPATH=src python examples/torch_multi_tenant_rack.py
"""

from repro_torch.core import cost_model as cm
from repro_torch.core.allocator import AllocationError, LumorphAllocator, TorusAllocator
from repro_torch.core.rack import default_rack
from repro_torch.core.scheduler import build_schedule
from repro_torch.core.sipac import configure_sipac_on_lumorph, emulation_is_exact


def main():
    rack = default_rack(n_chips=64, tiles_per_server=8,
                        fibers_per_server_pair=64)
    lum = LumorphAllocator(64, tiles_per_server=8)
    tor = TorusAllocator((4, 4, 4))

    tenants = [("user1", 6), ("user2", 16), ("user3", 3), ("user4", 4),
               ("user5", 9), ("user6", 8)]
    print(f"{'tenant':8s} {'k':>3s}  {'LUMORPH':28s} {'torus':8s}  collective")
    for name, k in tenants:
        try:
            a = lum.allocate(name, k)
            lu = f"chips {a.chips[0]}..{a.chips[-1]} ({len(a.chips)})"
        except AllocationError as e:
            lu = f"REJECTED"
            a = None
        try:
            t = tor.allocate(name, k)
            to = f"{len(t.chips)} chips" + (f" (+{t.overallocated} wasted)" if t.overallocated else "")
        except AllocationError:
            to = "REJECTED"
        algo = "lumorph4" if k & (k - 1) == 0 else "ring"
        line = f"{name:8s} {k:3d}  {lu:28s} {to:18s} {algo}"
        if a:
            sched = build_schedule(algo, a.chips, 4 << 20)
            sched.validate(rack)
            cost = sched.cost(cm.LUMORPH_LINK)
            line += f" ({len(sched.rounds)} rounds, {cost*1e6:.0f}µs for 4MB)"
        print(line)

    print(f"\nLUMORPH utilization: {lum.utilization:.0%}   "
          f"torus utilization: {tor.utilization:.0%}")

    # Fig 3: user2's 16 chips reconfigured into SiPAC(2,4)-equivalent? Show (2,3) on 8 of them.
    chips8 = lum.allocations["user2"].chips[:8]
    configure_sipac_on_lumorph(rack, chips8, 2, 3)
    print(f"SiPAC(2,3) emulated on chips {chips8}: "
          f"exact={emulation_is_exact(rack, chips8, 2, 3)} "
          f"(one MZI window, {rack.reconfig_time*1e6:.1f}µs)")


if __name__ == "__main__":
    main()
