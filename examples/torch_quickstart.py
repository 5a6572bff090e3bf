"""Quickstart on the port: the LUMORPH stack in five minutes.

The twin of ``examples/quickstart.py``:

1. model a LIGHTPATH rack and allocate two tenants (no fragmentation),
2. build + validate a LUMORPH-4 circuit schedule for tenant 1's ALLREDUCE,
3. price it with the α–β model vs Ring on an ideal electrical switch,
4. run the *executable* collectives on 8 virtual ranks (the port's executor,
   ``core.collectives``, in place of JAX's 8 fake devices) and check them
   against the sum,
5. train bert-large (smoke config) for a few steps with LUMORPH-4 gradient
   collectives over 8 virtual ranks.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(training on ``cuda`` by default). Returns (and prints) each step's results.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core.allocator import LumorphAllocator
from repro_torch.core.collectives import all_reduce
from repro_torch.core.rack import default_rack
from repro_torch.core.scheduler import build_schedule, fiber_demand, order_for_locality
from repro_torch.device import resolve_device
from repro_torch.launch import train

TRAIN = ["--arch", "bert-large", "--smoke", "--steps", "10", "--batch", "8", "--seq", "64",
         "--comm", "lumorph4", "--data-parallel", "8", "--log-every", "5"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    # -- 1. rack + tenants ---------------------------------------------------
    # LUMORPH-4's high-stride rounds open up to 2·(chips/server)·(r−1)
    # circuits across a server pair — provision fibers accordingly (§3:
    # "given enough fibers between servers").
    rack = default_rack(n_chips=64, tiles_per_server=8, fibers_per_server_pair=32)
    alloc = LumorphAllocator(64, tiles_per_server=8)
    t1 = alloc.allocate("tenant-1", 16)
    t2 = alloc.allocate("tenant-2", 6)  # non-power-of-two: Ring tenant
    print(f"tenant-1 chips: {t1.chips}")
    print(f"tenant-2 chips: {t2.chips} (6 chips → Ring ALLREDUCE)")
    out["tenants"] = {"tenant-1": t1.chips, "tenant-2": t2.chips}

    # -- 2. circuit schedule ---------------------------------------------------
    chips = order_for_locality(t1.chips, tiles_per_server=8)
    sched = build_schedule("lumorph4", chips, n_bytes=8 << 20)
    sched.validate(rack)
    out["schedule"] = {"rounds": len(sched.rounds), "reconfigurations": sched.reconfigurations(),
                       "fiber_demand": fiber_demand(sched, 8)}
    print(f"LUMORPH-4 over 16 chips: {len(sched.rounds)} rounds, "
          f"{sched.reconfigurations()} MZI reconfigurations, "
          f"peak fiber demand {fiber_demand(sched, 8)}/pair")

    # -- 3. α–β pricing --------------------------------------------------------
    ours = sched.cost(cm.LUMORPH_LINK)
    ring = cm.algorithm_cost("ring", 8 << 20, 16, cm.IDEAL_SWITCH)
    out["price_s"] = {"lumorph4": ours, "ideal_switch_ring": ring}
    print(f"8MB ALLREDUCE: LUMORPH-4 {ours*1e6:.1f}µs vs ideal-switch Ring "
          f"{ring*1e6:.1f}µs → {1 - ours/ring:.0%} faster")

    # -- 4. executable collectives on 8 virtual ranks ----------------------------
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 1000).astype(np.float32)).to(dev)
    out["exact"] = {}
    for algo in ("ring", "lumorph2", "lumorph4"):
        got = all_reduce(x, algo)
        ok = bool(torch.allclose(got[0], x.sum(0), rtol=1e-5, atol=1e-5))
        out["exact"][algo] = ok
        print(f"executable {algo:9s} == sum: {ok}")

    # -- 5. tiny training run --------------------------------------------------
    print("\ntraining bert-large (smoke config) with LUMORPH-4 gradients …")
    out["train"] = train.main(TRAIN + ["--device", args.device])
    return out


if __name__ == "__main__":
    main()
