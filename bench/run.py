"""Run one cell of the benchmark of ``repro_torch`` (the PyTorch and CUDA port).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with at least the cell's number of
CUDA cards. It prints, as the last line of stdout, one JSON object: whether
the timed path's outputs held against the plain reference (``correct``), the
units attempted and failed in the window, the cell's end-to-end metrics
(``--trace 0``) or per-layer metrics (``--trace 1``, with ``breakdown``), the
device, and the numbers compared beside their limits (``checks``, last).
Without enough cards, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits 2.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # one rank of a cell on several chips, as the harness spawns it
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--rdzv", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        raise harness.Refused(f"{args.workload} needs {cell.chips} CUDA card(s); "
                              f"this machine has {torch.cuda.device_count()}")
    if cell.chips > 1 and args.rank is None:
        result = harness.spawn_ranks(args, cell.chips, T0, [sys.executable, __file__])
    else:
        rank = args.rank or 0
        run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), t0=args.t0 or T0,
                          device=torch.device("cuda", rank), rank=rank, world=args.world,
                          rdzv=args.rdzv)
        result = harness.run_driver(run)
        harness.leave_group()
    found = harness.forbidden_modules()
    if found:
        raise harness.Refused(f"loaded in the process that prints the result: {found}")
    if result is not None:
        harness.print_result(result)
    return 0 if result is not None or (args.rank or 0) != 0 else 1


if __name__ == "__main__":
    sys.exit(main())
