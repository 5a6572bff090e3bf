"""Readings that set a cell's limits for ``correct``, taken on the card at the
cell's own size; the benchmark's runs do not run this.

    python3 bench/control.py --workload <cell> --seed 11,12,13 --seconds 5 \\
        [--what sound,control,half_batch,...]

For each seed it prints the numbers the cell compares, for:

* ``sound``: the program as the benchmark runs it (its set-up and, for a
  serving mix, a window of ``--seconds``);
* ``control``: the plain reference (for a prefill, the configuration's own,
  ``bench.harness.model_parts``) put in the program's place in the precision
  below the configuration's (float8 e4m3 operands for bf16 compute), judged
  by the fp32 reference;
* each fault of ``bench/faults.py`` that the cell can have, planted in the
  program.

The last line of stdout is one JSON object: seed → reading → numbers.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(run, what: list[str]) -> dict:
    from bench import faults, reference
    from bench.drivers import prefill, train
    out = {}
    if run.cell.traffic["driver"] == "train":
        su = train.Setup(run)
        prog, ref = su.free(), su.reference()
        if "sound" in what:
            out["sound"] = train.compare(prog, ref)
            med = sorted(ref["grad_norms"])[len(ref["grad_norms"]) // 2]
            out["reference"] = {"leaves": len(ref["grad_norms"]), "left_out_of_update_gap": sum(
                g < 1e-3 * med for g in ref["grad_norms"])}
        if "control" in what:
            out["control"] = train.compare(su.reference(reference.FP8), ref)
        for name, fault in faults.faults_for("train", run.world).items():
            if name in what:
                with fault():
                    out[name] = train.compare(train.Setup(run).free(), ref)
        return {k: dict(zip(v, su.max_over_ranks(list(v.values())))) for k, v in out.items()}

    def window(su):
        t_end = time.perf_counter() + run.seconds
        while time.perf_counter() < t_end or su.n < run.cell.traffic["sample_from"]:
            su.call()
        su.free()
        return su.sample()
    su = prefill.Setup(run)
    prompts, served = window(su)
    if "sound" in what:
        out["sound"] = {"token_gap": su.gap(prompts, served)}
    if "control" in what:
        out["control"] = {"token_gap": su.gap(prompts, None, reference.FP8)}
    for name, fault in faults.faults_for("prefill", 1).items():
        if name in what:
            with fault():
                faulty = prefill.Setup(run)
                got = window(faulty)
            out[name] = {"token_gap": su.gap(*got)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, help="seeds, comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--trace", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--what", default="sound,control,state_unchanged,half_batch,no_exchange,"
                                      "altered_answer")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--rdzv", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import harness
    cell = harness.load_cell(args.workload)
    if cell.chips > 1 and args.rank is None:
        entry = [sys.executable, __file__, "--what", args.what]
        out = harness.spawn_ranks(args, cell.chips, T0, entry)
        print(json.dumps(out))
        return 0 if out is not None else 1
    rank = args.rank or 0
    out = {}
    for seed in (int(s) for s in args.seed.split(",")):
        run = harness.Run(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                          t0=args.t0 or T0, device=torch.device("cuda", rank), rank=rank,
                          world=args.world, rdzv=args.rdzv)
        out[seed] = readings(run, args.what.split(","))
        if rank == 0:
            print(json.dumps({seed: out[seed]}), file=sys.stderr, flush=True)
    harness.leave_group()
    if rank == 0:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
