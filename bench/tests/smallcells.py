"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test can hold: every width
of the configuration shrunk to its model parts' ``SMALL``
(``bench/references/<config>.py``), the traffic's batch and lengths too. The
cut is for tests only; the benchmark runs the files as they are."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [p for p in (str(ROOT), str(ROOT / "src")) if p not in sys.path]

from bench import harness  # noqa: E402

# A four-chip cell whose files are in bench/ but whose entry is not yet in
# BENCHMARK.json (PERF.md, Open questions); it reports what the one-chip
# training cell reports.
HELD = {"bert-large.train-dp4-lumorph4-b1024-s128": dict(
    config="bert-large", traffic="train-dp4-lumorph4-b1024-s128", chips=4,
    like="bert-large.train-b256-s128")}


def load_cell(name: str) -> harness.Cell:
    if name not in HELD:
        return harness.load_cell(name)
    bench, entry = harness.manifest(), dict(HELD[name], name=name)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if entry["like"] in m.get("workloads", []):
            m["workloads"].append(name)
    return harness.make_cell(entry, bench)


def small_sizes(cfg: dict) -> dict:
    """The configuration's sizes in the CPU tests: its model parts' ``SMALL``."""
    small = harness.model_parts(cfg).SMALL
    if small is None:
        raise LookupError(f"bench/references/{cfg['name']}.py gives no SMALL")
    return small


def small_config(name: str, **overrides) -> dict:
    """The configuration file ``name`` at its CPU test sizes."""
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    cfg.update(small_sizes(cfg), **overrides)
    return cfg


def small_cell(name: str, **cfg_overrides) -> harness.Cell:
    cell = load_cell(name)
    cell.cfg.update(small_sizes(cell.cfg), **cfg_overrides)
    if cell.traffic["driver"] == "train":
        cell.traffic.update(global_batch=8 * cell.chips, seq_len=16,
                            reference_rows=4, trace_steps=2)
    else:
        cell.traffic.update(prompt_len=64, sample_from=4, sample_calls=4, reference_rows=16,
                            trace_calls=3)
    return cell


def small_run(name: str, seed: int = 2**31 + 5, seconds: float = 0.5, trace: bool = False,
              rank: int = 0, world: int = 1, rdzv=None, t0=None, **cfg_overrides) -> dict:
    import torch
    run = harness.Run(cell=small_cell(name, **cfg_overrides), seed=seed, seconds=seconds,
                      trace=trace, t0=t0 or time.time(), device=torch.device("cpu"),
                      rank=rank, world=world, rdzv=rdzv)
    return harness.run_driver(run)


if __name__ == "__main__":  # one rank of a small cell on several CPU processes
    import contextlib
    import os

    from bench import faults
    from bench.run import parse
    args = parse(sys.argv[1:])
    fault = os.environ.get("BENCH_TEST_FAULT")  # set by a test that plants one
    with faults.FAULTS["train"][fault][0]() if fault else contextlib.nullcontext():
        out = small_run(args.workload, args.seed, args.seconds, bool(args.trace), args.rank,
                        args.world, args.rdzv, args.t0)
    if out is not None:
        print(json.dumps(out))
