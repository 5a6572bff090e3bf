"""Paper Fig 4a scenario on the port, end to end: BERT data-parallel training
where the gradient ALLREDUCE runs on LUMORPH circuit schedules — plus the
full production loop: checkpointing, a simulated chip failure, elastic
re-allocation, and restart from the checkpoint.

The twin of ``examples/train_bert_lumorph.py``: the 8 data-parallel ranks
are the port's virtual ranks (``--data-parallel 8``), in place of JAX's 8
fake devices.

Run:  PYTHONPATH=src python examples/torch_train_bert_lumorph.py [--device cpu]
(on ``cuda`` by default).
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.core.allocator import LumorphAllocator
from repro_torch.launch import train
from repro_torch.runtime.fault_tolerance import ElasticJob, recovery_cost_model

TRAIN = ["--arch", "bert-large", "--smoke", "--batch", "8", "--seq", "128", "--comm", "auto",
         "--data-parallel", "8", "--ckpt-every", "10", "--log-every", "5"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None, help="default: a new temporary directory")
    args = ap.parse_args(argv)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="bert_lumorph_")
    flags = TRAIN + ["--ckpt-dir", ckpt, "--device", args.device]
    out = {}

    # phase 1: train 20 steps with per-bucket auto-selected LUMORPH collectives
    print("=== phase 1: steps 0-19 (comm=auto: per-bucket LUMORPH-2/4/Ring) ===")
    out["phase1"] = train.main(flags + ["--steps", "20"])

    # phase 2: a chip dies; the LUMORPH allocator rebuilds the slice from
    # any surviving free chips (fragmentation-free recovery, paper §3)
    print("\n=== phase 2: chip failure + elastic re-allocation ===")
    alloc = LumorphAllocator(64, tiles_per_server=8)
    job = ElasticJob(alloc, "bert-train", 8)
    before = job.chips
    print(f"slice before failure: {job.chips}")
    rec = job.on_failure(step=20, failed_chips=[job.chips[0], job.chips[3]])
    print(f"recovery: {rec.reason}; new slice: {job.chips} (dp={job.dp_width})")
    cost = recovery_cost_model(n_params=340e6, dp=job.dp_width)
    print(f"recovery cost: read {cost['read_s']:.2f}s + "
          f"broadcast {cost['broadcast_s']*1e3:.2f}ms")
    out["phase2"] = {"before": before, "after": job.chips, "dp": job.dp_width,
                     "reason": rec.reason, "cost": cost}

    # phase 3: restart from the checkpoint (data stream resumes exactly)
    print("\n=== phase 3: restart from checkpoint, steps 20-29 ===")
    out["phase3"] = train.main(flags + ["--steps", "30"])
    print(f"\ncheckpoints in {ckpt}")
    out["ckpt_dir"] = ckpt
    return out


if __name__ == "__main__":
    main()
