"""Where the placed trainer's ``xla`` and ``lumorph4`` runs part, step by step.

Each rank of a data 2 × model 2 world runs both comms' placed train steps
side by side from the same seed-0 state on the same batches (chip_smoke.py
phase 16's bert-large settings: bf16 compute, an fp32 wire, 8 × 128) and,
after every step, compares them leaf by leaf on its own shards: the reduced
gradients that AdamW receives, the global grad norm, the params after the
update and the moments (``xla``'s ZeRO-1 shards gathered over data); and,
gathered from every rank, the leaves of its own shards whose gradients or
sums of squares (the norm's first terms) differ between the comms, with
both leaves' strides, and whose sums of squares of contiguous copies
differ. Rank 0 prints one JSON line per step. On one card over gloo:

  torchrun --nproc-per-node 4 tools/tp_comm_drift.py --dist-backend gloo

and on the CPU at smoke width: ``... tools/tp_comm_drift.py --smoke --device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.bridge import flatten_with_paths  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_at  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch.mesh import init_process_mesh, split_model_axis  # noqa: E402
from repro_torch.launch.train import checked_policy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.sharding.policy import gather_data  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

COMMS = ("xla", "lumorph4")


def _differ(a: list, b: list, paths: list) -> list:
    """(path, max |a − b|) of every leaf pair that is not bit-equal."""
    return [(p, float((x.float() - y.float()).abs().max())) for p, x, y in zip(paths, a, b)
            if not torch.equal(x, y)]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bert-large")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", default=None)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)
    if args.device == "cuda":  # as chip_smoke.py: fp32 products in full fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = split_model_axis(init_process_mesh(args.device, args.dist_backend), 2)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    policy = checked_policy(cfg, mesh)
    opt_cfg = AdamWConfig(total_steps=args.steps, warmup_steps=max(1, args.steps // 20))
    seen: dict = {}
    update = steps_lib.adamw_update

    def recorded(params, grads, state, cfg_):  # what AdamW receives, and its norm
        seen["grads"] = [g.to_local().clone() for g in leaves(grads)]
        seen["norm"] = float(adamw.global_norm(grads))
        # the norm's first terms: each leaf's sum of squares over this rank's shard
        seen["sums"] = [float(torch.sum(torch.square(g.to_local().float())))
                        for g in leaves(grads)]
        # the same of contiguous copies, and each leaf's strides
        seen["sums_contiguous"] = [float(torch.sum(torch.square(
            g.to_local().float().contiguous()))) for g in leaves(grads)]
        seen["strides"] = [g.to_local().stride() for g in leaves(grads)]
        return update(params, grads, state, cfg_)
    steps_lib.adamw_update = recorded
    runs = {}
    for comm in COMMS:
        step = steps_lib.make_train_step(cfg, opt_cfg, comm=comm, dp=mesh.data,
                                         wire_dtype=torch.float32, device=mesh.device,
                                         group=mesh.group, policy=policy, mesh=mesh)
        state = steps_lib.init_train_state(cfg, mesh.data, 0, mesh.device, group=mesh.group,
                                           policy=policy, mesh=mesh, comm=comm)
        runs[comm] = [step, *state]
    paths = [p for p, _ in flatten_with_paths(runs["xla"][1])]
    data = DataConfig(seed=0, global_batch=args.batch, seq_len=args.seq)
    out = []
    for i in range(args.steps):
        batch = batch_at(i, cfg, data)
        got = {}
        for comm, (step, params, opt) in runs.items():
            params, opt, loss = step(params, opt, batch)
            runs[comm][1:] = [params, opt]
            got[comm] = {"loss": float(loss), "norm": seen["norm"], "grads": seen["grads"],
                         "sums": seen["sums"],
                         "sums_contiguous": seen["sums_contiguous"],
                         "strides": seen["strides"],
                         "params": [t.to_local() for t in leaves(params)],
                         # the moments whole over data (xla's ZeRO-1 shards gathered)
                         **{k: [gather_data(t).to_local() for t in leaves(opt[k])]
                            for k in ("m", "v")}}
        x, y = (got[c] for c in COMMS)
        diff = {k: _differ(x[k], y[k], paths) for k in ("grads", "params", "m", "v")}
        rec = {"step": i, "loss": {c: got[c]["loss"] for c in COMMS},
               "loss_equal": x["loss"] == y["loss"],
               "grad_norm": {c: got[c]["norm"] for c in COMMS},
               **{f"{k}_differ": len(d) for k, d in diff.items()},
               **{f"first_{k}": d[:4] for k, d in diff.items()},
               "largest_param_diff": max(diff["params"], key=lambda t: t[1], default=None)}
        # every rank's own shards: the leaves whose reduced gradients or whose sums of
        # squares differ between the comms, gathered to rank 0
        own = {"grads": [p for p, _ in diff["grads"]],
               "sums": [(p, a, b, x["strides"][j], y["strides"][j])
                        for j, (p, a, b) in enumerate(zip(paths, x["sums"], y["sums"]))
                        if a != b],
               "sums_contiguous": [p for p, a, b in zip(paths, x["sums_contiguous"],
                                                       y["sums_contiguous"]) if a != b]}
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, own)
        rec["per_rank"] = [{"grads_differ": len(r["grads"]), "first_grads": r["grads"][:4],
                            "sums_differ": len(r["sums"]), "first_sums": r["sums"][:4],
                            "sums_of_contiguous_copies_differ": r["sums_contiguous"]}
                           for r in ranks]
        out.append(rec)
        if mesh.rank == 0:
            print(json.dumps({"tp_comm_drift": rec, "arch": cfg.name, "device": str(mesh.device),
                              "data": mesh.data, "model": mesh.model}), flush=True)
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
