"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The twin of ``repro.launch.train``, with every one of its flags: builds
the model, the sharding policy, the LUMORPH gradient-communication backend
and the deterministic data stream, and runs a checkpointed training loop,
restarting from the latest checkpoint. It runs on ``cuda`` unless given
``--device cpu``; ``--smoke`` takes the reduced config. ``--comm auto``
picks each gradient bucket's schedule from the α–β cost model.

Two meshes (:mod:`repro_torch.launch.mesh`):
  * launched by ``torchrun`` (or with a process group already made), every
    rank is its own process and the gradient collectives cross processes
    (:mod:`repro_torch.core.collectives_dist`). ``--data-parallel D`` for a
    D that divides the world lays the ranks out as data D × model
    world / D, as the JAX trainer lays out its devices; 0 is the world
    (model 1), and a D that does not divide exits. Under a model axis every
    leaf is a DTensor placed by the sharding policy (TP over model, ZeRO-1
    moments over data under ``--comm xla``, and params over data where
    ``make_policy`` picks ZeRO-3), and the gradients are reduced
    over each rank's data group. ``--dist-backend`` is ``nccl`` on ``cuda``
    and ``gloo`` on ``cpu`` unless given; on one card only ``gloo`` runs
    several ranks, its payloads staged through host memory. Rank 0 prints
    the result and writes the checkpoints;
  * otherwise ``--data-parallel`` virtual ranks on one device.

The sharding policy is made on the mesh and checked: every spec of every
parameter and optimizer leaf must divide. ``main(argv, zero3=...)`` passes
``make_policy``'s ``zero3`` (``None``: its own rule) from a Python caller;
the CLI has no flag for it, as the JAX trainer has none; ``flat_dp=True``
passes ``make_policy``'s ``flat_dp`` alike (the whole process mesh data
parallel, its gradients reduced over the world). Placed, the result also
holds each param's local shape on this rank at the end and the params that
a data axis then shards (``local_params``). With ``--mesh single|multi``
the trainer makes and checks the policy of the production mesh; under
torchrun with a world of exactly its size (256 or 512 ranks) it lays the
world out as that mesh (:func:`repro_torch.launch.mesh.lay_out_mesh`, the
multi-pod one as pod 2 × data 16 × model 16, its gradients reduced over
``("pod", "data")``) and trains; otherwise it exits.

Checkpoints hold rank 0's params and optimizer state, and a restore gives
every rank that copy, as the JAX trainer does: its ``save`` writes
``jax.device_get`` of the replicated state, which is device 0's copy, and
its restored state is replicated. Under ``--compress`` the ranks differ,
so a restart makes them equal again. Under a model axis the checkpoint
holds full tensors, gathered by every rank and written by rank 0, and a
restore places them again by the specs.

Example (the paper's regime: BERT, data-parallel, LUMORPH-4 collectives,
chunked into 4 overlapped waves per bucket, with checkpoints):
  PYTHONPATH=src python -m repro_torch.launch.train --arch bert-large \\
      --comm lumorph4 --overlap 4 --data-parallel 4 --steps 6 --batch 8 \\
      --seq 128 --ckpt-dir /tmp/ck --ckpt-every 3
The same with every rank its own process, four of them on the CPU, laid
out as data 2 × model 2:
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch bert-large --smoke --device cpu --data-parallel 2 --comm lumorph4
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch.bridge import flatten_with_paths
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import torch_dtype
from repro_torch.data.pipeline import DataConfig, stream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (ProcessMesh, init_process_mesh, launched_by_torchrun,
                                     lay_out_mesh, make_host_mesh, make_production_mesh)
from repro_torch.models.transformer import param_shapes
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding.policy import MeshShape, data_dims, make_policy
from repro_torch.tree import tree_map

MESH_NEEDS_RANKS = ("the sharding policy of the {mesh} production mesh {shape} is valid for "
                    "{arch} (tp={tp}, dp={dp}, zero3={zero3}); training on it needs {ranks} "
                    "ranks, one per card, under torchrun ({have})")
DP_NOT_DIVIDES = ("--data-parallel {dp} does not divide a world of {world} ranks: the model "
                  "axis is world / data ranks wide; pass a divisor of {world} (0: the world)")


def checked_policy(cfg, mesh, zero3=None, flat_dp: bool = False):
    """``make_policy(cfg, mesh, zero3, flat_dp)``, with every param and
    optimizer spec checked to divide its leaf (shapes on the meta device)."""
    policy = make_policy(cfg, mesh, zero3=zero3, flat_dp=flat_dp)
    shapes = param_shapes(cfg)
    policy.check_divides(shapes, policy.param_spec)
    policy.check_divides(steps_lib.opt_shapes(cfg, shapes), policy.opt_spec)
    return policy


def _rank0(state):
    """Rank 0's copy of a per-rank state: what the JAX trainer's checkpoint holds."""
    return tree_map(lambda t: t[0], state)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, zero3=None, flat_dp: bool = False) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--comm", default="xla",
                    choices=["xla", "ring", "lumorph2", "lumorph4", "auto"])
    ap.add_argument("--compress", action="store_true", help="int8 grad collectives")
    ap.add_argument("--overlap", type=int, default=1, metavar="CHUNKS",
                    help="chunked/pipelined grad collectives: split every "
                         "bucket into CHUNKS waves (LUMORPH backends only; "
                         "1 = monolithic; issued on one stream)")
    ap.add_argument("--bucket-mb", type=int, default=25)
    ap.add_argument("--wire-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="gradient collective payload dtype")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="host", choices=["host", "single", "multi"])
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="dp ranks: under torchrun a divisor of the world, the rest "
                         "forming the model axis (0 = the world); else virtual ranks "
                         "(0 = one per visible device)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend under torchrun (default: nccl on cuda, "
                         "gloo on cpu; gloo stages CUDA payloads through host memory)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.overlap > 1 and args.comm == "xla":
        raise SystemExit("--overlap needs a LUMORPH comm backend "
                         "(ring/lumorph2/lumorph4/auto), not xla")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = None
    if args.mesh != "host":
        shape = make_production_mesh(multi_pod=(args.mesh == "multi"))
        policy = checked_policy(cfg, shape, zero3, flat_dp)
        ranks = math.prod(shape.axis_sizes)
        world = _torchrun_world()
        if world != ranks:
            raise SystemExit(MESH_NEEDS_RANKS.format(
                mesh=args.mesh, shape=shape.shape, arch=cfg.name, tp=policy.tp, dp=policy.dp,
                zero3=policy.zero3, ranks=ranks,
                have="no torchrun world" if world is None else f"a world of {world}"))
    if launched_by_torchrun():
        made_group = not dist.is_initialized()
        mesh = init_process_mesh(args.device, args.dist_backend)
        try:
            if shape is None:
                if args.data_parallel < 0 or (args.data_parallel and
                                              mesh.world % args.data_parallel):
                    raise SystemExit(DP_NOT_DIVIDES.format(dp=args.data_parallel,
                                                           world=mesh.world))
                data = args.data_parallel or mesh.world
                shape = MeshShape(("data", "model"), (data, mesh.world // data))
            return _train(args, cfg, lay_out_mesh(mesh, shape, flat_dp), zero3, flat_dp)
        finally:
            if made_group:
                dist.destroy_process_group()
    dev = resolve_device(args.device)
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    return _train(args, cfg, make_host_mesh(args.data_parallel or visible, dev), zero3,
                  flat_dp)


def _torchrun_world():
    """The world's size under torchrun (or a process group made), else None."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ["WORLD_SIZE"]) if launched_by_torchrun() else None


def _train(args, cfg, mesh, zero3=None, flat_dp: bool = False) -> dict:
    """The training loop on a virtual or a process mesh."""
    group = mesh.group if isinstance(mesh, ProcessMesh) else None
    lead = group is None or mesh.rank == 0  # prints, and writes the checkpoints
    policy = checked_policy(cfg, mesh, zero3, flat_dp)
    placed = steps_lib.placed(mesh)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))
    train_step = steps_lib.make_train_step(
        cfg, opt_cfg, comm=args.comm, dp=mesh.data,
        bucket_bytes=args.bucket_mb * 1024 * 1024, compress=args.compress,
        wire_dtype=torch_dtype(args.wire_dtype), overlap_chunks=args.overlap,
        device=mesh.device, group=group, policy=policy, mesh=mesh)
    params, opt_state = steps_lib.init_train_state(
        cfg, mesh.data, args.seed, mesh.device,
        init_ef=args.compress and args.comm != "xla", group=group, policy=policy, mesh=mesh,
        comm=args.comm)

    start_step = 0
    if args.ckpt_dir and ckpt_lib.latest_step(args.ckpt_dir) is not None:
        if group is not None:  # every rank restores the same step
            (params, opt_state), start_step = ckpt_lib.restore(args.ckpt_dir,
                                                               (params, opt_state))
        else:
            rank0, start_step = ckpt_lib.restore(args.ckpt_dir, _rank0((params, opt_state)))
            params, opt_state = tree_map(lambda t: t.expand(mesh.data, *t.shape).clone(),
                                         rank0)
            del rank0
        if lead:
            print(f"[train] restored checkpoint at step {start_step}", flush=True)

    dev = mesh.device
    data = DataConfig(seed=args.seed, global_batch=args.batch, seq_len=args.seq)
    losses, step_s = [], []
    t_start = time.perf_counter()
    for step, batch in stream(cfg, data, start_step):
        if step >= args.steps:
            break
        _sync(dev)
        t0 = time.perf_counter()
        params, opt_state, loss = train_step(params, opt_state, batch)
        losses.append(float(loss))  # waits for the step's last kernel
        step_s.append(time.perf_counter() - t0)
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"[train] step={step:5d} loss={losses[-1]:.4f} "
                  f"({(time.perf_counter() - t_start) / (step - start_step + 1):.2f}s/step)",
                  flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            if group is None:
                ckpt_lib.save(args.ckpt_dir, step + 1, _rank0((params, opt_state)))
            else:  # under a model axis every rank gathers, and rank 0 writes
                ckpt_lib.save(args.ckpt_dir, step + 1, (params, opt_state), write=lead)
                dist.barrier()  # no rank reads a checkpoint half written
    result = {"final_loss": losses[-1] if losses else None,
              "first_loss": losses[0] if losses else None,
              "steps": len(losses), "comm": args.comm,
              "overlap": args.overlap, "device": str(dev),
              "step_s": statistics.median(step_s) if step_s else None}
    if group is not None:
        result.update(world=mesh.world, dist_backend=mesh.backend)
        if placed:
            result.update(data=mesh.data, model=mesh.model, local_params={
                "shapes": {p: list(t.to_local().shape) for p, t in flatten_with_paths(params)},
                "over_data": [p for p, t in flatten_with_paths(params)
                              if any(t.placements[i].is_shard()
                                     for i in data_dims(t.device_mesh, policy.axes.data))]})
            if mesh.pod > 1:
                result["pod"] = mesh.pod
            if mesh.flat_dp:
                result["flat_dp"] = True
    if lead:
        print(json.dumps(result))
    return result

if __name__ == "__main__":
    main()
