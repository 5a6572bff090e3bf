"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The twin of ``repro.launch.train``, with its flags: builds the model, the
LUMORPH gradient-communication backend and the deterministic data stream,
and runs the training loop on ``--data-parallel`` virtual ranks on one
device (:mod:`repro_torch.launch.mesh`). It runs on ``cuda`` unless given
``--device cpu``; ``--smoke`` takes the reduced config.

Example (the paper's regime: BERT, data-parallel, LUMORPH-4 collectives):
  PYTHONPATH=src python -m repro_torch.launch.train --arch bert-large \\
      --comm lumorph4 --data-parallel 4 --steps 6 --batch 8 --seq 128

Not ported yet, and refused rather than ignored: ``--comm auto``,
``--overlap`` above 1, ``--ckpt-dir`` and ``--mesh single|multi``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import torch_dtype
from repro_torch.data.pipeline import DataConfig, stream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.adamw import AdamWConfig

_NOT_PORTED = {
    "comm": "--comm auto (per-bucket α–β algorithm selection) is not ported yet "
            "(ROADMAP Queue 1 item 7)",
    "overlap": "--overlap CHUNKS > 1 (chunked, pipelined collectives) is not ported yet "
               "(ROADMAP Queue 1 item 10)",
    "ckpt": "--ckpt-dir (checkpoint and restart) is not ported yet (ROADMAP Queue 1 item 9)",
    "mesh": "--mesh single|multi (production meshes) is not ported yet; the port trains "
            "on a virtual data-parallel mesh on one device (ROADMAP Queue 1 item 13)",
}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
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
                    help="chunked/pipelined grad collectives (not ported: 1 only)")
    ap.add_argument("--bucket-mb", type=int, default=25)
    ap.add_argument("--wire-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="gradient collective payload dtype")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="host", choices=["host", "single", "multi"])
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="virtual dp ranks (0 = one per visible device)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.comm == "auto":
        raise SystemExit(_NOT_PORTED["comm"])
    if args.overlap > 1:
        if args.comm == "xla":
            raise SystemExit("--overlap needs a LUMORPH comm backend "
                             "(ring/lumorph2/lumorph4/auto), not xla")
        raise SystemExit(_NOT_PORTED["overlap"])
    if args.ckpt_dir:
        raise SystemExit(_NOT_PORTED["ckpt"])
    if args.mesh != "host":
        raise SystemExit(_NOT_PORTED["mesh"])

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    mesh = make_host_mesh(args.data_parallel or visible, dev)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))
    train_step = steps_lib.make_train_step(
        cfg, opt_cfg, comm=args.comm, dp=mesh.data,
        bucket_bytes=args.bucket_mb * 1024 * 1024, compress=args.compress,
        wire_dtype=torch_dtype(args.wire_dtype), device=mesh.device)
    params, opt_state = steps_lib.init_train_state(
        cfg, mesh.data, args.seed, mesh.device,
        init_ef=args.compress and args.comm != "xla")

    data = DataConfig(seed=args.seed, global_batch=args.batch, seq_len=args.seq)
    losses, step_s = [], []
    t_start = time.perf_counter()
    for step, batch in stream(cfg, data, 0):
        if step >= args.steps:
            break
        _sync(dev)
        t0 = time.perf_counter()
        params, opt_state, loss = train_step(params, opt_state, batch)
        losses.append(float(loss))  # waits for the step's last kernel
        step_s.append(time.perf_counter() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step={step:5d} loss={losses[-1]:.4f} "
                  f"({(time.perf_counter() - t_start) / (step + 1):.2f}s/step)", flush=True)
    result = {"final_loss": losses[-1] if losses else None,
              "first_loss": losses[0] if losses else None,
              "steps": len(losses), "comm": args.comm,
              "overlap": args.overlap, "device": str(dev),
              "step_s": statistics.median(step_s) if step_s else None}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
