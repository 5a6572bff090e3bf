#!/usr/bin/env python3
"""The hand-written kernels alone on the card: chip_smoke.py's phases 1 and 2
and its flash check at whisper's shape, for iterating on a kernel without
running the whole script; then the LayerNorm pair in bert-large's training step.

    python3 tools/kernel_probe.py [--steps N]

Builds every kernel from ``src/repro_torch/kernels/csrc``, prints the flash,
RMSNorm and LayerNorm entries' ptxas reports and the flash SASS counts, holds
the flash kernels on phase 2's shapes and fp32 at large score magnitudes, and
RMSNorm and LayerNorm on their cases, against their plain versions, then times
them at phase 2's shapes beside the plain version and one PyTorch call. Then it
counts the LayerNorm launches of one bert-large training step (``LN_STEP``) and
of a 2-layer h2o-danube-1.8b prefill (none), and times bert-large's whole
training step as the benchmark composes it with the kernels and with the plain
LayerNorm, in turns (plain, kernels, kernels, plain; ``--steps`` a turn, 0
skips this): at 256 × 128, and at 16 × 128, where the host's issue sets the
pace. One JSON object per line; exits non-zero without a card or where a
kernel disagrees.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def large_score_checks(ops, gen) -> list:
    """fp32 with q and k scaled by √6 (scaled scores of std 6, extremes near
    ±30), GQA and a window, at D = 64, 80 and 128, within 1e-4 of plain."""
    out = []
    for b, sq, h, kv, d, window in ((2, 1024, 8, 2, 64, 256), (2, 1024, 32, 8, 80, 512),
                                    (1, 1024, 48, 8, 128, 300)):
        q, k, v = (torch.randn(s, generator=gen, device="cuda")
                   for s in ((b, sq, h, d), (b, sq, kv, d), (b, sq, kv, d)))
        q, k = q * 6 ** 0.5, k * 6 ** 0.5
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        plain = ops.flash_attention_plain(q, k, v, causal=True, window=window)
        err = float((got - plain).abs().max())
        out.append({"shape": [b, sq, sq, h, kv, d, True, window], "dtype": "float32",
                    "score_scale": 6 ** 0.5, "max_abs_err": err, "tol": 1e-4})
        assert torch.isfinite(got).all() and err <= 1e-4, out[-1]
    return out


def layernorm_launches(ops, smoke) -> None:
    """The LayerNorm launches of one bert-large training step on one rank (the loss
    and its gradients, each block recomputed) and of a 2-layer danube prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.tree import leaves

    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = get_config("bert-large")
    params = tf.init_params(gen, cfg)
    weights = [p.requires_grad_() for p in leaves(params)]
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda", generator=gen)
    n0 = dict(ops.LAUNCHES)
    loss = tf.loss_fn(params, {"tokens": toks}, cfg)
    torch.autograd.grad(loss, weights)
    torch.cuda.synchronize()
    step = {k: ops.LAUNCHES[k] - n0[k] for k in smoke.LN_STEP}
    print(json.dumps({"layernorm_launches": "bert-large step", **step}), flush=True)
    assert step == smoke.LN_STEP, step
    del params, weights, loss
    danube = get_config("h2o-danube-1.8b")
    danube = danube.replace(n_layers=2, block_pattern=danube.block_pattern[:2], use_pallas=True)
    params = tf.init_params(gen, danube)
    n0 = dict(ops.LAUNCHES)
    with torch.no_grad():
        tf.forward_logits(params, {"tokens": torch.zeros(2, 512, dtype=torch.long,
                                                           device="cuda")}, danube)
    torch.cuda.synchronize()
    pre = {k: ops.LAUNCHES[k] - n0[k] for k in smoke.LN_STEP}
    print(json.dumps({"layernorm_launches": "h2o-danube-1.8b prefill", **pre}), flush=True)
    assert not any(pre.values()), pre
    del params
    torch.cuda.empty_cache()


def step_times(steps: int) -> None:
    """bert-large's whole training step as the benchmark composes it (one rank,
    ``--comm xla``, AdamW), with the LayerNorm kernels and with the plain version
    (``layers.on_card`` false), in turns: device ms a step (CUDA events over
    back-to-back steps) and wall ms a step (synchronised), at 256 × 128 and 16 × 128."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import checked_policy
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.tree import leaves, unflatten

    cfg = get_config("bert-large")
    mesh = make_host_mesh(1, torch.device("cuda"))
    step = steps_lib.make_train_step(
        cfg, AdamWConfig(warmup_steps=5, total_steps=100), comm="xla", dp=mesh.data,
        bucket_bytes=25 * 1024 * 1024, wire_dtype=torch.bfloat16, device=mesh.device,
        group=None, policy=checked_policy(cfg, mesh), mesh=mesh)
    gen = torch.Generator(device="cuda").manual_seed(1)
    weights = tf.init_params(gen, cfg)
    params = unflatten(weights, [t.view((1,) + t.shape) for t in leaves(weights)])
    opt = init_opt_state(params, lead=(1,))
    toks = {b: torch.randint(0, cfg.vocab_size, (b, 128), device="cuda", generator=gen)
            for b in (256, 16)}
    kernel_route = layers.on_card
    try:
        for side in ("plain", "kernels", "kernels", "plain"):
            layers.on_card = kernel_route if side == "kernels" else (lambda x: False)
            rec = {"side": side}
            for b, tok in toks.items():
                for _ in range(2):  # warm
                    params, opt, _ = step(params, opt, {"tokens": tok})
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                for _ in range(steps):
                    params, opt, _ = step(params, opt, {"tokens": tok})
                end.record()
                torch.cuda.synchronize()
                rec[f"b{b}_wall_ms"] = (time.perf_counter() - t0) / steps * 1e3
                rec[f"b{b}_device_ms"] = start.elapsed_time(end) / steps
            print(json.dumps({"bert_step": rec}), flush=True)
    finally:
        layers.on_card = kernel_route


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5,
                    help="bert-large training steps a turn of the LayerNorm A/B; 0 skips it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.kernels import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)
    libs = build.build_all()
    for name in ("flash_attention", "rmsnorm", "layernorm"):
        rep = smoke.ptxas_report(libs[name].with_suffix(".log"))
        print(json.dumps({"built": name, "ptxas": rep}), flush=True)
    sass = smoke.sass_counts(libs["flash_attention"], build.nvcc())
    print(json.dumps({"flash_attention_sass": sass}), flush=True)
    for d in (64, 80, 128):
        for dt in (torch.float32, torch.bfloat16):
            print(json.dumps({"launch": d, "dtype": str(dt), **ops.flash_attention_launch_info(d, dt)}),
                  flush=True)
    gen = torch.Generator(device="cuda").manual_seed(29)
    print(json.dumps({"large_score_checks": large_score_checks(ops, gen)}), flush=True)
    kern = smoke.phase_kernels(ops)
    print(json.dumps({"kernel_checks": kern["checks"]}), flush=True)
    for shape, by_dt in kern["timed"].items():
        for dt, t in by_dt.items():
            print(json.dumps({"flash": shape, "dtype": str(dt),
                              **{k: v for k, v in t.items() if k != "launch"}}), flush=True)
    smoke.phase_flash_whisper(ops)
    rms = smoke.phase_rmsnorm(ops, ref)
    print(json.dumps({"rmsnorm_checks": rms["checks"], "rmsnorm_timed": rms["timed"]}),
          flush=True)
    ln = smoke.phase_layernorm(ops, ref)
    print(json.dumps({"layernorm_checks": ln["checks"], "layernorm_timed": ln["timed"]}),
          flush=True)
    layernorm_launches(ops, smoke)
    if args.steps:
        step_times(args.steps)
    print(json.dumps({"ok": True, "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
