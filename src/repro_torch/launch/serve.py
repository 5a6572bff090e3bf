"""Serving launcher: prefill + greedy decode with KV caches, on the GPU.

``python -m repro_torch.launch.serve --arch h2o-danube-1.8b --batch 4
--prompt-len 64 --gen 32`` runs prefill over a random token batch, then
autoregressive decode with greedy sampling, and prints one JSON line with
the same keys as ``repro.launch.serve``. It runs on ``cuda`` unless given
``--device cpu``. A vlm (paligemma-3b) is served as the JAX launcher serves
it: text tokens only, with no image prefix. Enc-dec serving (whisper-tiny)
is ``examples/torch_whisper_serve.py``'s.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tf
from repro_torch.serve import metrics as serve_metrics
from repro_torch.sharding.policy import MeshShape, make_policy


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prefill_with_caches(params, batch, cfg, max_len: int, device: torch.device,
                        policy=None, mesh=None):
    """Build decode caches by replaying the prompt token by token.

    (Production would fuse this; token replay is exact and reuses the
    decode path, as the JAX launcher does.) With a ``policy`` and a process
    ``mesh`` that places the leaves (``steps.placed``) it replays through the placed decode step
    (``steps.make_decode_step`` with them) on caches placed by the policy's
    cache specs, each rank making only its own shard
    (``steps.init_placed_caches``), and returns them placed."""
    b, s = batch["tokens"].shape
    if steps_lib.placed(mesh):
        step = steps_lib.make_decode_step(cfg, device, policy, mesh, b, max_len)
        caches = steps_lib.init_placed_caches(cfg, policy, mesh, b, max_len)
    else:
        step = steps_lib.make_decode_step(cfg, device)
        caches = tf.init_caches(cfg, b, max_len, device)
    logits = None
    for t in range(s):
        logits, caches = step(params, caches, batch["tokens"][:, t:t + 1], t)
    return logits, caches


class Generated(NamedTuple):
    tokens: torch.Tensor  # [B, gen]
    logits: torch.Tensor  # the last step's logits
    prefill_s: float
    decode_s: float


def generate(params, prompt: torch.Tensor, cfg, gen: int, dev: torch.device) -> Generated:
    """Greedy serving of ``prompt`` [B, S]: the prompt replayed through the
    decode step fills the caches (the prefill, timed), then each argmax
    token is fed back for ``gen`` − 1 more steps (the decode, timed)."""
    s = prompt.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill_with_caches(params, {"tokens": prompt.to(dev)}, cfg, s + gen, dev)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    decode = steps_lib.make_decode_step(cfg, dev)
    cur = torch.argmax(logits[:, -1:], dim=-1)
    generated = [cur]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = decode(params, caches, cur, s + i)
        cur = torch.argmax(logits[:, -1:], dim=-1)
        generated.append(cur)
    _sync(dev)
    return Generated(torch.cat(generated, dim=1), logits, t_prefill, time.perf_counter() - t0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.gen < 1:
        raise SystemExit("--gen must be >= 1: serving emits at least the "
                         "first token (TTFT is undefined otherwise)")

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.kind == "encdec":
        raise SystemExit("use examples/torch_whisper_serve.py for enc-dec serving")
    make_policy(cfg, MeshShape(("data", "model"), (1, 1)))  # the arch has a serving policy
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = tf.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)

    out, logits, t_prefill, t_decode = generate(params, tokens, cfg, args.gen, dev)
    n_steps = max(1, args.gen - 1)
    result = {
        "batch": args.batch,
        "prefill_s": round(t_prefill, 3),
        "decode_tok_s": round(args.batch * n_steps / max(t_decode, 1e-9), 1),
        serve_metrics.TTFT_S: round(t_prefill, 6),
        serve_metrics.TPOT_S: round(t_decode / n_steps, 6),
        "generated_shape": list(out.shape),
        "finite": bool(torch.isfinite(logits).all()),
        "device": str(dev),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
