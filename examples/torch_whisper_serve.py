"""Whisper enc-dec serving on the port: encode precomputed audio-frame
embeddings once, fill each decoder layer's cross-attention keys and values,
then decode greedily with self-attention caches.

The twin of ``examples/whisper_serve.py``. The encoder's attention runs the
flash-attention kernel (its plain version on the CPU); the decoder stays
dense, as in the JAX package. Random weights from ``--seed``; the frames
are drawn from a numpy generator seeded by ``--seed``.

Run:  PYTHONPATH=src python examples/torch_whisper_serve.py [--smoke] [--device cpu]
(full width on ``cuda`` by default). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tf
from repro_torch.serve import metrics as serve_metrics


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def frames_for(seed: int, batch: int, cfg) -> np.ndarray:
    """The request batch's frame embeddings [B, enc_seq_len, d_model], fp32."""
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.enc_seq_len, cfg.d_model), dtype=np.float32)


def generate(params, frames: torch.Tensor, cfg, gen: int, dev: torch.device) -> dict:
    """Encode ``frames`` once, fill the cross caches, decode ``gen`` tokens
    greedily from BOS. Returns the tokens, the last logits and the times."""
    decode = steps_lib.make_decode_step(cfg, dev)
    batch = frames.shape[0]

    # 1. encode once
    _sync(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        enc_out = tf.encoder_forward(params["encoder"], frames, cfg)
    _sync(dev)
    encode_s = time.perf_counter() - t0

    # 2. the cross-attention K/V per decoder layer, then 3. greedy decode from BOS
    caches = tf.init_caches(cfg, batch, gen + 1, dev)
    tf.fill_cross_caches(params, enc_out, caches, cfg)
    cur = torch.zeros((batch, 1), dtype=torch.long, device=dev)  # BOS
    out = []
    for t in range(gen):
        logits, caches = decode(params, caches, cur, t)
        cur = torch.argmax(logits[:, -1:], dim=-1)
        out.append(cur)
        if t == 0:
            _sync(dev)
            ttft_s = time.perf_counter() - t0
            t1 = time.perf_counter()
    _sync(dev)
    return {"tokens": torch.cat(out, dim=1), "logits": logits, "encode_s": encode_s,
            "ttft_s": ttft_s, "tpot_s": (time.perf_counter() - t1) / max(1, gen - 1)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.gen < 1:
        raise SystemExit("--gen must be >= 1: serving emits at least the first token")

    dev = resolve_device(args.device)
    cfg = get_smoke_config("whisper-tiny") if args.smoke else get_config("whisper-tiny")
    cfg = cfg.replace(use_pallas=True)
    params = tf.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    frames = torch.from_numpy(frames_for(args.seed, args.batch, cfg)).to(dev)
    run = generate(params, frames, cfg, args.gen, dev)
    toks = run["tokens"]
    result = {
        "batch": args.batch,
        "frames": [args.batch, cfg.enc_seq_len],
        "encode_s": round(run["encode_s"], 6),
        serve_metrics.TTFT_S: round(run["ttft_s"], 6),
        serve_metrics.TPOT_S: round(run["tpot_s"], 6),
        "generated_shape": list(toks.shape),
        "tokens": toks.tolist(),
        "finite": bool(torch.isfinite(run["logits"]).all()),
        "device": str(dev),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
