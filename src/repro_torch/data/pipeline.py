"""Deterministic synthetic token pipeline (sharded, seeded, restartable).

The twin of ``repro.data.pipeline``: the same numpy Philox draw, so the
port and the JAX package see identical tokens for a (seed, step); only the
final conversion makes torch tensors (on the CPU; the train step moves
them to its device).

  * every batch is a pure function of (seed, step), so a restart at step k
    reproduces the exact remaining stream;
  * per-host sharding: host h of H materializes only rows ``h::H`` of the
    global batch;
  * the token stream is a Zipf-ish mixture.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    host_id: int = 0
    n_hosts: int = 1


def batch_at(step: int, cfg: ModelConfig, data: DataConfig) -> dict:
    """The global batch for ``step`` (deterministic in (seed, step))."""
    rng = np.random.Generator(np.random.Philox(key=data.seed, counter=[0, 0, 0, step]))
    b, s = data.global_batch, data.seq_len
    # Zipf-like marginal over the vocab, fixed by the seed
    v = cfg.vocab_size
    ranks = rng.permutation(v)
    u = rng.random((b, s))
    zipf = (v ** u - 1) / (v - 1)  # inverse-CDF of a log-uniform
    tokens = ranks[np.clip((zipf * v).astype(np.int64), 0, v - 1)]
    out = {"tokens": torch.from_numpy(tokens.astype(np.int32))}
    if cfg.kind == "vlm":
        out["image_embeds"] = torch.from_numpy(
            rng.standard_normal((b, cfg.num_image_tokens, cfg.d_model), np.float32))
    if cfg.kind == "encdec":
        out["frames"] = torch.from_numpy(
            rng.standard_normal((b, cfg.enc_seq_len, cfg.d_model), np.float32))
    return out


def host_slice(batch: dict, data: DataConfig) -> dict:
    """Rows this host owns (h::H)."""
    return {k: v[data.host_id::data.n_hosts] for k, v in batch.items()}


def stream(cfg: ModelConfig, data: DataConfig, start_step: int = 0):
    """Infinite deterministic batch iterator starting at ``start_step``."""
    step = start_step
    while True:
        yield step, host_slice(batch_at(step, cfg, data), data)
        step += 1
