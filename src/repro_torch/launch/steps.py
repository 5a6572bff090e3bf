"""Prefill and decode steps for serving.

The twin of the prefill/decode half of ``repro.launch.steps``. Both steps
run eagerly on one device: there is no sharding yet (ROADMAP Queue 1
item 13). With ``cfg.use_pallas`` the prefill's attention runs the
hand-written flash-attention kernel, once per layer.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf


def make_prefill(cfg: ModelConfig, device: Optional[torch.device] = None) -> Callable:
    """``prefill(params, batch) -> logits [B,S,V]`` on ``device`` (default cuda)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill(params, batch):
        batch = {k: v.to(dev) for k, v in batch.items()}
        logits, _ = tf.forward_logits(params, batch, cfg)
        return logits

    return prefill


def make_decode_step(cfg: ModelConfig, device: Optional[torch.device] = None) -> Callable:
    """``decode(params, caches, tokens [B,1], position) -> (logits, caches)``;
    the caches are updated in place."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def decode(params, caches, tokens, position: int):
        return tf.decode_step(params, caches, tokens.to(dev), position, cfg)

    return decode
