"""Assigned input shapes (LM-family): every arch × shape cell is well-defined.

The port's copy of ``repro.configs.shapes``.

  train_4k     seq=4096   global_batch=256   → train_step
  prefill_32k  seq=32768  global_batch=32    → prefill (forward, no grad)
  decode_32k   seq=32768  global_batch=128   → serve_step (1 new token, KV=seq)
  long_500k    seq=524288 global_batch=1     → serve_step; sub-quadratic archs only

``long_500k`` runs only for architectures with bounded decode state:
SSM/hybrid (xlstm, zamba2) and sliding-window attention (h2o-danube, whose
ring-buffer KV is O(window)).  Pure full-attention archs skip it.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    step: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def supports_long_context(cfg: ModelConfig) -> bool:
    """True iff decode state is sub-linear in context (SSM / SWA / hybrid)."""
    recurrent = all(k in ("mamba2", "mlstm", "slstm") for k in cfg.block_pattern)
    hybrid = any(k == "mamba2" for k in cfg.block_pattern)
    swa = cfg.sliding_window is not None
    return recurrent or hybrid or swa


def cells_for(cfg: ModelConfig) -> list[str]:
    """The dry-run cells this architecture participates in."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if supports_long_context(cfg):
        out.append("long_500k")
    return out
