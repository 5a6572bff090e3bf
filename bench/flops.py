"""The benchmark's yardstick for the dense decoder: model FLOPs from a
configuration's shapes, the flash kernel's least time, and the card's
published peaks. A configuration with its own blocks counts its own
(``bench/references/<config>.py``).

Counted from the configuration file alone, whatever implements the model:
every matmul parameter once (a tied head once), 2 FLOPs per parameter per
token forward and 4 more backward, attention over the (query, key) pairs the
mask keeps (causal, and the sliding window where the configuration has one),
4·head_dim FLOPs per pair and head forward. Recompute is not counted.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense: bf16 on the tensor cores, HBM3 bandwidth
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12}}


def peak(kind: str) -> dict | None:
    """The published peaks of the card named ``kind``; None for a card not
    listed, so that every share of a peak reads as not measured."""
    return PEAKS.get(kind)


def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matmul: the attention and MLP matrices of every
    layer and the output head (the embedding lookup is no matmul; a tied head
    counts once)."""
    d, h, kv, hd, f = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff"))
    attn = 2 * d * h * hd + 2 * d * kv * hd
    mlp = (3 if cfg["mlp_style"] in ("swiglu", "geglu") else 2) * d * f
    return cfg["n_layers"] * (attn + mlp) + d * cfg["vocab_size"]


def live_pairs(sq: int, skv: int, causal: bool = True, window: int | None = None) -> int:
    """(query, key) pairs the mask keeps, queries and keys both from 0."""
    total = 0
    for q in range(sq):
        hi = min(q + 1, skv) if causal else skv
        lo = max(q - window + 1, 0) if window else 0
        total += max(hi - lo, 0)
    return total


def attention_flops(cfg: dict, batch: int, seq: int) -> int:
    """Forward FLOPs of every layer's scores and weighted sum: 4·head_dim per
    live pair and query head."""
    pairs = live_pairs(seq, seq, True, cfg.get("sliding_window"))
    return 4 * cfg["head_dim"] * cfg["n_heads"] * pairs * batch * cfg["n_layers"]


def forward_flops(cfg: dict, batch: int, seq: int) -> int:
    return 2 * matmul_params(cfg) * batch * seq + attention_flops(cfg, batch, seq)


def train_step_flops(cfg: dict, batch: int, seq: int) -> int:
    """Forward and backward (3× the forward), no recompute."""
    return 3 * forward_flops(cfg, batch, seq)


def flash_launch(cfg: dict, batch: int, seq: int, peaks: dict | None,
                 dtype_bytes: int = 2) -> dict:
    """One flash launch (one layer's attention): its FLOPs, its bytes (q, k, v
    read once, o written once) and its least time at bf16 on the card of
    ``peaks`` (None where the card's peaks are unknown)."""
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    flops = 4 * hd * batch * h * live_pairs(seq, seq, True, cfg.get("sliding_window"))
    nbytes = (2 * batch * seq * h * hd + 2 * batch * seq * kv * hd) * dtype_bytes
    out = {"flops": flops, "bytes": nbytes, "bound_s": None, "bound_by": None}
    if peaks:
        t_ops, t_bytes = flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_s"]
        out.update(bound_s=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
    return out


def kernel_bounds(cfg: dict, batch: int, seq: int, peaks: dict | None) -> dict:
    """The dense decoder's kernels' least times a launch, by the names their
    roofline readers read: the flash kernel's."""
    return {"flash_bound_s": flash_launch(cfg, batch, seq, peaks)["bound_s"]}
