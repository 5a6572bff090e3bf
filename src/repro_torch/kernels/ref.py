"""Plain PyTorch versions of the hand-written kernels.

The twin of ``repro.kernels.ref``: what each kernel computes, written
with no regard for speed. The CPU tests run these through the kernel
wrappers, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

Tensor = torch.Tensor


def reference_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None) -> Tensor:
    """q: [BH, Sq, D]; k/v: [BKV, Skv, D]; GQA broadcast by repetition.

    Masked scores are -1e30, so a row with no live key averages every key
    (a uniform softmax), as the JAX oracle does.
    """
    bh, sq, d = q.shape
    bkv, skv, _ = k.shape
    n_rep = bh // bkv
    k = torch.repeat_interleave(k, n_rep, dim=0)
    v = torch.repeat_interleave(v, n_rep, dim=0)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def reference_rmsnorm(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    """Per row: ``x·rsqrt(mean(x²)+eps)·(1+w)`` with fp32 statistics, in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


#: 1/127 rounded to fp32. The JAX package writes ``max(amax, 1e-12) / 127``,
#: and XLA compiles that division by a constant into a multiply by this
#: reciprocal (in the jitted trainer and in the Pallas kernel alike), so the
#: port multiplies too, to give the same scales bit for bit. ``x / scale``
#: stays a true division there and here.
RECIP_127 = 1.0 / 127.0


def quantize_int8(x: Tensor, block: int = 256) -> tuple[Tensor, Tensor]:
    """Flat x → (int8 [n_pad], fp32 scales [n_pad/block]), per-block symmetric."""
    n = x.shape[0]
    pad = (-n) % block
    xf = torch.nn.functional.pad(x.float(), (0, pad)).reshape(-1, block)
    amax = torch.amax(torch.abs(xf), dim=1)
    scale = torch.clamp(amax, min=1e-12) * RECIP_127
    q = torch.clamp(torch.round(xf / scale[:, None]), -127, 127).to(torch.int8)
    return q.reshape(-1), scale


def dequantize_int8(q: Tensor, scales: Tensor, n: int, block: int = 256) -> Tensor:
    xf = q.float().reshape(-1, block) * scales[:, None]
    return xf.reshape(-1)[:n]
