"""Shared neural-net layers: plain functions on tensors, params as dicts.

Numerically the twin of ``repro.models.layers``: fp32 norm statistics,
interleaved RoPE lanes, whisper's sinusoidal positions, weights cast to the
activation dtype on every call.

Under tensor parallelism the params are DTensors and these functions run
on them as they are; :func:`reduced` and :func:`whole_grad` are the
all-reduces of Megatron's row- and column-parallel products (forward and
backward), and the loss gathers vocab-sharded logits.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.sharding.policy import redistribute, replicated

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# init helpers (explicit generators; same distributions as the JAX package)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: tuple[int, ...], scale: float = 1.0,
               dtype=torch.float32, lead: tuple[int, ...] = ()) -> Tensor:
    """Truncated-normal (±2σ) fan-in init (LeCun-style) of ``lead + shape``.

    ``lead`` stacks independent draws along leading axes (a segment's
    layer axis); the fan-in comes from ``shape`` alone. The draw is scaled
    in place, so a leaf never exists twice in fp32 (deepseek's stacked
    expert leaf is 19.2 GB).
    """
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    x = torch.empty(lead + tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape: tuple[int, int], dtype=torch.float32) -> Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * 0.02).to(dtype)


def reduced(x: Tensor) -> Tensor:
    """``x`` with its partial sums over mesh axes added up: under tensor
    parallelism, the all-reduce after a row-parallel product (the attention's
    and the MLP's output projections, a vocab-sharded lookup), so that the
    next layer reads whole activations and its column-parallel products stay
    sharded. Any other tensor is returned as it is."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return redistribute(x, [Replicate() if p.is_partial() else p for p in x.placements])
    return x


def whole_grad(x: Tensor) -> Tensor:
    """``x``, whose gradient has its partial sums over mesh axes added up in
    the backward pass: under tensor parallelism, the all-reduce of a
    column-parallel product's input gradient, so that the gradients of the
    activations stay whole and the row-parallel products' backward stays
    sharded. Any other tensor is returned as it is."""
    return _WholeGrad.apply(x) if isinstance(x, DTensor) else x


class _WholeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduced(g)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: Tensor, weight: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm, fp32 statistics regardless of activation dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def on_card(x: Tensor) -> bool:
    """Whether ``x`` takes a hand-written kernel: a plain tensor on the card. A
    DTensor (a tensor-parallel placement) and a CPU or meta tensor take the plain
    version."""
    return not isinstance(x, DTensor) and x.device.type == "cuda"


def layernorm(x: Tensor, weight: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm, fp32 statistics (two-pass variance) regardless of activation
    dtype: on the card the fused kernels (``ops.fused_layernorm``, forward and
    backward), elsewhere the plain version (``ref.reference_layernorm``)."""
    if on_card(x):
        return kops.fused_layernorm(x, weight, bias, eps)
    return kref.reference_layernorm(x, weight, bias, eps)


def init_norm(cfg_norm: str, d: int, lead: tuple[int, ...] = (), device=None) -> dict:
    if cfg_norm == "rmsnorm":  # stored as (1 + w)
        return {"w": torch.zeros(lead + (d,), dtype=torch.float32, device=device)}
    return {"w": torch.ones(lead + (d,), dtype=torch.float32, device=device),
            "b": torch.zeros(lead + (d,), dtype=torch.float32, device=device)}


def apply_norm(cfg_norm: str, p: dict, x: Tensor) -> Tensor:
    if cfg_norm == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

class Yarn(NamedTuple):
    """YaRN's rope scaling (arXiv:2309.00071) as DeepSeek-V2 computes it (HF's
    ``DeepseekV2YarnRotaryEmbedding``): HF's ``rope_scaling`` keys."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float


def yarn_of(cfg) -> Optional[Yarn]:
    """The configuration's YaRN settings, None where it has none."""
    if cfg.yarn_factor is None:
        return None
    return Yarn(cfg.yarn_factor, cfg.yarn_original_max_position_embeddings, cfg.yarn_beta_fast,
                cfg.yarn_beta_slow, cfg.yarn_mscale, cfg.yarn_mscale_all_dim)


def yarn_mscale(factor: float, m: float) -> float:
    """0.1·m·ln(factor) + 1: YaRN's attention temperature (1 for no scaling)."""
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def _yarn_ramp(yarn: Yarn, rd: int, theta: float, device) -> Tensor:
    """Over the ``rd/2`` lane pairs: 0 where a pair turns more than ``beta_fast``
    times over the original context (its frequency kept), 1 where it turns fewer
    than ``beta_slow`` times (divided by the factor), linear between."""
    def dim(turns):  # the pair index at which a frequency makes ``turns`` turns
        return (rd * math.log(yarn.original_max_position_embeddings / (turns * 2 * math.pi))
                / (2 * math.log(theta)))
    lo = max(math.floor(dim(yarn.beta_fast)), 0)
    hi = min(math.ceil(dim(yarn.beta_slow)), rd - 1)
    if hi == lo:
        hi += 0.001
    i = torch.arange(rd // 2, dtype=torch.float32, device=device)
    return torch.clamp((i - lo) / (hi - lo), 0, 1)


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     rotary_dim: Optional[int] = None, device=None,
                     yarn: Optional[Yarn] = None) -> Tensor:
    """Inverse frequencies for RoPE over the first ``rotary_dim`` dims; with
    ``yarn``, each blended by YaRN's ramp from the frequency as it is to the
    frequency divided by the factor."""
    rd = rotary_dim or head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd
    extra = 1.0 / (theta ** exps)
    if yarn is None:
        return extra
    inter = 1.0 / (yarn.factor * theta ** exps)
    keep = 1.0 - _yarn_ramp(yarn, rd, theta, device)
    return inter * (1 - keep) + extra * keep


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0,
               rotary_dim: Optional[int] = None, yarn: Optional[Yarn] = None) -> Tensor:
    """Rotate ``x`` [..., S, H, D] by position. ``positions``: [..., S].

    Pairs are the interleaved lanes (0::2, 1::2), re-interleaved after the
    rotation. Partial rotary (GLM-style): only the first ``rotary_dim``
    dims rotate, the remainder passes through. ``yarn``: YaRN's frequencies,
    and cos and sin scaled by mscale(factor, mscale) / mscale(factor,
    mscale_all_dim).
    """
    d = x.shape[-1]
    rd = rotary_dim or d
    inv = rope_frequencies(d, theta, rd, device=x.device, yarn=yarn)  # [rd/2]
    ang = positions[..., :, None].float() * inv  # [..., S, rd/2]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, rd/2]
    sin = torch.sin(ang)[..., None, :]
    if yarn is not None:
        m = yarn_mscale(yarn.factor, yarn.mscale) / yarn_mscale(yarn.factor, yarn.mscale_all_dim)
        cos, sin = cos * m, sin * m
    xr = x[..., :rd].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    rot = rot.reshape(*x.shape[:-1], rd).to(x.dtype)
    if rd == d:
        return rot
    return torch.cat([rot, x[..., rd:]], dim=-1)


def sinusoidal_positions(seq_len: int, d: int, offset: int = 0, device=None) -> Tensor:
    """Whisper-style sinusoidal absolute embeddings [seq_len, d], fp32:
    angle ``pos / 10000 ** (dim / d)``, sin in the even lanes, cos in the odd
    ones. ``offset`` shifts the positions (the decode position)."""
    pos = (torch.arange(seq_len, dtype=torch.float32, device=device) + offset)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    out = torch.empty((seq_len, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, style: str, dtype=torch.float32,
             lead: tuple[int, ...] = ()) -> dict:
    if style in ("swiglu", "geglu"):
        return {
            "wi": dense_init(gen, (d, d_ff), dtype=dtype, lead=lead),
            "wg": dense_init(gen, (d, d_ff), dtype=dtype, lead=lead),
            "wo": dense_init(gen, (d_ff, d), dtype=dtype, lead=lead),
        }
    return {  # plain 2-matrix MLP (whisper: GELU)
        "wi": dense_init(gen, (d, d_ff), dtype=dtype, lead=lead),
        "wo": dense_init(gen, (d_ff, d), dtype=dtype, lead=lead),
    }


def apply_mlp(p: dict, x: Tensor, style: str) -> Tensor:
    x = whole_grad(x)
    dt = x.dtype
    if style == "swiglu":
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    elif style == "geglu":
        h = F.gelu(x @ p["wg"].to(dt), approximate="tanh") * (x @ p["wi"].to(dt))
    else:
        h = F.gelu(x @ p["wi"].to(dt), approximate="tanh")
    return reduced(h @ p["wo"].to(dt))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: Tensor, targets: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Mean token cross-entropy; logits promoted to fp32. Vocab-sharded
    logits (a DTensor) are gathered first: the softmax reads every entry."""
    if isinstance(logits, DTensor):
        logits = replicated(logits)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
