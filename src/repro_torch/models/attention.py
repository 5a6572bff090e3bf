"""Attention: GQA / MQA / sliding-window, dense + chunked + kernel paths, and MLA.

The twin of ``repro.models.attention`` for the standard attention block:

  * dense    — materializes [Sq, Skv] scores; the reference everywhere;
  * chunked  — online softmax over KV chunks, bounding the score working
               set to [Sq, chunk], for sequences past ``dense_attn_limit``;
  * kernel   — ``cfg.use_pallas``: the hand-written CUDA flash-attention
               kernel in ``repro_torch.kernels`` (its plain version on CPU).

Decode keeps a KV cache, in the compute dtype or, KIVI-style, in int8
with one fp32 scale per (token, KV head); sliding-window archs (h2o-danube)
use a ring buffer of ``window`` slots. Unlike the JAX package, the port
updates the cache in place (an eager program gains nothing from a copy).

MLA (DeepSeek-V2's multi-head latent attention) takes the dense or chunked
path only, as in the JAX package: its query/key dim (nope + rope) differs
from its value dim, and the kernel takes one head dim.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import RECIP_127
from repro_torch.models import loop_fold
from repro_torch.models.layers import apply_rope, dense_init

Tensor = torch.Tensor

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def build_mask(q_pos: Tensor, kv_pos: Tensor, kind: str = "causal",
               window: Optional[int] = None, prefix_len: int = 0) -> Tensor:
    """Boolean [.., Sq, Skv] mask; True = attend.

    kinds: "causal" | "bidirectional" | "prefix" (bidirectional over tokens
    with position < prefix_len, causal after — PaliGemma-style prefix-LM).
    ``window``: additionally restrict to kv within ``window`` positions.
    """
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    valid = k >= 0  # ring-buffer slots that were never written carry pos=-1
    if kind == "bidirectional":
        m = valid
    elif kind == "prefix":
        m = ((k <= q) | (k < prefix_len)) & valid
    else:  # causal
        m = (k <= q) & valid
    if window is not None:
        m = m & (q - k < window)
    return m


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

def dense_attention(q: Tensor, k: Tensor, v: Tensor, mask: Tensor,
                    scale: Optional[float] = None) -> Tensor:
    """q [B,Sq,H,Dk], k [B,Skv,KV,Dk], v [B,Skv,KV,Dv], mask [B?,Sq,Skv].

    GQA-native: when H > KV the query heads are grouped as [KV, H/KV] and
    contracted against the KV heads directly; repeated K/V never exists.
    Softmax runs in fp32 and P is cast to q's dtype before P·V.
    """
    b, sq, h, dk = q.shape
    kv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    if mask.dim() == 2:
        mask = mask[None]
    if h == kv:
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        s = torch.where(mask[:, None, :, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)
    n_rep = h // kv
    qg = q.reshape(b, sq, kv, n_rep, dk)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() * scale
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, v)
    return out.reshape(b, sq, h, v.shape[-1])


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, kv_pos: Tensor,
                      kind: str = "causal", window: Optional[int] = None,
                      prefix_len: int = 0, chunk: int = 1024,
                      scale: Optional[float] = None) -> Tensor:
    """Online-softmax attention over KV chunks; O(Sq·chunk) score memory.

    GQA-native like ``dense_attention``. A Python loop over the chunks
    takes the place of the JAX package's ``lax.scan``.
    """
    b, sq, h, dk = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    n_rep = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qf = q.reshape(b, sq, kvh, n_rep, dk).float()
    acc = torch.zeros((b, kvh, n_rep, sq, dv), dtype=torch.float32, device=q.device)
    m = torch.full((b, kvh, n_rep, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, n_rep, sq), dtype=torch.float32, device=q.device)

    def step(c0, acc, m, l):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        s = torch.einsum("bqhrd,bkhd->bhrqk", qf, kb) * scale
        msk = build_mask(q_pos, kv_pos[:, c0:c0 + chunk], kind, window, prefix_len)
        s = torch.where(msk[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhrqk,bkhd->bhrqd", p, vb)
        return acc, m_new, l

    starts = list(range(0, skv, chunk))
    full = skv // chunk
    repeated = loop_fold.FOLD.get()  # a counter's fold of the loop
    if repeated is not None and full >= 3 and not torch.is_grad_enabled():
        acc, m, l = step(0, acc, m, l)
        with repeated(full - 1, [], lambda: []):
            acc, m, l = step(chunk, acc, m, l)
        starts = starts[full:]  # the ragged tail, if any
    for c0 in starts:
        acc, m, l = step(c0, acc, m, l)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    # [B,KV,R,Sq,Dv] → [B,Sq,H,Dv]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# standard (GQA) attention block
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d: int, n_heads: int, n_kv: int, head_dim: int,
                   qkv_bias: bool = False, dtype=torch.float32,
                   lead: tuple[int, ...] = ()) -> dict:
    p = {
        "wq": dense_init(gen, (d, n_heads, head_dim), dtype=dtype, lead=lead),
        "wk": dense_init(gen, (d, n_kv, head_dim), dtype=dtype, lead=lead),
        "wv": dense_init(gen, (d, n_kv, head_dim), dtype=dtype, lead=lead),
        "wo": dense_init(gen, (n_heads, head_dim, d), dtype=dtype, lead=lead),
    }
    if qkv_bias:  # codeqwen/qwen1.5 carries qkv biases
        dev = gen.device
        p["bq"] = torch.zeros(lead + (n_heads, head_dim), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(lead + (n_kv, head_dim), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(lead + (n_kv, head_dim), dtype=dtype, device=dev)
    return p


def _project_qkv(p: dict, x: Tensor, xkv: Tensor, positions: Tensor,
                 kv_positions: Tensor, cfg) -> tuple[Tensor, Tensor, Tensor]:
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.use_rope:
        rd = int(cfg.head_dim * cfg.partial_rotary_factor)
        q = apply_rope(q, positions, cfg.rope_theta, rd)
        k = apply_rope(k, kv_positions, cfg.rope_theta, rd)
    return q, k, v


def attention_forward(p: dict, x: Tensor, positions: Tensor, cfg,
                      mask_kind: str = "causal", prefix_len: int = 0,
                      xkv: Optional[Tensor] = None,
                      kv_positions: Optional[Tensor] = None,
                      use_pallas: bool = False) -> Tensor:
    """Full-sequence attention (prefill). ``xkv`` enables cross-attn.

    ``use_pallas`` runs the flash-attention kernel, which masks on indices
    from 0 (causal and window only). The JAX dispatch silently drops a
    "prefix" mask or explicit ``kv_positions`` there; the port raises.
    """
    if use_pallas and (mask_kind == "prefix" or kv_positions is not None):
        raise NotImplementedError(
            "the flash-attention kernel takes causal/bidirectional masks on indices "
            "from 0 only; a prefix mask or explicit kv_positions needs the dense path")
    xkv = x if xkv is None else xkv
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _project_qkv(p, x, xkv, positions, kv_positions, cfg)
    window = cfg.sliding_window if mask_kind == "causal" else None
    if use_pallas:
        out = kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=(mask_kind == "causal"), window=window)
    elif x.shape[1] * xkv.shape[1] > cfg.dense_attn_limit:
        out = chunked_attention(q, k, v, positions, kv_positions, mask_kind,
                                window, prefix_len, chunk=cfg.attn_chunk)
    else:
        mask = build_mask(positions, kv_positions, mask_kind, window, prefix_len)
        out = dense_attention(q, k, v, mask)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# KV cache (decode): compute dtype, or int8 (KIVI-style per-token-per-head scales)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    if dtype in (torch.int8, "int8"):
        return {
            "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=torch.int8, device=device),
            "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=torch.int8, device=device),
            # symmetric per-(token, head) scales: the payload streams half
            # the bytes of a bf16 cache per decode step
            "k_scale": torch.zeros((batch, max_len, n_kv), dtype=torch.float32, device=device),
            "v_scale": torch.zeros((batch, max_len, n_kv), dtype=torch.float32, device=device),
            "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
        }
    return {
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
    }


def _quant_kv(x: Tensor) -> tuple[Tensor, Tensor]:
    """[B,S,KV,D] → int8 payload + per-(token, head) fp32 scale: the scale is
    ``max(amax, 1e-12) / 127`` over D, taken as the jitted reference takes
    it (XLA multiplies by fp32(1/127), ``kernels.ref.RECIP_127``), then
    ``x / scale`` rounded half to even and clipped to ±127."""
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf), dim=-1), min=1e-12) * RECIP_127
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant_kv(q: Tensor, scale: Tensor, dtype: torch.dtype) -> Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def decode_attention(p: dict, x: Tensor, cache: dict, position: int, cfg) -> tuple[Tensor, dict]:
    """One-token decode: write the (ring) cache in place, attend over it.

    ``x``: [B, 1, D]; ``position``: the current absolute position; ring
    semantics when ``cfg.sliding_window`` is set (slot = pos % max_len).
    An int8 cache (one with ``k_scale``) takes the new token's payload and
    scales at the slot, and the whole cache is dequantized to ``x``'s dtype
    and attended densely, as in JAX.
    """
    b = x.shape[0]
    max_len = cache["k"].shape[1]
    pos_b = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, x, pos_b, pos_b, cfg)
    slot = position % max_len  # ring buffer; max_len == window for SWA archs
    if "k_scale" in cache:
        for name, new in (("k", k), ("v", v)):
            payload, scale = _quant_kv(new)
            cache[name][:, slot] = payload[:, 0]
            cache[name + "_scale"][:, slot] = scale[:, 0]
        kk = _dequant_kv(cache["k"], cache["k_scale"], x.dtype)
        vv = _dequant_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        kk, vv = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    cache["pos"][:, slot] = position
    mask = build_mask(pos_b, cache["pos"], "causal", cfg.sliding_window)
    out = dense_attention(q, kk, vv, mask)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, d: int, n_heads: int, kv_lora_rank: int,
             qk_nope_dim: int, qk_rope_dim: int, v_dim: int, dtype=torch.float32,
             lead: tuple[int, ...] = ()) -> dict:
    return {
        # queries (lite model: no q-lora)
        "wq": dense_init(gen, (d, n_heads, qk_nope_dim + qk_rope_dim), dtype=dtype, lead=lead),
        # latent KV compression
        "w_dkv": dense_init(gen, (d, kv_lora_rank), dtype=dtype, lead=lead),
        "w_kpe": dense_init(gen, (d, qk_rope_dim), dtype=dtype, lead=lead),  # shared by heads
        # decompression
        "w_uk": dense_init(gen, (kv_lora_rank, n_heads, qk_nope_dim), dtype=dtype, lead=lead),
        "w_uv": dense_init(gen, (kv_lora_rank, n_heads, v_dim), dtype=dtype, lead=lead),
        "wo": dense_init(gen, (n_heads, v_dim, d), dtype=dtype, lead=lead),
    }


def _mla_query(p: dict, x: Tensor, positions: Tensor, cfg) -> Tensor:
    """[B,S,H,nope+rope]: the nope lanes as projected, the rope lanes roped."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    nope = cfg.mla_qk_nope_dim
    return torch.cat([q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)],
                     dim=-1)


def _mla_latent(p: dict, x: Tensor, positions: Tensor, cfg) -> tuple[Tensor, Tensor]:
    """The cached pair: latent ``c_kv`` [B,S,rank] and roped ``k_pe`` [B,S,rope]
    (full rotary on the interleaved lanes, one head shared by all)."""
    dt = x.dtype
    c_kv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(dt))
    k_pe = torch.einsum("bsd,dk->bsk", x, p["w_kpe"].to(dt))[:, :, None, :]
    return c_kv, apply_rope(k_pe, positions, cfg.rope_theta)[:, :, 0, :]


def _mla_keys_values(p: dict, c_kv: Tensor, k_pe: Tensor, cfg) -> tuple[Tensor, Tensor]:
    """Decompress the latent: K = [c_kv·w_uk, k_pe broadcast over heads], V = c_kv·w_uv."""
    dt = c_kv.dtype
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"].to(dt))
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"].to(dt))
    k_pe = k_pe[:, :, None, :].expand(*k_nope.shape[:3], cfg.mla_qk_rope_dim)
    return torch.cat([k_nope, k_pe], dim=-1), v


def _mla_scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim)


def mla_forward(p: dict, x: Tensor, positions: Tensor, cfg,
                use_chunked: Optional[bool] = None) -> Tensor:
    """Full-sequence MLA. The latent c_kv (rank 512) + shared k_pe (64) are
    what a server caches: 576 values per token against 2·H·D = 4096."""
    q = _mla_query(p, x, positions, cfg)
    c_kv, k_pe = _mla_latent(p, x, positions, cfg)
    k, v = _mla_keys_values(p, c_kv, k_pe, cfg)
    s = x.shape[1]
    if use_chunked is None:
        use_chunked = s * s > cfg.dense_attn_limit
    if use_chunked:
        out = chunked_attention(q, k, v, positions, positions, "causal", None, 0,
                                chunk=cfg.attn_chunk, scale=_mla_scale(cfg))
    else:
        mask = build_mask(positions, positions, "causal")
        out = dense_attention(q, k, v, mask, scale=_mla_scale(cfg))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


def init_mla_cache(batch: int, max_len: int, kv_lora_rank: int, rope_dim: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_len, kv_lora_rank), dtype=dtype, device=device),
        "k_pe": torch.zeros((batch, max_len, rope_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
    }


def mla_decode(p: dict, x: Tensor, cache: dict, position: int, cfg) -> tuple[Tensor, dict]:
    """One-token MLA decode against the latent cache, written in place at
    slot ``position % max_len``. K and V are decompressed from the whole
    cache every step, as the JAX package does (``w_uk`` is not absorbed
    into the query)."""
    b = x.shape[0]
    pos_b = torch.full((b, 1), position, dtype=torch.int32, device=x.device)
    q = _mla_query(p, x, pos_b, cfg)
    c_new, kpe_new = _mla_latent(p, x, pos_b, cfg)
    slot = position % cache["c_kv"].shape[1]
    cache["c_kv"][:, slot] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_pe"][:, slot] = kpe_new[:, 0].to(cache["k_pe"].dtype)
    cache["pos"][:, slot] = position
    k, v = _mla_keys_values(p, cache["c_kv"].to(x.dtype), cache["k_pe"].to(x.dtype), cfg)
    mask = build_mask(pos_b, cache["pos"], "causal")
    out = dense_attention(q, k, v, mask, scale=_mla_scale(cfg))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), cache
