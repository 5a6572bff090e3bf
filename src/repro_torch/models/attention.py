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
from its value dim, and the kernel takes one head dim. The published model's
two mechanisms that the JAX package leaves out are the configuration's: the
latent's RMSNorm (``cfg.mla_kv_norm``, before the latent is cached or
decompressed) and YaRN on the rope lanes (``cfg.yarn_factor``: its
frequencies, and the softmax scale times mscale(factor, mscale_all_dim)²).

Under tensor parallelism (DTensor params, the heads sharded over the model
axis) the standard block's attention core runs on each rank's own heads
(:func:`head_local`), and its decode runs on a KV cache placed by the
sharding policy's cache specs, each rank on its own heads and slots
(:func:`placed_decode_attention`). MLA's core runs on each rank's heads too
(:func:`mla_forward`), and its decode on a latent cache whose sequence is
split over model, in the latent space (:func:`placed_mla_decode`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.core import collectives_dist
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import RECIP_127
from repro_torch.models import loop_fold
from repro_torch.models.layers import (apply_norm, apply_rope, dense_init, init_norm, reduced,
                                       whole_grad, yarn_mscale, yarn_of)
from repro_torch.sharding.policy import flat_group, local_offsets, redistribute

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
    x = whole_grad(x)
    xkv = x if xkv is None else whole_grad(xkv)
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _project_qkv(p, x, xkv, positions, kv_positions, cfg)
    window = cfg.sliding_window if mask_kind == "causal" else None

    def core(q, k, v):
        if use_pallas:
            return kops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                        causal=(mask_kind == "causal"), window=window)
        if x.shape[1] * xkv.shape[1] > cfg.dense_attn_limit:
            return chunked_attention(q, k, v, positions, kv_positions, mask_kind,
                                     window, prefix_len, chunk=cfg.attn_chunk)
        mask = build_mask(positions, kv_positions, mask_kind, window, prefix_len)
        return dense_attention(q, k, v, mask)

    out = head_local(core, q, k, v) if isinstance(q, DTensor) else core(q, k, v)
    return reduced(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)))


def head_local(core, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """``core(q, k, v)`` on each rank's own query heads, for DTensor ``q``,
    ``k``, ``v`` [B, S, H|KV, D] under tensor parallelism.

    The core (the kernel, chunked or dense) runs inside ``local_map`` on the
    local tensors, with the masks, positions and rope tables it makes for
    itself; its output is placed as ``q`` is. Where the heads are sharded
    and the KV heads are not (``n_kv_heads % tp != 0``: the policy
    replicates ``wk``/``wv``), each rank hands the core the KV heads that its
    own query heads read, ``h // (H/KV)``, sliced from the full set, so that
    the core's local map ``h // (H_local/KV_local)`` reads the same keys; the
    gradient of the full set is then a partial sum over the ranks."""
    if any(pl.is_partial() for t in (q, k, v) for pl in t.placements):
        raise ValueError("attention takes whole q/k/v: reduce the layer's input first")
    h, kv = q.shape[2], k.shape[2]
    sliced = [i for i, (pq, pk) in enumerate(zip(q.placements, k.placements))
              if pq.is_shard(2) and not pk.is_shard(2)]
    if not sliced:
        fn, kv_grad = core, k.placements
    else:
        [i] = sliced
        local_h = h // q.device_mesh.size(i)
        pick = kv_pick(h, kv, q.device_mesh.get_local_rank(i) * local_h, local_h, 0)

        def fn(q, k, v):
            return core(q, k[:, :, pick], v[:, :, pick])
        kv_grad = tuple(Partial() if j == i else pl for j, pl in enumerate(k.placements))
    return local_map(fn, out_placements=list(q.placements),  # a tuple would mean one per output
                     in_placements=(q.placements, k.placements, v.placements),
                     in_grad_placements=(q.placements, kv_grad, kv_grad))(q, k, v)


def kv_pick(h: int, kv: int, first: int, local_h: int, kv_first: int):
    """Which of a rank's KV heads (the global heads from ``kv_first``) its
    ``local_h`` query heads from ``first`` read, query head ``j`` reading
    KV head ``j // (h/kv)``: a slice where they read contiguous KV heads at
    one ratio (the local map ``j // (local_h/KV_local)`` then holds), else
    one KV head per query head."""
    idx = [(first + j) // (h // kv) - kv_first for j in range(local_h)]
    heads = sorted(set(idx))
    if local_h % len(heads) == 0 and idx == [u for u in heads
                                               for _ in range(local_h // len(heads))]:
        return slice(heads[0], heads[-1] + 1)
    return idx


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
    and attended densely, as in JAX. A cache of DTensors placed by the
    policy's cache specs takes :func:`placed_decode_attention`.
    """
    if isinstance(cache["k"], DTensor):
        return placed_decode_attention(p, x, cache, position, cfg)
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


def placed_decode_attention(p: dict, x: Tensor, cache: dict, position: int,
                            cfg) -> tuple[Tensor, dict]:
    """:func:`decode_attention` on a cache whose leaves are DTensors on the
    ``(data, model)`` mesh, placed by ``ShardingPolicy.cache_spec``, with
    ``p`` and ``x`` DTensors on this data rank's model group (its rows when
    the batch is split over data). Every rank works on its local tensors:

      * the new token is written through the local tensor of each leaf whose
        shard holds the slot ``position % L`` (of a ring buffer too), at the
        slot less the shard's offset, and with the heads of the shard: every
        rank for a leaf whose sequence is whole, the slot's owner for one
        whose sequence is split over model or data. Where the int8 scales
        keep every KV head and the payload its own (KV heads over model),
        the new token's scales are gathered over model first;
      * each rank attends its query heads over its own slots, reading the KV
        heads they map to (:func:`kv_pick`) and masking with the slice of
        ``pos`` beside its keys. Where the sequence is split, the softmax's
        max per (row, head), then its sum and the partial P·V, are added over
        the group that splits it, several mesh dims taken as one where they
        split it together (:func:`_seq_split_attention`): scalars and
        one output row per head cross the wire, never the cache. Where that
        group is the model group, which also splits the query heads, every
        rank first gathers the new token's query heads, attends them all, and
        keeps its own.
    """
    if any(not pl.is_replicate() for pl in x.placements):
        raise ValueError("decode attention takes a whole x: reduce the layer's input first")
    model = x.device_mesh  # this data rank's model group
    xl = x.to_local()
    b = xl.shape[0]
    pos_b = torch.full((b, 1), position, dtype=torch.int32, device=xl.device)
    # q, k, v of the rank's own heads from its own weights, as local tensors like the
    # cache they go into: the products DTensor would run, with no wire
    ql, kn, vn = _project_qkv({k: t.to_local() for k, t in p.items() if k != "wo"},
                              xl, xl, pos_b, pos_b, cfg)
    q_first, kv_first = local_offsets(p["wq"])[1], local_offsets(p["wk"])[1]
    q_split = p["wq"].placements[0].is_shard()
    keys = cache["k"]
    slot = position % keys.shape[1]  # ring buffer; the owner follows the ring slot
    new, first = {"k": kn, "v": vn}, {"k": kv_first, "v": kv_first}
    if "k_scale" in cache:
        for name in ("k", "v"):
            new[name], new[name + "_scale"] = _quant_kv(new[name])
            first[name + "_scale"] = first[name]
        if cache["k_scale"].to_local().shape[2] > new["k_scale"].shape[2]:
            # the scales keep every KV head: gather the new token's over model, k's and
            # v's in one call
            parts = collectives_dist.Wire(model.get_group()).all_gather(
                torch.stack([new["k_scale"], new["v_scale"]]))
            new["k_scale"], new["v_scale"] = torch.cat(parts, dim=3).unbind()
            first["k_scale"] = first["v_scale"] = 0
    new["pos"], first["pos"] = pos_b, 0
    for name, value in new.items():
        _write_slot(cache[name], slot, value, first[name])

    kl = keys.to_local()
    if "k_scale" in cache:
        kk = _dequant_kv(kl, _local_like(cache["k_scale"], keys), x.dtype)
        vv = _dequant_kv(cache["v"].to_local(), _local_like(cache["v_scale"], cache["v"]),
                         x.dtype)
    else:
        kk, vv = kl.to(x.dtype), cache["v"].to_local().to(x.dtype)
    split = [i for i, pl in enumerate(keys.placements) if pl.is_shard(1)]
    own = None
    if split and keys.device_mesh.mesh_dim_names[split[0]] == "model" and q_split:
        # the model group splits the slots: every rank attends every query head
        own = slice(q_first, q_first + ql.shape[2])
        ql = torch.cat(collectives_dist.Wire(model.get_group()).all_gather(ql), dim=2)
        q_first = 0
    pick = kv_pick(cfg.n_heads, cfg.n_kv_heads, q_first, ql.shape[2], local_offsets(keys)[2])
    kk, vv = kk[:, :, pick], vv[:, :, pick]
    mask = build_mask(pos_b, _local_like(cache["pos"], keys), "causal", cfg.sliding_window)
    if split:
        out = _seq_split_attention(ql, kk, vv, mask, _split_group(keys, split))
    else:
        out = dense_attention(ql, kk, vv, mask)
    if own is not None:
        out = out[:, :, own]
    out = DTensor.from_local(out, model, [Shard(2) if q_split else Replicate()],
                             run_check=False)
    return reduced(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))), cache


def cross_decode_attention(p: dict, x: Tensor, cross_k: Tensor, cross_v: Tensor,
                           position: int) -> Tensor:
    """One token's cross-attention (whisper's decoder): ``q`` of ``x`` [B, 1,
    D] (``wq``, no bias, no RoPE) over the fixed encoder keys and values
    ``cross_k``/``cross_v`` [B, S_enc, H, D], every frame attended, then
    ``wo``. With the pair placed by the policy's cache specs (DTensors on the
    ``(data, model)`` mesh: the heads over model where they divide, as
    ``wq``'s) and ``p`` and ``x`` on this data rank's model group, each rank
    attends its own query heads over its own heads of the pair, and ``wo``'s
    row-parallel product is summed over model."""
    if isinstance(cross_k, DTensor):
        if any(not pl.is_replicate() for pl in x.placements):
            raise ValueError("decode attention takes a whole x: reduce the layer's input first")
        xl, wq = x.to_local(), p["wq"]
        q = torch.einsum("bsd,dhk->bshk", xl, wq.to_local().to(xl.dtype))
        out = DTensor.from_local(_cross_core(q, cross_k.to_local(), cross_v.to_local(),
                                             position), x.device_mesh,
                                 [Shard(2) if wq.placements[0].is_shard() else Replicate()],
                                 run_check=False)
        return reduced(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)))
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    return torch.einsum("bshk,hkd->bsd", _cross_core(q, cross_k, cross_v, position),
                        p["wo"].to(x.dtype))


def _cross_core(q: Tensor, k: Tensor, v: Tensor, position: int) -> Tensor:
    b, enc_len = q.shape[0], k.shape[1]
    mask = build_mask(torch.full((b, 1), position, dtype=torch.int32, device=q.device),
                      torch.arange(enc_len, dtype=torch.int32, device=q.device)[None]
                      .expand(b, enc_len), "bidirectional")
    return dense_attention(q, k.to(q.dtype), v.to(q.dtype), mask)


def _write_slot(leaf: DTensor, slot: int, new: Tensor, first: int) -> None:
    """``new`` [b, 1, ...] (its dim 2, if any, the heads from ``first``) at
    global slot ``slot`` of ``leaf``'s dim 1, written through the local tensor
    of the rank whose shard holds the slot; the other ranks write nothing."""
    off, local = local_offsets(leaf), leaf.to_local()
    at = slot - off[1]
    if not 0 <= at < local.shape[1]:
        return
    if local.dim() > 2:
        new = new.narrow(2, off[2] - first, local.shape[2])
    local[:, at] = new[:, 0].to(local.dtype)


def _local_like(leaf: DTensor, like: DTensor, dims: Optional[tuple[int, ...]] = None) -> Tensor:
    """The part of ``leaf`` (``pos``, the int8 scales or MLA's ``k_pe``) beside
    ``like``'s local keys on ``dims``: by default dims 1 (slots) and 2 (heads,
    where ``leaf`` has them). ``leaf`` is first gathered over any mesh dim
    that splits one of those dims and does not split ``like``'s the same way
    (``pos`` over data where the keys' sequence is split over model)."""
    dims = range(1, min(leaf.dim(), 3)) if dims is None else dims
    if any(pl.is_shard() and pl.dim in dims and pl != like.placements[i]
           for i, pl in enumerate(leaf.placements)):
        leaf = redistribute(leaf, [Replicate() if pl.is_shard() and pl.dim in dims
                                   and pl != like.placements[i] else pl
                                   for i, pl in enumerate(leaf.placements)])
    out, off, at = leaf.to_local(), local_offsets(leaf), local_offsets(like)
    for d in dims:
        out = out.narrow(d, at[d] - off[d], like.to_local().shape[d])
    return out


def _split_group(leaf: DTensor, dims: list[int]):
    """The group over which ``leaf``'s mesh dims ``dims`` split its sequence:
    one dim's own group, or several taken as one axis, major first
    (``("pod", "data")``, ``flat_dp``'s ``("data", "model")``)."""
    names = leaf.device_mesh.mesh_dim_names
    return flat_group(leaf.device_mesh, tuple(names[i] for i in dims))


def _seq_split_attention(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, group,
                         scale: Optional[float] = None) -> Tensor:
    """:func:`dense_attention` of local ``q`` over keys whose sequence is split
    over ``group``, each rank holding its own slots, in two all-reduces: the
    softmax's max per (row, head), then, in one call, the sum of the
    exponentials and the exponential-weighted values, in fp32; their
    quotient is the attention, cast to ``q``'s dtype."""
    b, sq, h, dk = q.shape
    kv, dv = k.shape[2], v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    wire = collectives_dist.Wire(group)
    qg = q.reshape(b, sq, kv, h // kv, dk)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() * scale
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    e = torch.exp(s - wire.all_reduce(s.amax(dim=-1, keepdim=True), op=dist.ReduceOp.MAX))
    acc = torch.einsum("bhrqk,bkhd->bhrqd", e, v.float())
    both = wire.all_reduce(torch.cat([acc, e.sum(dim=-1, keepdim=True)], dim=-1))
    out = both[..., :dv] / both[..., dv:]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, d: int, n_heads: int, kv_lora_rank: int,
             qk_nope_dim: int, qk_rope_dim: int, v_dim: int, dtype=torch.float32,
             lead: tuple[int, ...] = (), kv_norm: bool = False) -> dict:
    """MLA's params; with ``kv_norm`` the latent's RMSNorm scale too (fp32,
    stored as 1 + w, as every RMSNorm of the port)."""
    p = {
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
    if kv_norm:
        p["kv_norm"] = init_norm("rmsnorm", kv_lora_rank, lead, gen.device)
    return p


def _mla_query(p: dict, x: Tensor, positions: Tensor, cfg) -> Tensor:
    """[B,S,H,nope+rope]: the nope lanes as projected, the rope lanes roped."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    nope = cfg.mla_qk_nope_dim
    return torch.cat([q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta,
                                                yarn=yarn_of(cfg))], dim=-1)


def _mla_latent(p: dict, x: Tensor, positions: Tensor, cfg) -> tuple[Tensor, Tensor]:
    """The cached pair: latent ``c_kv`` [B,S,rank] (RMS-normed where the
    configuration norms it) and roped ``k_pe`` [B,S,rope] (full rotary on the
    interleaved lanes, one head shared by all)."""
    dt = x.dtype
    c_kv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"].to(dt))
    if cfg.mla_kv_norm:
        c_kv = apply_norm("rmsnorm", p["kv_norm"], c_kv)
    k_pe = torch.einsum("bsd,dk->bsk", x, p["w_kpe"].to(dt))[:, :, None, :]
    return c_kv, apply_rope(k_pe, positions, cfg.rope_theta, yarn=yarn_of(cfg))[:, :, 0, :]


def _mla_keys_values(p: dict, c_kv: Tensor, k_pe: Tensor, cfg) -> tuple[Tensor, Tensor]:
    """Decompress the latent: K = [c_kv·w_uk, k_pe broadcast over heads], V = c_kv·w_uv."""
    dt = c_kv.dtype
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"].to(dt))
    v = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"].to(dt))
    k_pe = k_pe[:, :, None, :].expand(*k_nope.shape[:3], cfg.mla_qk_rope_dim)
    return torch.cat([k_nope, k_pe], dim=-1), v


def _mla_scale(cfg) -> float:
    """1/sqrt(nope + rope), times mscale(factor, mscale_all_dim)² under YaRN
    (DeepSeek-V2: 0.0722 x 1.5897 = 0.11472)."""
    scale = 1.0 / math.sqrt(cfg.mla_qk_nope_dim + cfg.mla_qk_rope_dim)
    if cfg.yarn_factor is not None and cfg.yarn_mscale_all_dim:
        scale *= yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return scale


def mla_forward(p: dict, x: Tensor, positions: Tensor, cfg,
                use_chunked: Optional[bool] = None, cache: Optional[dict] = None) -> Tensor:
    """Full-sequence MLA. The latent c_kv (rank 512) + shared k_pe (64) are
    what a server caches: 576 values per token against 2·H·D = 4096. With
    ``cache`` (``init_mla_cache``'s, plain tensors) the pair is written into
    its slots 0..S−1, for :func:`mla_decode` to go on from.

    With DTensor params on the model axis (``wq``, ``w_uk``, ``w_uv`` and
    ``wo`` split over heads, ``w_dkv`` and ``w_kpe`` whole), the latent pair
    is made whole on every rank and the decompression and the attention run
    on each rank's own heads inside ``local_map``, ``k_pe`` broadcast to
    those heads only; the latent pair's gradient is then a partial sum over
    the ranks that split the heads."""
    x = whole_grad(x)
    q = _mla_query(p, x, positions, cfg)
    c_kv, k_pe = _mla_latent(p, x, positions, cfg)
    s = x.shape[1]
    if cache is not None:
        cache["c_kv"][:, :s] = c_kv.to(cache["c_kv"].dtype)
        cache["k_pe"][:, :s] = k_pe.to(cache["k_pe"].dtype)
        cache["pos"][:, :s] = positions
    if use_chunked is None:
        use_chunked = s * s > cfg.dense_attn_limit

    def core(q, c_kv, k_pe, w_uk, w_uv):
        k, v = _mla_keys_values({"w_uk": w_uk, "w_uv": w_uv}, c_kv, k_pe, cfg)
        if use_chunked:
            return chunked_attention(q, k, v, positions, positions, "causal", None, 0,
                                     chunk=cfg.attn_chunk, scale=_mla_scale(cfg))
        mask = build_mask(positions, positions, "causal")
        return dense_attention(q, k, v, mask, scale=_mla_scale(cfg))

    if isinstance(q, DTensor):
        heads = [Partial() if pl.is_shard(2) else pl for pl in q.placements]
        ups = (p["w_uk"], p["w_uv"])
        out = local_map(core, out_placements=list(q.placements),
                        in_placements=(q.placements, c_kv.placements, k_pe.placements,
                                       *(w.placements for w in ups)),
                        in_grad_placements=(q.placements, heads, heads,
                                            *(w.placements for w in ups)))(
                                                q, c_kv, k_pe, *ups)
    else:
        out = core(q, c_kv, k_pe, p["w_uk"], p["w_uv"])
    return reduced(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)))


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
    into the query). A cache of DTensors placed by the policy's cache
    specs takes :func:`placed_mla_decode`."""
    if isinstance(cache["c_kv"], DTensor):
        return placed_mla_decode(p, x, cache, position, cfg)
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


def placed_mla_decode(p: dict, x: Tensor, cache: dict, position: int,
                      cfg) -> tuple[Tensor, dict]:
    """:func:`mla_decode` on a latent cache whose leaves are DTensors on the
    ``(data, model)`` mesh, placed by ``ShardingPolicy.cache_spec`` (``c_kv``
    with its sequence over model where it divides, ``k_pe`` split only by its
    batch, ``pos`` by its batch or else its sequence over data), with ``p``
    and ``x`` DTensors on this data rank's model group. Every rank works on
    its local tensors, and no cache leaf crosses the wire but ``pos``, where
    it is split over data beside a ``c_kv`` split over model:

      * the new token's latent pair goes into the local tensor of each leaf
        whose shard holds slot ``position % L``: ``c_kv``'s owner alone where
        its sequence is split, every rank for ``k_pe`` and a whole ``pos``;
      * the attention runs in the latent space (``w_uk`` absorbed into the
        query, ``w_uv`` applied after the sum): each rank forms
        ``q_nope·w_ukᵀ`` [B, H/tp, r] for its heads and, where the model
        group splits ``c_kv``'s slots, gathers these small rows and the rope
        lanes of every head; it scores them over its own slots,
        ``q_lat·c_kv + q_pe·k_pe``, masked by the slice of ``pos`` beside
        them, and the softmax's max, then its sum and the weighted latent
        rows ``Σ p·c_kv`` [B, H, r], are added over the group that splits
        the slots (:func:`_seq_split_attention`, one key head read by every
        query head, the latent rows its values). Each
        rank keeps its heads, applies its ``w_uv``, then the row-parallel
        ``wo``. The function JAX computes, its products in another order.
    """
    if any(not pl.is_replicate() for pl in x.placements):
        raise ValueError("decode attention takes a whole x: reduce the layer's input first")
    model = x.device_mesh  # this data rank's model group
    xl, dt = x.to_local(), x.dtype
    b = xl.shape[0]
    pos_b = torch.full((b, 1), position, dtype=torch.int32, device=xl.device)
    local = {k: {n: w.to_local() for n, w in t.items()} if isinstance(t, dict) else t.to_local()
             for k, t in p.items()}
    q = _mla_query(local, xl, pos_b, cfg)  # [b, 1, H_l, nope + rope]
    c_new, kpe_new = _mla_latent(local, xl, pos_b, cfg)
    c_kv = cache["c_kv"]
    slot = position % c_kv.shape[1]
    for name, value in (("c_kv", c_new), ("k_pe", kpe_new), ("pos", pos_b)):
        _write_slot(cache[name], slot, value, 0)

    nope, r = cfg.mla_qk_nope_dim, cfg.mla_kv_lora_rank
    q_lat = torch.einsum("bqhn,rhn->bqhr", q[..., :nope], local["w_uk"].to(dt))
    q_both = torch.cat([q_lat, q[..., nope:]], dim=-1)  # [b, 1, H_l, r + rope]
    q_split = p["wq"].placements[0].is_shard()
    split = [i for i, pl in enumerate(c_kv.placements) if pl.is_shard(1)]
    own = None
    if split and c_kv.device_mesh.mesh_dim_names[split[0]] == "model" and q_split:
        # the model group splits the slots: every rank scores every head
        first = local_offsets(p["wq"])[1]
        own = slice(first, first + q_both.shape[2])
        q_both = torch.cat(collectives_dist.Wire(model.get_group()).all_gather(q_both), dim=2)
    # this rank's slots [b, L_l, 1, r + rope]: one key head that every query head reads,
    # and the latent rows its values
    keys = torch.cat([c_kv.to_local(), _local_like(cache["k_pe"], c_kv, dims=(1,))],
                     dim=-1).to(dt)[:, :, None]
    mask = build_mask(pos_b, _local_like(cache["pos"], c_kv), "causal")
    if split:
        out = _seq_split_attention(q_both, keys, keys[..., :r], mask, _split_group(c_kv, split),
                                   _mla_scale(cfg))
    else:
        out = dense_attention(q_both, keys, keys[..., :r], mask, scale=_mla_scale(cfg))
    if own is not None:  # [b, 1, H, r]
        out = out[:, :, own]
    out = torch.einsum("bqhr,rhv->bqhv", out, local["w_uv"].to(dt))
    out = DTensor.from_local(out, model, [Shard(2) if q_split else Replicate()],
                             run_check=False)
    return reduced(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))), cache
