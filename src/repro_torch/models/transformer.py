"""Model assembly for the decoder: block pattern → init / forward / loss / decode.

The twin of ``repro.models.transformer`` for every decoder block kind: the
``"dense"`` and ``"moe"`` blocks (standard attention, then an MLP or MoE),
the ``"mla_dense"`` and ``"mla_moe"`` blocks (MLA, then an MLP or MoE), and
the ``"mamba2"``, ``"mlstm"`` and ``"slstm"`` mixers of ``models/ssm.py``;
and zamba2's weight-shared dense block, interposed before every
``shared_attn_every``-th layer over ``concat(x, x_embed)``. Layers are
grouped into segments of consecutive identical block kinds, and each
segment's params are stacked along a leading layer axis, as in the JAX
pytree; a Python loop over that axis takes the place of ``lax.scan``. The
shared block is one unstacked block. ``cfg.remat`` recomputes each block in
the backward pass (``torch.utils.checkpoint``, non-reentrant), as
``jax.checkpoint`` does; every ``remat_policy`` recomputes the whole block,
which changes memory and time but not the numbers. The MoE blocks' balance
loss is summed over layers into ``forward_logits``'s aux. The encdec and
vlm model kinds raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.models.layers import (apply_mlp, apply_norm, cross_entropy, dense_init,
                                       embed_init, init_mlp, init_norm)

Tensor = torch.Tensor
Params = Any  # nested dict/list of tensors, shaped like the JAX pytree

_KINDS = ("dense", "moe", "mla_dense", "mla_moe", "mamba2", "mlstm", "slstm")
_SSM_KINDS = ("mamba2", "mlstm", "slstm")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.kind != "decoder":
        raise NotImplementedError(
            f"model kind {cfg.kind!r} is not ported yet (ROADMAP Queue 1 item 11)")
    for kind in cfg.block_pattern:
        if kind not in _KINDS:
            raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------

def segments_of(cfg: ModelConfig) -> list[tuple[str, int]]:
    """Group the block pattern into (kind, count) runs, splitting at shared-
    attention interposition points (zamba2)."""
    segs: list[tuple[str, int]] = []
    for i, kind in enumerate(cfg.block_pattern):
        boundary = (cfg.shared_attn_every
                    and i % cfg.shared_attn_every == 0 and i > 0)
        if segs and segs[-1][0] == kind and not boundary:
            segs[-1] = (kind, segs[-1][1] + 1)
        else:
            segs.append((kind, 1))
    return segs


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_mix(gen: torch.Generator, kind: str, cfg: ModelConfig,
              lead: tuple[int, ...]) -> dict:
    """An SSM block's mixer params."""
    d, pd = cfg.d_model, cfg.pdtype
    if kind == "mamba2":
        return ssm.init_mamba2(gen, d, cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_expand,
                               dtype=pd, lead=lead)
    if kind == "mlstm":
        return ssm.init_mlstm(gen, d, cfg.n_heads, cfg.xlstm_expand, dtype=pd, lead=lead)
    return ssm.init_slstm(gen, d, cfg.n_heads, dtype=pd, lead=lead)


def _init_block(gen: torch.Generator, kind: str, cfg: ModelConfig,
                lead: tuple[int, ...]) -> dict:
    """Blocks of ``kind`` stacked along ``lead`` (``(count,)`` for a segment,
    ``()`` for zamba2's one shared block)."""
    d, pd, dev = cfg.d_model, cfg.pdtype, gen.device
    if kind in _SSM_KINDS:
        return {"ln1": init_norm(cfg.norm, d, lead, dev), "mix": _init_mix(gen, kind, cfg, lead)}
    if kind in ("dense", "moe"):
        mix = attn.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                  cfg.qkv_bias, pd, lead)
    else:
        mix = attn.init_mla(gen, d, cfg.n_heads, cfg.mla_kv_lora_rank, cfg.mla_qk_nope_dim,
                            cfg.mla_qk_rope_dim, cfg.mla_v_dim, pd, lead)
    p = {"ln1": init_norm(cfg.norm, d, lead, dev), "attn": mix,
         "ln2": init_norm(cfg.norm, d, lead, dev)}
    if kind in ("dense", "mla_dense"):
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_style, pd, lead)
    else:
        p["moe"] = moe_lib.init_moe(gen, d, cfg.moe_d_ff, cfg.moe_experts,
                                    cfg.moe_shared_experts,
                                    cfg.moe_shared_experts * cfg.moe_d_ff or None, pd, lead)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params on ``gen``'s device, with the JAX init's distributions."""
    _check_supported(cfg)
    d = cfg.d_model
    params: dict = {"embed": embed_init(gen, (cfg.vocab_size, d), cfg.pdtype)}
    params["segments"] = [_init_block(gen, kind, cfg, (count,))
                          for kind, count in segments_of(cfg)]
    params["final_norm"] = init_norm(cfg.norm, d, device=gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype=cfg.pdtype)
    if cfg.shared_attn_every:
        params["shared_block"] = _init_block(gen, "dense", cfg, ())
        params["shared_proj"] = dense_init(gen, (2 * d, d), dtype=cfg.pdtype)
    return params


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _layers(seg_params: dict, count: int) -> list[dict]:
    """The ``count`` layers of a stacked segment (views, no copies).

    One ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing each layer (``leaf[i]``) would make every layer's
    backward write a zero-filled gradient of the whole stack and add it
    (the same values, with ``count`` times the memory traffic)."""
    per_key = {k: _layers(v, count) if isinstance(v, dict) else torch.unbind(v)
               for k, v in seg_params.items()}
    return [{k: v[i] for k, v in per_key.items()} for i in range(count)]


def _ffn(kind: str, p: dict, h: Tensor, cfg: ModelConfig,
         capacity_factor: float) -> tuple[Tensor, Tensor]:
    """A block's second half: its MLP, or its MoE and balance loss."""
    if kind in ("dense", "mla_dense"):
        return apply_mlp(p["mlp"], h, cfg.mlp_style), torch.zeros(
            (), dtype=torch.float32, device=h.device)
    return moe_lib.apply_moe(p["moe"], h, cfg.moe_top_k, capacity_factor)


def _mix_forward(kind: str, p: dict, h: Tensor, cfg: ModelConfig) -> Tensor:
    """An SSM block's mixer over the normed input."""
    if kind == "mamba2":
        return ssm.mamba2_forward(p, h, cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_expand,
                                  cfg.ssm_chunk)
    if kind == "mlstm":
        return ssm.mlstm_forward(p, h, cfg.n_heads, cfg.xlstm_expand)
    return ssm.slstm_forward(p, h, cfg.n_heads)


def _block_forward(kind: str, p: dict, x: Tensor, positions: Tensor,
                   cfg: ModelConfig, mask_kind: str, prefix_len: int) -> tuple[Tensor, Tensor]:
    h = apply_norm(cfg.norm, p["ln1"], x)
    if kind in _SSM_KINDS:
        return x + _mix_forward(kind, p["mix"], h, cfg), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    if kind in ("dense", "moe"):
        x = x + attn.attention_forward(p["attn"], h, positions, cfg, mask_kind,
                                       prefix_len, use_pallas=cfg.use_pallas)
    else:
        x = x + attn.mla_forward(p["attn"], h, positions, cfg)
    h = apply_norm(cfg.norm, p["ln2"], x)
    y, aux = _ffn(kind, p, h, cfg, cfg.moe_capacity_factor)
    return x + y, aux


def _shared_block_forward(params: Params, x: Tensor, x0: Tensor, positions: Tensor,
                          cfg: ModelConfig) -> Tensor:
    """Zamba2: the weight-shared dense block over concat(x, x0), added to x
    (the block keeps its own residuals, so x gets both)."""
    h = torch.cat([x, x0], dim=-1) @ params["shared_proj"].to(x.dtype)
    h, _ = _block_forward("dense", params["shared_block"], h, positions, cfg, "causal", 0)
    return x + h


def _shared_site(cfg: ModelConfig, layer: int) -> bool:
    """Whether zamba2's shared block runs just before layer ``layer``."""
    return bool(cfg.shared_attn_every) and layer > 0 and layer % cfg.shared_attn_every == 0


def forward_logits(params: Params, batch: dict, cfg: ModelConfig) -> tuple[Tensor, Tensor]:
    """Full-sequence forward → (logits [B,S,V], aux_loss).

    ``batch``: {"tokens": [B,S]}. Positions are 0..S−1. The aux loss is the
    MoE balance term summed over layers, 0 without MoE blocks.
    """
    _check_supported(cfg)
    cdt = cfg.cdtype
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["embed"][tokens].to(cdt)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x0, layer_idx = x, 0
    for seg_params, (kind, count) in zip(params["segments"], segments_of(cfg)):
        if _shared_site(cfg, layer_idx):  # segments split at every site
            x = _shared_block_forward(params, x, x0, positions, cfg)
        layer_idx += count
        for layer in _layers(seg_params, count):
            args = (kind, layer, x, positions, cfg, "causal", 0)
            x, a = (checkpoint(_block_forward, *args, use_reentrant=False) if remat
                    else _block_forward(*args))
            aux = aux + a
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(params, x, cfg), aux


def _unembed(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
    return x @ params["lm_head"].to(x.dtype)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def loss_fn(params: Params, batch: dict, cfg: ModelConfig) -> Tensor:
    """Next-token cross-entropy plus the weighted MoE balance loss."""
    logits, aux = forward_logits(params, batch, cfg)
    ce = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
    return ce + cfg.aux_loss_weight * aux


# ---------------------------------------------------------------------------
# decode (serve step)
# ---------------------------------------------------------------------------

def cache_layout(cfg: ModelConfig) -> list[str]:
    """Static tag sequence for the decode cache list: one entry per layer,
    plus one ``"shared"`` per zamba2 shared-block call site, just before the
    layer it precedes."""
    _check_supported(cfg)
    tags: list[str] = []
    for i, kind in enumerate(cfg.block_pattern):
        if _shared_site(cfg, i):
            tags.append("shared")
        tags.append(kind)
    return tags


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None) -> list:
    """One cache per ``cache_layout`` entry: a KV cache for standard attention
    (SWA archs keep ``window`` slots; a shared site keeps ``max_len``), a
    latent cache of ``max_len`` slots in the compute dtype for MLA (whatever
    ``kv_cache_dtype`` says, as in JAX), and a recurrent state for an SSM
    block (fp32, the conv history in the compute dtype)."""
    cdt = cfg.cdtype
    kv_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv_dt = "int8" if cfg.kv_cache_dtype == "int8" else cdt  # int8: init_kv_cache refuses
    caches = []
    for tag in cache_layout(cfg):
        if tag in ("dense", "moe", "shared"):
            caches.append(attn.init_kv_cache(batch, max_len if tag == "shared" else kv_len,
                                             cfg.n_kv_heads, cfg.head_dim, kv_dt, device))
        elif tag in ("mla_dense", "mla_moe"):
            caches.append(attn.init_mla_cache(batch, max_len, cfg.mla_kv_lora_rank,
                                              cfg.mla_qk_rope_dim, cdt, device))
        elif tag == "mamba2":
            caches.append(ssm.init_mamba2_state(batch, cfg.d_model, cfg.ssm_state,
                                                cfg.ssm_headdim, cfg.ssm_expand,
                                                dtype=cdt, device=device))
        elif tag == "mlstm":
            caches.append(ssm.init_mlstm_state(batch, cfg.d_model, cfg.n_heads,
                                               cfg.xlstm_expand, dtype=cdt, device=device))
        else:
            caches.append(ssm.init_slstm_state(batch, cfg.d_model, cfg.n_heads, device))
    return caches


def _flatten_layer_params(params: Params, cfg: ModelConfig) -> list[tuple[str, dict]]:
    return [(kind, layer)
            for seg_params, (kind, count) in zip(params["segments"], segments_of(cfg))
            for layer in _layers(seg_params, count)]


def _decode_block(kind: str, p: dict, x: Tensor, cache: dict, position: int,
                  cfg: ModelConfig) -> tuple[Tensor, dict]:
    h = apply_norm(cfg.norm, p["ln1"], x)
    if kind == "mamba2":
        y, cache = ssm.mamba2_step(p["mix"], h, cache, cfg.ssm_state, cfg.ssm_headdim,
                                   cfg.ssm_expand)
        return x + y, cache
    if kind == "mlstm":
        y, cache = ssm.mlstm_step(p["mix"], h, cache, cfg.n_heads, cfg.xlstm_expand)
        return x + y, cache
    if kind == "slstm":
        y, cache = ssm.slstm_step(p["mix"], h, cache, cfg.n_heads)
        return x + y, cache
    if kind in ("dense", "moe"):
        a, cache = attn.decode_attention(p["attn"], h, cache, position, cfg)
    else:
        a, cache = attn.mla_decode(p["attn"], h, cache, position, cfg)
    x = x + a
    h = apply_norm(cfg.norm, p["ln2"], x)
    # the JAX package decodes MoE at a literal capacity factor of 2.0 (cap = 1 at S = 1)
    return x + _ffn(kind, p, h, cfg, 2.0)[0], cache


def _decode_shared(params: Params, x: Tensor, x0: Tensor, cache: dict, position: int,
                   cfg: ModelConfig) -> tuple[Tensor, dict]:
    """Zamba2's shared block at one call site, written out as JAX's
    ``decode_step`` writes it: the dense block's two residuals, then x + h."""
    h = torch.cat([x, x0], dim=-1) @ params["shared_proj"].to(cfg.cdtype)
    sp = params["shared_block"]
    a, cache = attn.decode_attention(sp["attn"], apply_norm(cfg.norm, sp["ln1"], h), cache,
                                     position, cfg)
    h = h + a
    h = h + apply_mlp(sp["mlp"], apply_norm(cfg.norm, sp["ln2"], h), cfg.mlp_style)
    return x + h, cache


def decode_step(params: Params, caches: list, tokens: Tensor, position: int,
                cfg: ModelConfig) -> tuple[Tensor, list]:
    """One decode step: tokens [B,1] at absolute ``position``. KV and latent
    caches are updated in place; an SSM block's state is replaced. The
    returned list holds every layer's cache as it now stands."""
    cdt = cfg.cdtype
    x = params["embed"][tokens].to(cdt)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt)
    new_caches: list = []
    x0, it = x, iter(caches)
    for i, (kind, p) in enumerate(_flatten_layer_params(params, cfg)):
        if _shared_site(cfg, i):  # its cache sits before the layer's (cache_layout)
            x, cache = _decode_shared(params, x, x0, next(it), position, cfg)
            new_caches.append(cache)
        x, cache = _decode_block(kind, p, x, next(it), position, cfg)
        new_caches.append(cache)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(params, x, cfg), new_caches
