"""Model assembly: block pattern → init / forward / loss / decode.

The twin of ``repro.models.transformer`` for every model kind and block
kind: the ``"dense"`` and ``"moe"`` blocks (standard attention, then an MLP
or MoE), the ``"mla_dense"`` and ``"mla_moe"`` blocks (MLA, then an MLP or
MoE), and the ``"mamba2"``, ``"mlstm"`` and ``"slstm"`` mixers of
``models/ssm.py``; and zamba2's weight-shared dense block, interposed before every
``shared_attn_every``-th layer over ``concat(x, x_embed)``. Layers are
grouped into segments of consecutive identical block kinds, and each
segment's params are stacked along a leading layer axis, as in the JAX
pytree; a Python loop over that axis takes the place of ``lax.scan``. The
shared block is one unstacked block. ``cfg.remat`` recomputes each block in
the backward pass (``torch.utils.checkpoint``, non-reentrant), as
``jax.checkpoint`` does; every ``remat_policy`` recomputes the whole block,
which changes memory and time but not the numbers. The MoE blocks' balance
loss is summed over layers into ``forward_logits``'s aux. Inside a train step
run under ``torch.profiler`` the embedding, the norms, the attention, the MLP
or MoE, the unembedding and the loss mark their forward and backward, and each
block its recomputation (:mod:`repro_torch.spans`).

Whisper (``kind="encdec"``) adds an encoder stack of bidirectional dense
blocks over precomputed frame embeddings (``use_pallas`` sends its attention
through the flash kernel), and its decoder's blocks add cross-attention over
the encoder's output; both attentions of a decoder block stay dense, as in
JAX. PaliGemma (``kind="vlm"``) puts stub image embeddings in front of the
scaled token embeddings under a prefix-LM mask, which the kernel cannot
take, so it runs dense.

The decoder runs tensor-parallel on DTensor params placed by the sharding
policy (``launch.steps`` on a process mesh with a model axis): the tensors
it makes for itself (positions, masks, rope tables, zeros) enter as
replicated DTensors under ``implicit_replication``, and the attention core
makes its own inside ``local_map``. A vocab-sharded embedding is looked up by
DTensor's masked rule (:func:`_lookup`). The MoE blocks run expert-parallel
(``moe.apply_moe``), the MLA blocks on each rank's heads
(``attention.mla_forward``) and the SSM mixers whole on every rank
(``ssm.replicated_mixer``). Its decode step takes caches placed by the
policy's cache specs (``attention.placed_decode_attention``,
``attention.placed_mla_decode``, ``attention.cross_decode_attention`` and
``ssm.placed_step``, each rank on its own heads of a split state).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.models.layers import (apply_mlp, apply_norm, cross_entropy, dense_init,
                                       embed_init, init_mlp, init_norm, reduced, whole_grad,
                                       sinusoidal_positions)
from repro_torch.sharding.policy import gather_data

Tensor = torch.Tensor
Params = Any  # nested dict/list of tensors, shaped like the JAX pytree

_KINDS = ("dense", "moe", "mla_dense", "mla_moe", "mamba2", "mlstm", "slstm")
_SSM_KINDS = ("mamba2", "mlstm", "slstm")
_MODEL_KINDS = ("decoder", "encdec", "vlm")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.kind not in _MODEL_KINDS:
        raise ValueError(f"unknown model kind {cfg.kind!r}")
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
                            cfg.mla_qk_rope_dim, cfg.mla_v_dim, pd, lead, cfg.mla_kv_norm)
    p = {"ln1": init_norm(cfg.norm, d, lead, dev), "attn": mix,
         "ln2": init_norm(cfg.norm, d, lead, dev)}
    if kind in ("dense", "mla_dense"):
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_style, pd, lead)
    else:
        p["moe"] = moe_lib.init_moe(gen, d, cfg.moe_d_ff, cfg.moe_experts,
                                    cfg.moe_shared_experts,
                                    cfg.moe_shared_experts * cfg.moe_d_ff or None, pd, lead)
    return p


def _init_cross_block(gen: torch.Generator, cfg: ModelConfig, lead: tuple[int, ...]) -> dict:
    """Whisper's decoder blocks: self-attention, cross-attention, MLP."""
    d, pd, dev = cfg.d_model, cfg.pdtype, gen.device

    def attention():
        return attn.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                   cfg.qkv_bias, pd, lead)
    return {"ln1": init_norm(cfg.norm, d, lead, dev), "attn": attention(),
            "ln_x": init_norm(cfg.norm, d, lead, dev), "xattn": attention(),
            "ln2": init_norm(cfg.norm, d, lead, dev),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.mlp_style, pd, lead)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random params on ``gen``'s device, with the JAX init's distributions
    and its tree: for encdec an ``encoder`` stack, and one segment of cross
    blocks in place of the decoder's."""
    _check_supported(cfg)
    d = cfg.d_model
    params: dict = {"embed": embed_init(gen, (cfg.vocab_size, d), cfg.pdtype)}
    if cfg.kind == "encdec":
        params["segments"] = [_init_cross_block(gen, cfg, (cfg.n_layers,))]
        params["encoder"] = {"layers": _init_block(gen, "dense", cfg, (cfg.enc_layers,)),
                             "final_norm": init_norm(cfg.norm, d, device=gen.device)}
    else:
        params["segments"] = [_init_block(gen, kind, cfg, (count,))
                              for kind, count in segments_of(cfg)]
    params["final_norm"] = init_norm(cfg.norm, d, device=gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype=cfg.pdtype)
    if cfg.shared_attn_every:
        params["shared_block"] = _init_block(gen, "dense", cfg, ())
        params["shared_proj"] = dense_init(gen, (2 * d, d), dtype=cfg.pdtype)
    return params


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: ``init_params``
    puts its tensors on ``gen.device``, and a meta tensor's init draws
    nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def param_shapes(cfg: ModelConfig) -> Params:
    """The params tree on the meta device: every leaf's shape and dtype,
    nothing allocated (dbrx's 132 B params cost nothing). The twin of
    JAX ``param_shapes``, the dry-run's and the sharding policy's input."""
    return init_params(_MetaGenerator(), cfg)


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
         capacity_factor: Optional[float]) -> tuple[Tensor, Tensor]:
    """A block's second half: its MLP, or its MoE and balance loss."""
    if kind in ("dense", "mla_dense"):
        return apply_mlp(p["mlp"], h, cfg.mlp_style), torch.zeros(
            (), dtype=torch.float32, device=h.device)
    return moe_lib.apply_moe(p["moe"], h, cfg.moe_top_k, capacity_factor,
                             cfg.moe_norm_topk_prob)


def _mix_forward(kind: str, p: dict, h: Tensor, cfg: ModelConfig) -> Tensor:
    """An SSM block's mixer over the normed input; on the model axis, whole
    on every rank's local tensors (``ssm.replicated_mixer``)."""
    if isinstance(h, DTensor):
        return ssm.replicated_mixer(lambda p, h: _mix_forward(kind, p, h, cfg), p, h)
    if kind == "mamba2":
        return ssm.mamba2_forward(p, h, cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_expand,
                                  cfg.ssm_chunk)
    if kind == "mlstm":
        return ssm.mlstm_forward(p, h, cfg.n_heads, cfg.xlstm_expand)
    return ssm.slstm_forward(p, h, cfg.n_heads)


def _block_forward(kind: str, p: dict, x: Tensor, positions: Tensor,
                   cfg: ModelConfig, mask_kind: str, prefix_len: int,
                   cache: Optional[dict] = None) -> tuple[Tensor, Tensor]:
    h = spans.wrap("norm", x, lambda t: apply_norm(cfg.norm, p["ln1"], t))
    if kind in _SSM_KINDS:
        return x + _mix_forward(kind, p["mix"], h, cfg), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    if kind in ("dense", "moe"):
        x = x + spans.wrap("attention", h, lambda t: attn.attention_forward(
            p["attn"], t, positions, cfg, mask_kind, prefix_len, use_pallas=cfg.use_pallas))
    else:
        x = x + spans.wrap("attention", h, lambda t: attn.mla_forward(p["attn"], t, positions,
                                                                       cfg, cache=cache))
    h = spans.wrap("norm", x, lambda t: apply_norm(cfg.norm, p["ln2"], t))
    y, aux = spans.wrap("ffn", h, lambda t: _ffn(kind, p, t, cfg, cfg.moe_capacity_factor))
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


def _positions(b: int, s: int, device) -> Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def forward_logits(params: Params, batch: dict, cfg: ModelConfig,
                   caches: Optional[list] = None) -> tuple[Tensor, Tensor]:
    """Full-sequence forward → (logits [B,S,V], aux_loss).

    ``batch``: {"tokens": [B,S]}, plus "image_embeds" [B, T_img, D] for vlm
    (in front of the tokens: logits [B, T_img + S, V]) and "frames"
    [B, S_enc, D] for encdec. Positions are 0..S−1 (from the first image
    token for vlm). The aux loss is the MoE balance term summed over layers,
    0 without MoE blocks. ``caches`` (``init_caches``' list, of a model whose
    blocks are all MLA): each layer writes its latent pair into its cache at
    slots 0..S−1, so that ``decode_step`` goes on from position S.
    """
    _check_supported(cfg)
    cdt = cfg.cdtype
    tokens = batch["tokens"]
    b, s = tokens.shape
    # the first kernel, so that a traced train step's own range on the device opens with
    # it (repro_torch.spans)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    x = spans.wrap("embed", params["embed"], lambda t: _embed(t, tokens, cfg))
    mask_kind, prefix_len = "causal", 0
    if cfg.kind == "vlm":  # the image embeds are not scaled
        x = torch.cat([batch["image_embeds"].to(cdt), x], dim=1)
        mask_kind, prefix_len = "prefix", cfg.num_image_tokens
        s = x.shape[1]
    positions = _positions(b, s, tokens.device)
    if cfg.kind == "encdec":
        enc_out = encoder_forward(params["encoder"], batch["frames"], cfg)
        x = x + sinusoidal_positions(s, cfg.d_model, device=x.device).to(cdt)[None]
        return _decoder_cross_forward(params, x, enc_out, positions, cfg), aux
    remat = _remat(cfg)
    if caches is not None and any(k not in ("mla_dense", "mla_moe") for k in cache_layout(cfg)):
        raise ValueError("a prefill fills the decode caches of MLA blocks only")
    x0, layer_idx = x, 0
    for seg_params, (kind, count) in zip(params["segments"], segments_of(cfg)):
        if _shared_site(cfg, layer_idx):  # segments split at every site
            x = _shared_block_forward(params, x, x0, positions, cfg)
        for layer in _layers(seg_params, count):
            cache = None if caches is None else caches[layer_idx]
            layer_idx += 1
            args = (kind, layer, x, positions, cfg, mask_kind, prefix_len, cache)
            x, a = (checkpoint(_block_forward, *args, use_reentrant=False,
                               context_fn=spans.checkpoint_contexts) if remat
                    else _block_forward(*args))
            aux = aux + a
    x = spans.wrap("norm", x, lambda t: apply_norm(cfg.norm, params["final_norm"], t))
    return spans.wrap("unembed", x, lambda t: _unembed(params, t, cfg)), aux


def _embed(table: Tensor, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    """The embedding rows of ``tokens`` in the compute dtype, scaled where the
    model scales them."""
    x = _lookup(table, tokens).to(cfg.cdtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype)
    return x


def _lookup(table: Tensor, tokens: Tensor) -> Tensor:
    """The embedding rows of ``tokens``. A vocab-sharded table (a DTensor)
    takes DTensor's embedding rule, each rank reading its own rows with the
    rest masked to zero, and the partial rows are then added up: the same
    values as indexing the full table."""
    if isinstance(table, DTensor):
        return reduced(torch.nn.functional.embedding(tokens, table))
    return table[tokens]


def _unembed(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    x = whole_grad(x)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
    return x @ params["lm_head"].to(x.dtype)


def encoder_forward(enc: Params, frames: Tensor, cfg: ModelConfig) -> Tensor:
    """Whisper's encoder over precomputed frame embeddings [B, S, D] (the conv
    stem is a stub): sinusoidal positions, then ``enc_layers`` bidirectional
    dense blocks (through the flash kernel with ``cfg.use_pallas``), then
    the final norm."""
    cdt = cfg.cdtype
    b, s, _ = frames.shape
    x = frames.to(cdt) + sinusoidal_positions(s, cfg.d_model, device=frames.device).to(cdt)[None]
    positions = _positions(b, s, frames.device)
    remat = _remat(cfg)
    for layer in _layers(enc["layers"], cfg.enc_layers):
        args = ("dense", layer, x, positions, cfg, "bidirectional", 0)
        x = (checkpoint(_block_forward, *args, use_reentrant=False,
                        context_fn=spans.checkpoint_contexts) if remat
             else _block_forward(*args))[0]
    return apply_norm(cfg.norm, enc["final_norm"], x)


def _cross_block(p: dict, x: Tensor, enc_out: Tensor, positions: Tensor,
                 enc_pos: Tensor, cfg: ModelConfig) -> Tensor:
    """One whisper decoder block. Both attentions stay dense whatever
    ``cfg.use_pallas`` says: JAX calls the self-attention without the kernel,
    and the cross-attention's ``kv_positions`` rule it out."""
    h = apply_norm(cfg.norm, p["ln1"], x)
    x = x + attn.attention_forward(p["attn"], h, positions, cfg, "causal")
    h = apply_norm(cfg.norm, p["ln_x"], x)
    x = x + attn.attention_forward(p["xattn"], h, positions, cfg, "bidirectional", 0,
                                   xkv=enc_out, kv_positions=enc_pos)
    h = apply_norm(cfg.norm, p["ln2"], x)
    return x + apply_mlp(p["mlp"], h, cfg.mlp_style)


def _decoder_cross_forward(params: Params, x: Tensor, enc_out: Tensor, positions: Tensor,
                           cfg: ModelConfig) -> Tensor:
    enc_pos = _positions(x.shape[0], enc_out.shape[1], x.device)
    remat = _remat(cfg)
    for layer in _layers(params["segments"][0], cfg.n_layers):
        args = (layer, x, enc_out, positions, enc_pos, cfg)
        x = (checkpoint(_cross_block, *args, use_reentrant=False) if remat
             else _cross_block(*args))
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(params, x, cfg)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def loss_fn(params: Params, batch: dict, cfg: ModelConfig) -> Tensor:
    """Next-token cross-entropy plus the weighted MoE balance loss. The image
    positions of a vlm carry no loss."""
    logits, aux = forward_logits(params, batch, cfg)
    if cfg.kind == "vlm":
        logits = logits[:, cfg.num_image_tokens:]
    return spans.wrap("loss", logits, lambda t: cross_entropy(t[:, :-1], batch["tokens"][:, 1:])
                      + cfg.aux_loss_weight * aux)


# ---------------------------------------------------------------------------
# decode (serve step)
# ---------------------------------------------------------------------------

def cache_layout(cfg: ModelConfig) -> list[str]:
    """Static tag sequence for the decode cache list: one entry per layer,
    plus one ``"shared"`` per zamba2 shared-block call site, just before the
    layer it precedes; ``"cross_dense"`` for each of whisper's decoder layers."""
    _check_supported(cfg)
    if cfg.kind == "encdec":
        return ["cross_dense"] * cfg.n_layers
    tags: list[str] = []
    for i, kind in enumerate(cfg.block_pattern):
        if _shared_site(cfg, i):
            tags.append("shared")
        tags.append(kind)
    return tags


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None) -> list:
    """One cache per ``cache_layout`` entry: a KV cache for standard attention
    (SWA archs keep ``window`` slots; a shared site keeps ``max_len``), in
    int8 with per-(token, head) scales when ``cfg.kv_cache_dtype`` is
    ``"int8"`` (KIVI) and in the compute dtype otherwise; a
    latent cache of ``max_len`` slots in the compute dtype for MLA (whatever
    ``kv_cache_dtype`` says, as in JAX), and a recurrent state for an SSM
    block (fp32, the conv history in the compute dtype). A whisper decoder
    layer keeps a self-attention KV cache of ``max_len`` and the encoder's
    keys and values, ``cross_k``/``cross_v`` [B, enc_seq_len, H, D], both in
    the compute dtype (zeros until the caller fills the cross pair)."""
    cdt = cfg.cdtype
    kv_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv_dt = "int8" if cfg.kv_cache_dtype == "int8" else cdt
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
        elif tag == "cross_dense":
            cross = (batch, cfg.enc_seq_len, cfg.n_heads, cfg.head_dim)
            caches.append({
                "self": attn.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim, cdt,
                                           device),
                "cross_k": torch.zeros(cross, dtype=cdt, device=device),
                "cross_v": torch.zeros(cross, dtype=cdt, device=device)})
        else:
            caches.append(ssm.init_slstm_state(batch, cfg.d_model, cfg.n_heads, device))
    return caches


@torch.no_grad()
def fill_cross_caches(params: Params, enc_out: Tensor, caches: list, cfg: ModelConfig) -> None:
    """Each whisper decoder layer's cross-attention K/V of the encoder output,
    written into its ``cross_k``/``cross_v`` (once per request), by the two
    einsums of ``examples/whisper_serve.py``.

    On caches placed by the policy's cache specs (DTensors), ``params`` are
    placed by its param specs and ``enc_out`` holds the rows of this rank's
    cache shard (a DTensor of a placed encoder, or its local tensor): each
    rank writes its own heads from its own heads of ``wk``/``wv`` (the policy
    splits both where the heads divide), and no rank makes the whole pair
    where the spec splits its heads."""
    xattn = params["segments"][0]["xattn"]  # stacked over the decoder layers
    if isinstance(caches[0]["cross_k"], DTensor):
        xattn = {k: gather_data(xattn[k]).to_local() for k in ("wk", "wv")}  # ZeRO-3's
        enc_out = enc_out.to_local() if isinstance(enc_out, DTensor) else enc_out
    for i in range(cfg.n_layers):
        for name, w in (("cross_k", xattn["wk"][i]), ("cross_v", xattn["wv"][i])):
            leaf = caches[i][name]
            local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            kv = torch.einsum("bsd,dhk->bshk", enc_out, w.to(enc_out.dtype))
            local.copy_(kv.to(local.dtype))


def _flatten_layer_params(params: Params, cfg: ModelConfig) -> list[tuple[str, dict]]:
    if cfg.kind == "encdec":
        return [("cross_dense", layer) for layer in _layers(params["segments"][0], cfg.n_layers)]
    return [(kind, layer)
            for seg_params, (kind, count) in zip(params["segments"], segments_of(cfg))
            for layer in _layers(seg_params, count)]


def _mix_step(kind: str, cfg: ModelConfig) -> tuple[Any, tuple]:
    """An SSM block's decode step and its arguments after (p, x, state)."""
    if kind == "mamba2":
        return ssm.mamba2_step, (cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_expand)
    if kind == "mlstm":
        return ssm.mlstm_step, (cfg.n_heads, cfg.xlstm_expand)
    return ssm.slstm_step, (cfg.n_heads,)


def _decode_block(kind: str, p: dict, x: Tensor, cache: dict, position: int,
                  cfg: ModelConfig) -> tuple[Tensor, dict]:
    h = apply_norm(cfg.norm, p["ln1"], x)
    if kind in _SSM_KINDS:
        step, args = _mix_step(kind, cfg)
        if isinstance(next(iter(cache.values())), DTensor):  # placed by the cache specs
            y, cache = ssm.placed_step(step, p["mix"], h, cache, *args)
        else:
            y, cache = step(p["mix"], h, cache, *args)
        return x + y, cache
    if kind == "cross_dense":
        return _decode_cross(p, x, h, cache, position, cfg), cache
    if kind in ("dense", "moe"):
        a, cache = attn.decode_attention(p["attn"], h, cache, position, cfg)
    else:
        a, cache = attn.mla_decode(p["attn"], h, cache, position, cfg)
    x = x + a
    h = apply_norm(cfg.norm, p["ln2"], x)
    # the JAX package decodes MoE at a literal capacity factor of 2.0 (cap = 1 at S = 1);
    # a dropless configuration decodes dropless
    cap = None if cfg.moe_capacity_factor is None else 2.0
    return x + _ffn(kind, p, h, cfg, cap)[0], cache


def _decode_cross(p: dict, x: Tensor, h: Tensor, cache: dict, position: int,
                  cfg: ModelConfig) -> Tensor:
    """A whisper decoder layer at one position: self-attention over its KV
    cache (written in place), then cross-attention of q (``wq``, no bias, no
    RoPE) over the fixed ``cross_k``/``cross_v``, then the MLP."""
    a, _ = attn.decode_attention(p["attn"], h, cache["self"], position, cfg)
    x = x + a
    h = apply_norm(cfg.norm, p["ln_x"], x)
    x = x + attn.cross_decode_attention(p["xattn"], h, cache["cross_k"], cache["cross_v"],
                                        position)
    return x + apply_mlp(p["mlp"], apply_norm(cfg.norm, p["ln2"], x), cfg.mlp_style)


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
    returned list holds every layer's cache as it now stands. Whisper adds
    the sinusoidal position ``position`` to the embedding; a vlm decodes text
    only (no image prefix), as the JAX serving launcher does."""
    cdt = cfg.cdtype
    x = _embed(params["embed"], tokens, cfg)
    if cfg.kind == "encdec":
        x = x + sinusoidal_positions(1, cfg.d_model, position, device=x.device).to(cdt)[None]
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
