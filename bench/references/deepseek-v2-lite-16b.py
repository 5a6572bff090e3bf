"""DeepSeek-V2-Lite's plain reference, written from its published config.json
(huggingface.co/deepseek-ai/DeepSeek-V2-Lite) and the layer equations of HF's
``modeling_deepseek.py``, in fp32 (TF32 off where it runs under
``reference.exact_fp32``), with no kernel, cache or batching of the program's.

It reads the published keys of the configuration file (``hidden_size``,
``kv_lora_rank``, ``rope_scaling``, ``num_experts_per_tok`` ...), and the
port's ``param_dtype`` for the stored dtype. Per layer ``x + attn(norm1(x))``
then ``x + ffn(norm2(x))``:

* MLA: ``q = x wq`` (no q-LoRA) split into 128 nope and 64 rope lanes; the
  latent ``c = rmsnorm(x w_dkv)`` (HF's ``kv_a_layernorm``) decompressed to
  ``k_nope = c w_uk`` and ``v = c w_uv``; one rope key ``x w_kpe`` shared by
  the heads. The rope lanes turn as HF turns them: pairs ``(2i, 2i + 1)``
  de-interleaved, then ``rotate_half`` at YaRN's frequency ``i`` (the ramp
  between the correction dims of ``beta_fast`` and ``beta_slow`` over the
  original positions, blending ``theta^(-2i/64)`` into it divided by the
  factor), cos and sin times ``mscale(f, mscale) / mscale(f, mscale_all_dim)``;
  causal softmax at ``(qk dim)^-1/2 · mscale(f, mscale_all_dim)²``, in blocks of
  ``q_rows`` queries.
* The FFN: layer 0 (``first_k_dense_replace``) a SwiGLU MLP; every later layer
  a softmax router in fp32, the top ``num_experts_per_tok`` taken greedily,
  their gates renormalised only where ``norm_topk_prob`` says so, each expert
  run on exactly the tokens that chose it (a loop over the experts: dropless),
  weighed by its gate, plus the shared experts (one SwiGLU of
  ``n_shared_experts`` widths).
* RMSNorm at ``rms_norm_eps`` with the scale stored as ``1 + w``; the head
  untied.

Every product goes through ``prec.mm`` (the control rounds its operands to
float8). Imports nothing of JAX, ``repro`` or ``repro_torch``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench import flops
from bench.reference import FP32, Precision

Tensor = torch.Tensor

#: the sizes of the CPU tests: every width cut, the mechanisms as published (the
#: port's fields and the published keys alike, which the port holds equal)
SMALL = dict(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    block_pattern=["mla_dense", "mla_moe", "mla_moe"], mla_kv_lora_rank=32,
    mla_qk_nope_dim=16, mla_qk_rope_dim=8, mla_v_dim=16, moe_experts=16, moe_top_k=4,
    moe_shared_experts=2, moe_d_ff=32,
    hidden_size=64, num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
    intermediate_size=128, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, n_routed_experts=16, num_experts_per_tok=4, n_shared_experts=2,
    moe_intermediate_size=32)


# ---------------------------------------------------------------------------
# the layout and the yardstick
# ---------------------------------------------------------------------------

def weight_shapes(cfg: dict) -> dict:
    """The port's ``init_params`` tree for this model, leaf → (shape, init,
    stored dtype): matrices and the router ``fan_in`` over their contracted
    width, norms (the latent's too) in fp32 as ``rms_w``, the rest in
    ``param_dtype``."""
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    e, fe, dense = cfg["n_routed_experts"], cfg["moe_intermediate_size"], cfg["intermediate_size"]
    fs = cfg["n_shared_experts"] * fe
    first, n = cfg["first_k_dense_replace"], cfg["num_hidden_layers"]
    pd = cfg["param_dtype"]

    def norm(lead, width=d):
        return {"w": (lead + (width,), "rms_w", "float32")}

    def mat(lead, *shape, fan):
        return (lead + shape, f"fan_in:{fan}", pd)

    def block(lead):
        return {"ln1": norm(lead), "ln2": norm(lead),
                "attn": {"wq": mat(lead, d, h, nope + rope, fan=d),
                         "w_dkv": mat(lead, d, r, fan=d), "w_kpe": mat(lead, d, rope, fan=d),
                         "kv_norm": norm(lead, r),
                         "w_uk": mat(lead, r, h, nope, fan=r), "w_uv": mat(lead, r, h, v, fan=r),
                         "wo": mat(lead, h, v, d, fan=h * v)}}

    def swiglu(lead, width):
        return {"wi": mat(lead, d, width, fan=d), "wg": mat(lead, d, width, fan=d),
                "wo": mat(lead, width, d, fan=width)}
    dense_seg = dict(block((first,)), mlp=swiglu((first,), dense))
    lead = (n - first,)
    moe_seg = dict(block(lead), moe={
        "router": (lead + (d, e), f"fan_in:{d}", "float32"),
        "wi": mat(lead, e, d, fe, fan=d), "wg": mat(lead, e, d, fe, fan=d),
        "wo": mat(lead, e, fe, d, fan=fe), "shared": swiglu(lead, fs)})
    return {"embed": ((cfg["vocab_size"], d), "embed", pd), "segments": [dense_seg, moe_seg],
            "final_norm": norm(()), "lm_head": mat((), d, cfg["vocab_size"], fan=d)}


def _matmul_params(cfg: dict) -> int:
    """Matmul parameters a token passes through: MLA's six projections a layer,
    layer 0's MLP, each MoE layer's router, its top-k routed experts and its
    shared experts, and the head."""
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    fe, n, first = cfg["moe_intermediate_size"], cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    mla = d * h * (nope + rope) + d * r + d * rope + r * h * (nope + v) + h * v * d
    moe = (d * cfg["n_routed_experts"] + 3 * d * fe * cfg["num_experts_per_tok"]
           + 3 * d * fe * cfg["n_shared_experts"])
    return n * mla + first * 3 * d * cfg["intermediate_size"] + (n - first) * moe \
        + d * cfg["vocab_size"]


def routed_expert_flops(cfg: dict, batch: int, seq: int) -> int:
    """FLOPs of the routed experts' three products over one forward."""
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    return (2 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]
            * cfg["num_experts_per_tok"] * batch * seq * layers)


def forward_flops(cfg: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one forward: 2 per matmul parameter a token passes
    through, and per live causal (query, key) pair and head 2·(qk dim) for the
    score and 2·(v dim) for the weighted sum."""
    pair = 2 * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) + 2 * cfg["v_head_dim"]
    pairs = flops.live_pairs(seq, seq, True)
    attn = pair * cfg["num_attention_heads"] * pairs * batch * cfg["num_hidden_layers"]
    return 2 * _matmul_params(cfg) * batch * seq + attn


def expert_bytes(cfg: dict, batch: int, seq: int, dtype_bytes: int = 2) -> int:
    """The least bytes the routed experts' products move in one forward: each
    MoE layer's experts' weights read once, the gathered rows read once and the
    experts' outputs written once."""
    d, fe, e = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    rows = batch * seq * cfg["num_experts_per_tok"]
    return layers * (3 * e * d * fe + 2 * rows * d) * dtype_bytes


def kernel_bounds(cfg: dict, batch: int, seq: int, peaks: dict | None) -> dict:
    """``expert_bound_s``: the least time of one call's grouped expert products,
    the larger of their FLOPs at the bf16 peak and their bytes at HBM's
    bandwidth (None where the card's peaks are unknown)."""
    if not peaks:
        return {"expert_bound_s": None}
    return {"expert_bound_s": max(routed_expert_flops(cfg, batch, seq) / peaks["bf16_flops"],
                                  expert_bytes(cfg, batch, seq) / peaks["hbm_bytes_s"])}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _rms(cfg: dict, w: Tensor, x: Tensor) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + cfg["rms_norm_eps"]) * (1.0 + w)


def _yarn_mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope_table(cfg: dict, seq: int, device) -> tuple[Tensor, Tensor]:
    """HF's cos and sin tables [S, rope]: YaRN's inverse frequencies, doubled
    (``cat(freqs, freqs)``), times the mscale ratio."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg["rope_scaling"]
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]
    pos = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** pos)
    inter = 1.0 / (factor * base ** pos)

    def correction(turns):
        return dim * math.log(orig / (turns * 2 * math.pi)) / (2 * math.log(base))
    low = max(math.floor(correction(rs["beta_fast"])), 0)
    high = min(math.ceil(correction(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv = inter * (1 - mask) + extra * mask
    freqs = torch.outer(torch.arange(seq, dtype=torch.float32, device=device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    m = _yarn_mscale(factor, rs["mscale"]) / _yarn_mscale(factor, rs["mscale_all_dim"])
    return emb.cos() * m, emb.sin() * m


def _rotate(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x [B, S, H, D]: HF's de-interleave, then ``x cos + rotate_half(x) sin``."""
    b, s, h, d = x.shape
    x = x.view(b, s, h, d // 2, 2).transpose(-1, -2).reshape(b, s, h, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos[None, :, None] + half * sin[None, :, None]


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg["rope_scaling"]
    if rs.get("mscale_all_dim"):
        m = _yarn_mscale(float(rs["factor"]), rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def _layer(p: dict, i: int) -> dict:
    """Layer ``i`` of a stacked segment, each leaf upcast to fp32."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i].float() for k, v in p.items()}


def _mla(cfg: dict, p: dict, x: Tensor, rope: tuple[Tensor, Tensor], prec: Precision,
         q_rows: int) -> Tensor:
    b, s, d = x.shape
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rd, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = prec.mm(x, p["wq"].reshape(d, h * (nope + rd))).view(b, s, h, nope + rd)
    c = _rms(cfg, p["kv_norm"]["w"], prec.mm(x, p["w_dkv"]))
    k_pe = prec.mm(x, p["w_kpe"]).view(b, s, 1, rd)
    cos, sin = rope
    q = torch.cat([q[..., :nope], _rotate(q[..., nope:], cos, sin)], dim=-1)
    k_pe = _rotate(k_pe, cos, sin)
    k = torch.cat([prec.mm(c, p["w_uk"].reshape(r, h * nope)).view(b, s, h, nope),
                   k_pe.expand(b, s, h, rd)], dim=-1).transpose(1, 2)  # [B, H, S, 192]
    v = prec.mm(c, p["w_uv"].reshape(r, h * vd)).view(b, s, h, vd).transpose(1, 2)
    q = q.transpose(1, 2)
    scale = softmax_scale(cfg)
    pos = torch.arange(s, device=x.device)
    outs = []
    for q0 in range(0, s, q_rows):
        q1 = min(q0 + q_rows, s)
        keep = pos[None, :q1] <= pos[q0:q1, None]
        scores = prec.mm(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2)) * scale
        probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(prec.mm(probs, v[:, :, :q1]))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, h * vd)
    return prec.mm(o, p["wo"].reshape(h * vd, d))


def _swiglu(p: dict, x: Tensor, prec: Precision) -> Tensor:
    return prec.mm(F.silu(prec.mm(x, p["wg"])) * prec.mm(x, p["wi"]), p["wo"])


def _moe(cfg: dict, p: dict, x: Tensor, prec: Precision) -> Tensor:
    """Greedy top-k of the fp32 softmax router, each expert on the tokens that
    chose it, none dropped; plus the shared experts."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs = torch.softmax(prec.mm(xt, p["router"]), dim=-1)
    gate, pick = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(xt)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(pick == e, as_tuple=True)
        if tok.numel():
            xe = xt[tok]
            ye = prec.mm(F.silu(prec.mm(xe, p["wg"][e])) * prec.mm(xe, p["wi"][e]), p["wo"][e])
            out.index_add_(0, tok, ye * gate[tok, slot, None])
    return (out + _swiglu(p["shared"], xt, prec)).view(b, s, d)


def hidden(w: dict, tok: Tensor, cfg: dict, prec: Precision = FP32,
           q_rows: int = 1 << 30) -> Tensor:
    """The final normed hidden states [B, S, d] of ``tok`` [B, S]."""
    x = w["embed"][tok.long()].float()
    rope = rope_table(cfg, tok.shape[1], x.device)
    first = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        seg, j = (w["segments"][0], i) if i < first else (w["segments"][1], i - first)
        p = _layer(seg, j)
        x = x + _mla(cfg, p["attn"], _rms(cfg, p["ln1"]["w"], x), rope, prec, q_rows)
        hn = _rms(cfg, p["ln2"]["w"], x)
        x = x + (_swiglu(p["mlp"], hn, prec) if i < first else _moe(cfg, p["moe"], hn, prec))
        del p
    return _rms(cfg, w["final_norm"]["w"].float(), x)


def forward(w: dict, tok: Tensor, cfg: dict, prec: Precision = FP32,
            q_rows: int = 1 << 30) -> Tensor:
    """Logits [B, S, V] in fp32."""
    return prec.mm(hidden(w, tok, cfg, prec, q_rows), w["lm_head"].float())


@torch.no_grad()
def served_gaps(w: dict, prompts: Tensor, served: Tensor, cfg: dict, q_rows: int,
                prec: Precision = FP32) -> float:
    """The widest gap, over every position of every prompt, by which the
    served token's logit lies below the fp32 reference's best; with ``served``
    None the served tokens are ``prec``'s own first choices (the control)."""
    widest = 0.0
    for i in range(prompts.shape[0]):
        tok = prompts[i:i + 1]
        ref = forward(w, tok, cfg, FP32, q_rows)[0]
        pick = (forward(w, tok, cfg, prec, q_rows)[0].argmax(-1) if served is None
                else served[i].long())
        gap = ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]
        widest = max(widest, float(gap.max()))
        del ref
    return widest
