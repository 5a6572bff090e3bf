"""ModelConfig: a single dataclass describing every supported architecture.

The port's own copy of ``repro.configs.base`` (which imports ``jax.numpy``):
the same fields and defaults, so configs convert field for field, with
``pdtype``/``cdtype`` returning torch dtypes. ``use_pallas`` keeps its
name; in the port it selects the hand-written CUDA kernels.

The port adds fields of its own for mechanisms of published models that the
JAX package leaves out (DeepSeek-V2's latent RMSNorm, YaRN's rope scaling,
top-k gates left as the softmax gives them, dropless routing); each default
keeps the JAX package's behaviour. A configuration may also carry the keys of
the model's published ``config.json`` (Hugging Face's names, ``PUBLISHED``):
they are read at construction and held to the fields and mechanisms they name,
and are no fields themselves.
"""

from __future__ import annotations

import dataclasses
from dataclasses import InitVar
from typing import Any, Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; available: {sorted(_DTYPES)}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str = "decoder"  # decoder | encdec | vlm
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 → d_model // n_heads
    #: per-layer block kinds, len == n_layers.  entries:
    #: "dense" | "moe" | "mla_dense" | "mla_moe" | "mamba2" | "mlstm" | "slstm"
    block_pattern: tuple[str, ...] = ()

    # attention
    use_rope: bool = True
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0  # GLM: 0.5
    sliding_window: Optional[int] = None  # danube SWA
    qkv_bias: bool = False  # codeqwen/qwen1.5
    # MLA (deepseek)
    mla_kv_lora_rank: int = 0
    mla_qk_nope_dim: int = 128
    mla_qk_rope_dim: int = 64
    mla_v_dim: int = 128
    mla_kv_norm: bool = False  # RMSNorm of the latent c_kv (HF kv_a_layernorm)
    # YaRN rope scaling of MLA's rope lanes (HF rope_scaling, type "yarn"); None: off
    yarn_factor: Optional[float] = None
    yarn_original_max_position_embeddings: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert FFN width
    moe_capacity_factor: Optional[float] = 1.25  # None: dropless (no pair is dropped)
    moe_norm_topk_prob: bool = True  # renormalise the top-k gates to sum to 1
    aux_loss_weight: float = 0.01

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # xLSTM
    xlstm_expand: int = 2
    # zamba2: apply the weight-shared attention block after every k-th layer
    shared_attn_every: int = 0

    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq_len: int = 1500  # whisper: 30 s of audio → 1500 frames
    # vlm (paligemma)
    num_image_tokens: int = 0

    # norms / mlp / embeddings
    norm: str = "rmsnorm"
    mlp_style: str = "swiglu"  # swiglu | geglu | gelu
    tie_embeddings: bool = True
    scale_embeddings: bool = False  # gemma multiplies embeddings by sqrt(d)

    # runtime knobs
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"  # "int8" → KIVI-style quantized cache
    dense_attn_limit: int = 8192 * 8192  # Sq·Skv above which attention chunks
    attn_chunk: int = 1024
    use_pallas: bool = False  # port: route attention through the CUDA kernel
    unroll_layers: bool = False
    remat: bool = True
    remat_policy: str = "full"

    # A published config.json's keys (``PUBLISHED``), init only: read and checked
    hidden_size: InitVar[Optional[int]] = None
    num_hidden_layers: InitVar[Optional[int]] = None
    num_attention_heads: InitVar[Optional[int]] = None
    num_key_value_heads: InitVar[Optional[int]] = None
    intermediate_size: InitVar[Optional[int]] = None
    kv_lora_rank: InitVar[Optional[int]] = None
    qk_nope_head_dim: InitVar[Optional[int]] = None
    qk_rope_head_dim: InitVar[Optional[int]] = None
    v_head_dim: InitVar[Optional[int]] = None
    n_routed_experts: InitVar[Optional[int]] = None
    num_experts_per_tok: InitVar[Optional[int]] = None
    n_shared_experts: InitVar[Optional[int]] = None
    moe_intermediate_size: InitVar[Optional[int]] = None
    first_k_dense_replace: InitVar[Optional[int]] = None
    moe_layer_freq: InitVar[Optional[int]] = None
    tie_word_embeddings: InitVar[Optional[bool]] = None
    attention_bias: InitVar[Optional[bool]] = None
    norm_topk_prob: InitVar[Optional[bool]] = None
    rope_scaling: InitVar[Optional[dict]] = None
    hidden_act: InitVar[Optional[str]] = None
    rms_norm_eps: InitVar[Optional[float]] = None
    q_lora_rank: InitVar[Optional[int]] = None
    n_group: InitVar[Optional[int]] = None
    topk_group: InitVar[Optional[int]] = None
    topk_method: InitVar[Optional[str]] = None
    scoring_func: InitVar[Optional[str]] = None
    routed_scaling_factor: InitVar[Optional[float]] = None
    max_position_embeddings: InitVar[Optional[int]] = None
    model_type: InitVar[Optional[str]] = None
    seq_aux: InitVar[Optional[bool]] = None

    def __post_init__(self, *published):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.block_pattern and self.n_layers:
            object.__setattr__(self, "block_pattern", ("dense",) * self.n_layers)
        if self.n_layers and len(self.block_pattern) != self.n_layers:
            raise ValueError(
                f"{self.name}: block_pattern has {len(self.block_pattern)} entries "
                f"for n_layers={self.n_layers}")
        for key, value in zip(PUBLISHED, published):
            if value is not None and key in _READ:
                want = _READ[key](self)
                if value != want:
                    raise ValueError(f"{self.name}: the published {key}={value!r}, but the "
                                     f"port's configuration gives {want!r}")

    # -- dtype helpers --------------------------------------------------------
    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def rope_scaling_dict(self) -> Optional[dict]:
        """YaRN's settings under HF's ``rope_scaling`` keys, or None when off."""
        if self.yarn_factor is None:
            return None
        return {"type": "yarn", "factor": self.yarn_factor,
                "original_max_position_embeddings": self.yarn_original_max_position_embeddings,
                "beta_fast": self.yarn_beta_fast, "beta_slow": self.yarn_beta_slow,
                "mscale": self.yarn_mscale, "mscale_all_dim": self.yarn_mscale_all_dim}

    # -- analytics ------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline sanity)."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d  # embeddings
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for kind in self.block_pattern:
            n += self._block_params(kind)
        if self.shared_attn_every:
            n += 2 * d * d  # concat-projection
            n += self._block_params("dense")  # the shared attention block
        if self.kind == "encdec":
            enc_block = (2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                         + self._mlp_params())
            n += self.enc_layers * enc_block
            # decoder cross-attention
            n += self.n_layers * (2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if self.moe_experts == 0:
            return self.param_count()
        d = self.d_model
        full_expert = 3 * d * self.moe_d_ff
        inactive = (self.moe_experts - self.moe_top_k) * full_expert
        n_moe_layers = sum(1 for k in self.block_pattern if k in ("moe", "mla_moe"))
        return self.param_count() - n_moe_layers * inactive

    def _mlp_params(self, d_ff: int | None = None) -> int:
        f = d_ff or self.d_ff
        mats = 3 if self.mlp_style in ("swiglu", "geglu") else 2
        return mats * self.d_model * f

    def _block_params(self, kind: str) -> int:
        d, hd = self.d_model, self.head_dim
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        mla = (d * self.n_heads * (self.mla_qk_nope_dim + self.mla_qk_rope_dim)
               + d * self.mla_kv_lora_rank + d * self.mla_qk_rope_dim
               + self.mla_kv_lora_rank * self.n_heads * (self.mla_qk_nope_dim + self.mla_v_dim)
               + self.n_heads * self.mla_v_dim * d)
        moe = self.moe_experts * 3 * d * self.moe_d_ff + d * self.moe_experts
        if self.moe_shared_experts:
            moe += 3 * d * (self.moe_shared_experts * self.moe_d_ff)
        if kind == "dense":
            return attn + self._mlp_params()
        if kind == "moe":
            return attn + moe
        if kind == "mla_dense":
            return mla + self._mlp_params()
        if kind == "mla_moe":
            return mla + moe
        if kind == "mamba2":
            d_inner = self.ssm_expand * d
            nheads = d_inner // self.ssm_headdim
            return (d * (2 * d_inner + 2 * self.ssm_state + nheads)
                    + 4 * (d_inner + 2 * self.ssm_state) + d_inner * d)
        if kind == "mlstm":
            d_inner = self.xlstm_expand * d
            return (d * 2 * d_inner + 3 * d_inner * d_inner
                    + d_inner * 2 * self.n_heads + d_inner * d + 4 * d_inner)
        if kind == "slstm":
            return d * 4 * d + d * 4 * d // self.n_heads + d * 2 * d + d * d
        raise ValueError(f"unknown block kind {kind!r}")


def _first_moe(cfg: ModelConfig) -> int:
    """Leading blocks before the first MoE block (HF ``first_k_dense_replace``)."""
    return next((i for i, k in enumerate(cfg.block_pattern) if k in ("moe", "mla_moe")),
                cfg.n_layers)


#: a published config.json's keys that a ``ModelConfig`` takes (init only), in the
#: order of their ``InitVar`` declarations
PUBLISHED = tuple(f.name for f in ModelConfig.__dataclass_fields__.values()
                  if f._field_type is dataclasses._FIELD_INITVAR)

#: each published key → the value the port's fields give it. Keys that name a
#: mechanism the port has in one form only give that form (no q-LoRA, greedy top-k
#: over one group of a softmax, unscaled gates, every layer past the first k an MoE);
#: the declared context, the model's family and training's per-sequence balance term
#: are read and not held to anything (``_READ`` lacks them).
_READ: dict[str, Any] = {
    "hidden_size": lambda c: c.d_model,
    "num_hidden_layers": lambda c: c.n_layers,
    "num_attention_heads": lambda c: c.n_heads,
    "num_key_value_heads": lambda c: c.n_kv_heads,
    "intermediate_size": lambda c: c.d_ff,
    "kv_lora_rank": lambda c: c.mla_kv_lora_rank,
    "qk_nope_head_dim": lambda c: c.mla_qk_nope_dim,
    "qk_rope_head_dim": lambda c: c.mla_qk_rope_dim,
    "v_head_dim": lambda c: c.mla_v_dim,
    "n_routed_experts": lambda c: c.moe_experts,
    "num_experts_per_tok": lambda c: c.moe_top_k,
    "n_shared_experts": lambda c: c.moe_shared_experts,
    "moe_intermediate_size": lambda c: c.moe_d_ff,
    "first_k_dense_replace": _first_moe,
    "moe_layer_freq": lambda c: 1 if all(k in ("moe", "mla_moe")
                                         for k in c.block_pattern[_first_moe(c):]) else None,
    "tie_word_embeddings": lambda c: c.tie_embeddings,
    "attention_bias": lambda c: c.qkv_bias,
    "norm_topk_prob": lambda c: c.moe_norm_topk_prob,
    "rope_scaling": lambda c: c.rope_scaling_dict(),
    "hidden_act": lambda c: "silu" if c.mlp_style == "swiglu" else None,
    "rms_norm_eps": lambda c: 1e-6 if c.norm == "rmsnorm" else None,
    "q_lora_rank": lambda c: None,
    "n_group": lambda c: 1,
    "topk_group": lambda c: 1,
    "topk_method": lambda c: "greedy",
    "scoring_func": lambda c: "softmax",
    "routed_scaling_factor": lambda c: 1,
}
