"""ModelConfig: a single dataclass describing every supported architecture.

The port's own copy of ``repro.configs.base`` (which imports ``jax.numpy``):
the same fields and defaults, so configs convert field for field, with
``pdtype``/``cdtype`` returning torch dtypes. ``use_pallas`` keeps its
name; in the port it selects the hand-written CUDA kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert FFN width
    moe_capacity_factor: float = 1.25
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

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.block_pattern and self.n_layers:
            object.__setattr__(self, "block_pattern", ("dense",) * self.n_layers)
        if self.n_layers and len(self.block_pattern) != self.n_layers:
            raise ValueError(
                f"{self.name}: block_pattern has {len(self.block_pattern)} entries "
                f"for n_layers={self.n_layers}")

    # -- dtype helpers --------------------------------------------------------
    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

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
