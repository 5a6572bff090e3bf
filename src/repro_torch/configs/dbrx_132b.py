"""dbrx-132b [moe] — 16 experts, top-4, fine-grained MoE.

40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert vocab=100352
[hf:databricks/dbrx-base]

Largest assigned arch (132B total / ~36B active).  Params are kept in
bf16: 263 GB, more than one H100 holds, so the port runs it whole only
once sharding is ported, and at full width with fewer layers before that.
Its "moe" blocks run standard attention (head dim 128, 48 query / 8 KV
heads, no window) through the flash-attention kernel under ``use_pallas``.
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "dbrx-132b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=0, vocab_size=100352,
        block_pattern=("moe",) * 40,
        moe_experts=16, moe_top_k=4, moe_d_ff=10752,
        rope_theta=500_000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=False,
        param_dtype="bfloat16",  # 132B fp32 master copies live in the optimizer
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=0, vocab_size=256,
        block_pattern=("moe",) * 2,
        moe_experts=4, moe_top_k=2, moe_d_ff=96,
        rope_theta=500_000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=False,
    )
