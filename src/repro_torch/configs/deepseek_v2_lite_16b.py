"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + fine-grained MoE.

27L d_model=2048 16H d_ff=1408/expert vocab=102400, 64 routed experts
top-6 + 2 shared, first layer dense (d_ff=10944)  [arXiv:2405.04434; hf]

The MLA latent cache (rank 512 + 64 rope dims = 576/token) is the arch's
serving-side contribution; ``decode_32k`` exercises it.
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "deepseek-v2-lite-16b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=10944,  # layer-0 dense MLP width
        vocab_size=102400,
        block_pattern=("mla_dense",) + ("mla_moe",) * 26,
        mla_kv_lora_rank=512, mla_qk_nope_dim=128, mla_qk_rope_dim=64,
        mla_v_dim=128,
        moe_experts=64, moe_top_k=6, moe_shared_experts=2, moe_d_ff=1408,
        rope_theta=10000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        block_pattern=("mla_dense",) + ("mla_moe",) * 2,
        mla_kv_lora_rank=32, mla_qk_nope_dim=16, mla_qk_rope_dim=8,
        mla_v_dim=16,
        moe_experts=8, moe_top_k=2, moe_shared_experts=2, moe_d_ff=32,
        rope_theta=10000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=False,
    )
