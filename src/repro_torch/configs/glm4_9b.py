"""glm4-9b [dense] — extreme GQA (kv=2) + partial rotary.

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552  [hf:THUDM/glm-4-9b]
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "glm4-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab_size=151552,
        partial_rotary_factor=0.5,  # GLM rotates half the head dims
        rope_theta=10000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
        partial_rotary_factor=0.5,
        rope_theta=10000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=False,
    )
