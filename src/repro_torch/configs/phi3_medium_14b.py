"""phi3-medium-14b [dense] — RoPE SwiGLU GQA.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352  [arXiv:2404.14219]
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "phi3-medium-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
        d_ff=17920, vocab_size=100352,
        rope_theta=10000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=80, n_heads=5, n_kv_heads=5,  # odd head count kept
        d_ff=160, vocab_size=256,
        rope_theta=10000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=False,
    )
