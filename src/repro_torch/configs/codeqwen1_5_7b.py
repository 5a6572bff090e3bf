"""codeqwen1.5-7b [dense] — qwen1.5 architecture (QKV bias, high rope theta).

32L d_model=4096 32H (kv=32, full MHA) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B]
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "codeqwen1.5-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=13440, vocab_size=92416,
        qkv_bias=True,  # qwen1.5 signature
        rope_theta=1_000_000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        qkv_bias=True,
        rope_theta=1_000_000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=False,
    )
