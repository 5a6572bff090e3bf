"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000  [arXiv:2401.16818; hf]
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "h2o-danube-1.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=6912, vocab_size=32000,
        sliding_window=4096,  # mistral-style SWA
        rope_theta=10000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
        sliding_window=16,
        rope_theta=10000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=False,
    )
