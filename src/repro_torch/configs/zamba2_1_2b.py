"""zamba2-1.2b [hybrid] — Mamba2 backbone + weight-shared attention block.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf]

The shared transformer block (one set of weights) is interposed before
every 6th mamba2 layer over concat(x, x_embed) — the zamba signature.
"""

from repro_torch.configs.base import ModelConfig

ARCH_ID = "zamba2-1.2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        block_pattern=("mamba2",) * 38,
        shared_attn_every=6,
        ssm_state=64, ssm_headdim=64, ssm_expand=2,
        rope_theta=10000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        block_pattern=("mamba2",) * 5,
        shared_attn_every=2,
        ssm_state=16, ssm_headdim=16, ssm_expand=2,
        ssm_chunk=8,
        rope_theta=10000.0, mlp_style="swiglu", norm="rmsnorm",
        tie_embeddings=True,
    )
